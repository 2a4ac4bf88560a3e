"""The CUDA route of the MLP probe forwards #13 (``mlp_tile``, and its
no-GELU and no-LN ablations) and #19a (``mlp_chain``, each stage set)
without a card.

With the library and the stream replaced by a recorder, each wrapper runs
the shipped ``ln_mlp``'s (#2) launch sequence through one call of
``vlp_mlp_tile``: it allocates ln [M, D] (only with a LayerNorm) and h
[M, F] as the scratch of the launches beside y, passes the operands'
pointers in the order of the C signature (``vlp_tpu_torch/ops/_build.py``'s
``_SIGNATURES``) and counts one launch. The chain has no bias and an
affine-free LayerNorm: it passes fp32 zeros as the biases and ones and
zeros as gamma and beta, vectors made once and kept (``_filled``), so no
call allocates them. What the CUDA sequence does not take raises before
any call: fp32 operands, x, w1 or w2 off 16-byte alignment (the products
read them by TMA), D not a multiple of 32 or above 1024 with a LayerNorm
(its row pass), D not a multiple of 8 without one, F not a multiple of 8,
and (tm, fs) outside ``TILES``. ``scripts/ab_probes.py`` calls the
one-launch tile engine that the parent checkout may still hold by that
engine's C signature, at the parent's ``TILES``.
"""
import contextlib
import importlib.util
from pathlib import Path

import pytest
import torch

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops import mlp_tile as MT


class _FakeLibrary:
    """Records ``vlp_mlp_tile`` in place of the card."""

    def __init__(self):
        self.calls = []

    def vlp_mlp_tile(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(MT, "_route", lambda name, x: True)
    monkeypatch.setattr(MT, "_stream", lambda: 7)
    monkeypatch.setattr(MT._build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return lib


@pytest.fixture
def allocations(monkeypatch):
    """{data_ptr: (shape, dtype)} of every tensor made by ``torch.empty``
    or ``torch.empty_like`` while the test runs."""
    made = {}
    empty, empty_like = torch.empty, torch.empty_like

    def record(fn):
        def make(*args, **kwargs):
            t = fn(*args, **kwargs)
            made[t.data_ptr()] = (tuple(t.shape), t.dtype)
            return t
        return make
    monkeypatch.setattr(torch, "empty", record(empty))
    monkeypatch.setattr(torch, "empty_like", record(empty_like))
    return made


def _ptrs(*tensors):
    return tuple(t.data_ptr() for t in tensors)


def _operands(m, d, f, dtype=torch.bfloat16):
    """x, gamma, beta, w1, b1, w2, b2: x and the matrices in ``dtype``, the
    vectors fp32."""
    return (torch.zeros(m, d, dtype=dtype), torch.ones(d), torch.zeros(d),
            torch.zeros(d, f, dtype=dtype), torch.zeros(f),
            torch.zeros(f, d, dtype=dtype), torch.zeros(d))


def test_signature_table_matches_the_wrappers_calls():
    """The C signature the wrappers below are held to: 20 arguments, 10
    pointers (seven operands, ln, h, y), then M, D, F, tm, fs, ln, gelu,
    residual, eps and the stream."""
    args, ret = _build._SIGNATURES["vlp_mlp_tile"]
    assert len(args) == 20 and ret is _build._I
    assert args[:10] == [_build._P] * 10
    assert args[10:18] == [_build._I] * 8
    assert args[18:] == [_build._F, _build._P]


# (M, D, F): the probe's batch 128, a ragged M, NesT's level 0 width
SHAPES = [(25088, 384, 1536), (1037, 384, 1536), (77, 96, 352)]
FLAGS = [(True, True), (True, False), (False, True)]


def _check_call(fake, allocations, x, w1, y, ln, gelu, residual, tm, fs):
    """The one call's scratch, sizes and flags; returns its pointers to
    the seven operands."""
    (m, d), f = x.shape, w1.shape[1]
    (args,) = fake.calls
    assert y.shape == (m, d) and y.dtype == torch.bfloat16
    assert args[9] == y.data_ptr() and args[0] == x.data_ptr()
    want = {args[8]: ((m, f), torch.bfloat16),
            args[9]: ((m, d), torch.bfloat16)}
    if ln:
        want[args[7]] = ((m, d), torch.bfloat16)
    else:
        assert args[7] == 0
    # ln (with a LayerNorm), h and y: nothing else allocated
    assert allocations == want and len(want) == 2 + ln
    assert args[10:18] == (m, d, f, tm, fs, int(ln), int(gelu), residual)
    assert args[18] == pytest.approx(1e-6)
    assert args[19] == 7
    return args[:7]


@pytest.mark.parametrize("tm,fs", MT.TILES)
@pytest.mark.parametrize("ln,gelu", FLAGS)
@pytest.mark.parametrize("m,d,f", SHAPES)
def test_mlp_tile_cuda_route_passes_its_operands(fake, allocations, tm, fs,
                                                 ln, gelu, m, d, f):
    ops = _operands(m, d, f)
    before = MT.mlp_tile.launches
    y = MT.mlp_tile(*ops, ln=ln, gelu=gelu, tm=tm, fs=fs)
    assert MT.mlp_tile.launches == before + 1
    # x, gamma, beta, w1, b1, w2, b2 as they are, the residual on
    assert _check_call(fake, allocations, ops[0], ops[3], y, ln, gelu, 1,
                       tm, fs) == _ptrs(*ops)


@pytest.mark.parametrize("tm,fs", MT.TILES)
@pytest.mark.parametrize("stages", MT.CHAIN_STAGES)
@pytest.mark.parametrize("m,d,f", SHAPES)
def test_mlp_chain_cuda_route_passes_its_operands(fake, allocations, tm, fs,
                                                  stages, m, d, f):
    x, _, _, w1, _, w2, _ = _operands(m, d, f)
    before = MT.mlp_chain.launches
    y = MT.mlp_chain(x, w1, w2, stages, tm=tm, fs=fs)
    assert MT.mlp_chain.launches == before + 1
    ptrs = _check_call(fake, allocations, x, w1, y, "ln" in stages,
                       "gelu" in stages, 0, tm, fs)
    # gamma 1, beta 0, b1 0, b2 0: the kept constant vectors
    consts = [(d, 1.0), (d, 0.0), (f, 0.0), (d, 0.0)]
    for ptr, (n, value) in zip(ptrs[1:3] + ptrs[4:5] + ptrs[6:], consts):
        v = MT._filled(x.device, n, value)
        assert ptr == v.data_ptr()
        assert v.dtype == torch.float32 and torch.equal(v, torch.full(
            (n,), value))
    assert ptrs[3] == w1.data_ptr() and ptrs[5] == w2.data_ptr()


def _misaligned(t):
    """``t``'s values in a buffer 2 bytes off a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


REFUSALS = [("fp32", "bfloat16"), ("x_misaligned", "16-byte aligned"),
            ("w1_misaligned", "16-byte aligned"),
            ("w2_misaligned", "16-byte aligned"),
            ("d40", "multiple of 32 up to 1024"),
            ("d1056", "multiple of 32 up to 1024"),
            ("d36_no_ln", "of 8 without"), ("f252", "F a multiple of 8"),
            ("tile_64x64", "instances"), ("tile_128x256", "instances")]


def _refused(case):
    """x, gamma, beta, w1, b1, w2, b2 and (tm, fs) of ``case``."""
    m, d, f = {"d40": (8, 40, 160), "d1056": (2, 1056, 64),
               "d36_no_ln": (8, 36, 144), "f252": (8, 64, 252)}.get(
        case, (8, 64, 256))
    ops = list(_operands(
        m, d, f, torch.float32 if case == "fp32" else torch.bfloat16))
    if case.endswith("misaligned"):
        i = {"x": 0, "w1": 3, "w2": 5}[case.split("_")[0]]
        ops[i] = _misaligned(ops[i])
    tile = {"tile_64x64": (64, 64), "tile_128x256": (128, 256)}.get(
        case, MT.TILES[0])
    return ops, tile


@pytest.mark.parametrize("case,match", REFUSALS)
def test_mlp_tile_cuda_route_refuses(fake, case, match):
    ops, (tm, fs) = _refused(case)
    flags = {"ln": False} if case == "d36_no_ln" else {}
    before = MT.mlp_tile.launches
    with pytest.raises((ValueError, TypeError), match=match):
        MT.mlp_tile(*ops, tm=tm, fs=fs, **flags)
    assert fake.calls == [] and MT.mlp_tile.launches == before


@pytest.mark.parametrize("case,match", REFUSALS)
def test_mlp_chain_cuda_route_refuses(fake, case, match):
    ops, (tm, fs) = _refused(case)
    stages = ("gelu",) if case == "d36_no_ln" else ("ln", "gelu")
    before = MT.mlp_chain.launches
    with pytest.raises((ValueError, TypeError), match=match):
        MT.mlp_chain(ops[0], ops[3], ops[5], stages, tm=tm, fs=fs)
    assert fake.calls == [] and MT.mlp_chain.launches == before


def test_mlp_tile_refuses_both_ablations_at_once(fake):
    """The TPU probe never runs #13 with LN and GELU both off."""
    with pytest.raises(ValueError, match="not both"):
        MT.mlp_tile(*_operands(8, 64, 256), ln=False, gelu=False)
    assert fake.calls == []


def test_mlp_forwards_take_d_multiples_of_8_without_a_layernorm(fake):
    """D 40 (a multiple of 8, not of 32) reaches the library where no row
    pass runs: #13's no-LN ablation and the chain's stages without "ln"."""
    ops = _operands(8, 40, 160)
    MT.mlp_tile(*ops, ln=False)
    MT.mlp_chain(ops[0], ops[3], ops[5], ())
    MT.mlp_chain(ops[0], ops[3], ops[5], ("gelu",))
    assert [c[15] for c in fake.calls] == [0, 0, 0]
    assert [c[11] for c in fake.calls] == [40] * 3


def _ab_probes():
    path = Path(__file__).resolve().parents[1] / "scripts" / "ab_probes.py"
    spec = importlib.util.spec_from_file_location("ab_probes", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    return ab


class _EngineLibrary:
    """Records the one-launch tile engine's ``vlp_mlp_tile`` (18
    arguments) in place of a parent checkout's library."""

    def __init__(self):
        self.calls = []

    def vlp_mlp_tile(self, *args):
        assert len(args) == 18
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("stages", [None, *MT.CHAIN_STAGES])
def test_ab_probes_calls_the_parents_tile_engine_by_its_signature(
        monkeypatch, stages):
    """In the parent's turns the script calls the one-launch engine's
    entry point as that engine's C signature orders it: x, gamma, beta,
    w1, b1, w2, b2, out, M, D, F, tm, fs, ln, gelu, bias, eps, stream; #13
    with its vectors and bias on, the chain with null vectors."""
    ab = _ab_probes()
    monkeypatch.setattr(ab, "_stream", lambda: 7)
    lib = _EngineLibrary()
    x, g, b, w1, b1, w2, b2 = _operands(77, 64, 256)
    ln = stages is None or "ln" in stages
    gelu = stages is None or "gelu" in stages
    vecs = (g, b, b1, b2) if stages is None else None
    out = ab._engine_call(lib, x, w1, w2, vecs, ln=ln, gelu=gelu, tm=64,
                          fs=128)
    (args,) = lib.calls
    assert out.shape == x.shape and args[7] == out.data_ptr()
    if vecs:
        assert args[:7] == _ptrs(x, g, b, w1, b1, w2, b2)
    else:
        assert args[:7] == (x.data_ptr(), 0, 0, w1.data_ptr(), 0,
                            w2.data_ptr(), 0)
    assert args[8:16] == (77, 64, 256, 64, 128, int(ln), int(gelu),
                          int(vecs is not None))
    assert args[16] == pytest.approx(1e-6) and args[17] == 7


def test_ab_probes_reads_the_parents_forward_instances(tmp_path):
    """#13 and #19a run at the ``TILES`` of each side's
    ``ops/mlp_tile.py``: the engine's four (tm, fs) on a parent that holds
    it, this tree's two here."""
    ab = _ab_probes()
    ops = tmp_path / "vlp_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    (ops / "mlp_tile.py").write_text(
        "TILES = ((64, 64), (64, 128), (32, 64), (32, 128))\n"
        "BWD_TILES = ((128, 64), (128, 128))\n")
    assert ab.parent_tiles(str(tmp_path), "TILES") == (
        (64, 64), (64, 128), (32, 64), (32, 128))
    root = Path(__file__).resolve().parents[1]
    assert ab.parent_tiles(str(root), "TILES") == MT.TILES == (
        (128, 128), (128, 64))
    (ops / "mlp_tile.py").write_text("BWD_TILES = ((128, 64),)\n")
    with pytest.raises(ValueError, match="no TILES"):
        ab.parent_tiles(str(tmp_path), "TILES")
