"""The CUDA route of the probe backwards #16 (``attn_sched_bwd`` and its
core ``attn_sched_bwd_core``) and #14 (``mlp_tile_bwd``) without a card.

With the library and the stream replaced by a recorder, each wrapper asks
the library for its workspace (the core too: the per-sample column sums
that the register core writes beside dqkv; the single-softmax mode no
longer takes a scratch of its own, so the query is the same call in every
mode), allocates the bytes the library names, makes one call of its C
entry point with the operands' pointers in the order of the C signature
(``vlp_tpu_torch/ops/_build.py``'s ``_SIGNATURES``), and counts one launch.
What the CUDA kernels do not take raises before any call: fp32 operands,
operands off 16-byte alignment (the products read them by TMA, the cores
by 16-byte copies), a head dim other than 32, S beyond the mode's limit
(``MAX_SEQ_BWD``: 256 in every mode, the register cores' 16 key tiles,
whose forward core forms v0's and stage2's o first), more samples than the
cores' grid, and for #14 (tm, fs) outside ``BWD_TILES`` and D or F not
multiples of 32.
"""
import contextlib

import pytest
import torch

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops import attn_sched as AS
from vlp_tpu_torch.ops import mlp_tile as MT

WS_BYTES = 4096


class _FakeLibrary:
    """Records the probe backwards' entry points in place of the card."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("vlp_") and name.endswith("_workspace"):
            def query(*args):
                self.calls.append((name, args))
                return WS_BYTES
            return query
        if name in ("vlp_attn_sched_bwd", "vlp_attn_sched_bwd_core",
                    "vlp_mlp_tile_bwd"):
            def call(*args):
                self.calls.append((name, args))
                return 0
            return call
        raise AttributeError(name)


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    allocated = []
    empty = torch.empty

    def recording_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        if kwargs.get("dtype") == torch.uint8:
            allocated.append(t)
        return t

    for mod in (AS, MT):
        monkeypatch.setattr(mod, "_route", lambda name, x: True)
        monkeypatch.setattr(mod, "_stream", lambda: 7)
        monkeypatch.setattr(mod._build, "load_library", lambda: lib)
    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    lib.workspaces = allocated
    return lib


def _ptrs(*tensors):
    return tuple(t.data_ptr() for t in tensors)


def _attn_operands(n, s, d, dtype=torch.bfloat16):
    """x, gamma, beta, wqkv, bqkv, wout, dy."""
    vec = torch.zeros(d)
    return (torch.zeros(n, s, d, dtype=dtype), vec, vec + 1.0,
            torch.zeros(d, 3 * d, dtype=dtype), torch.zeros(3 * d),
            torch.zeros(d, d, dtype=dtype), torch.zeros(n, s, d, dtype=dtype))


def test_signature_table_matches_the_wrappers_calls():
    """The C signatures the wrappers below are held to: #16 23 arguments
    (15 pointers), its core 12 (5), #14 22 (15); the workspace queries
    (N, S, D, H, mode), (N, S, H, mode) and (M, D, F, tm)."""
    sig = _build._SIGNATURES
    assert len(sig["vlp_attn_sched_bwd"][0]) == 23
    assert len(sig["vlp_attn_sched_bwd_core"][0]) == 12
    assert len(sig["vlp_mlp_tile_bwd"][0]) == 22
    assert [len(sig[f"{n}_workspace"][0]) for n in (
        "vlp_attn_sched_bwd", "vlp_attn_sched_bwd_core",
        "vlp_mlp_tile_bwd")] == [5, 4, 4]


@pytest.mark.parametrize("mode", AS.BWD_MODES)
@pytest.mark.parametrize("n,s,d", [(128, 196, 384), (4, 37, 384),
                                   (3, 208, 64), (1, 1, 32)])
def test_attn_sched_bwd_cuda_route_passes_its_operands(fake, mode, n, s, d):
    x, g, b, wq, bq, wo, dy = _attn_operands(n, s, d)
    heads = d // 32
    before = AS.attn_sched_bwd.launches
    outs = AS.attn_sched_bwd(x, g, b, wq, bq, wo, dy, heads, mode)
    assert AS.attn_sched_bwd.launches == before + 1
    dx, dg, db, dwq, dbq, dwo, dbo = outs
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert dwq.shape == (d, 3 * d) and dwo.shape == (d, d)
    assert dbq.shape == (1, 3 * d)
    assert all(t.dtype == torch.float32 for t in outs[1:])
    (query, q_args), (name, args) = fake.calls
    m = AS.BWD_MODES.index(mode)
    assert (query, q_args) == ("vlp_attn_sched_bwd_workspace",
                               (n, s, d, heads, m))
    assert name == "vlp_attn_sched_bwd"
    # x, gamma, beta, wqkv, bqkv, wout, dy; the seven cotangents; the
    # workspace; N, S, D, H, scale, eps, mode, stream
    assert args[:7] == _ptrs(x, g, b, wq, bq, wo, dy)
    assert args[7:14] == _ptrs(*outs)
    (ws,) = fake.workspaces
    assert ws.numel() == WS_BYTES and args[14] == ws.data_ptr()
    assert args[15:19] == (n, s, d, heads)
    assert args[19] == pytest.approx(32 ** -0.5)
    assert args[20] == pytest.approx(1e-6)
    assert args[21:] == (m, 7)


@pytest.mark.parametrize("mode", AS.BWD_MODES)
@pytest.mark.parametrize("n,s,heads", [(128, 196, 12), (4, 37, 12),
                                       (2, 1, 1)])
def test_attn_sched_bwd_core_cuda_route_passes_its_operands(fake, mode, n, s,
                                                            heads):
    d = 32 * heads
    qkv = torch.zeros(n, s, 3 * d, dtype=torch.bfloat16)
    do = torch.zeros(n, s, d, dtype=torch.bfloat16)
    before = AS.attn_sched_bwd_core.launches
    o, dqkv = AS.attn_sched_bwd_core(qkv, do, heads, mode)
    assert AS.attn_sched_bwd_core.launches == before + 1
    assert o.shape == do.shape and dqkv.shape == qkv.shape
    assert o.dtype == dqkv.dtype == torch.bfloat16
    (query, q_args), (name, args) = fake.calls
    m = AS.BWD_MODES.index(mode)
    # the same query in every mode: the column sums, no mode's own scratch
    assert (query, q_args) == ("vlp_attn_sched_bwd_core_workspace",
                               (n, s, heads, m))
    assert name == "vlp_attn_sched_bwd_core"
    # qkv, do, o, dqkv, the workspace; N, S, D, H, scale, mode, stream
    (ws,) = fake.workspaces
    assert args[:5] == _ptrs(qkv, do, o, dqkv, ws)
    assert args[5:9] == (n, s, d, heads)
    assert args[9] == pytest.approx(32 ** -0.5) and args[10:] == (m, 7)


def _misaligned(t):
    """``t``'s values in a buffer 2 bytes off a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


ATTN_REFUSALS = [("fp32", "bfloat16"), ("x_misaligned", "16-byte aligned"),
                 ("dy_misaligned", "16-byte aligned"),
                 ("wqkv_misaligned", "16-byte aligned"),
                 ("wout_misaligned", "16-byte aligned"),
                 ("head_dim_64", "head_dim 32"),
                 ("samples", "at most 65535")]


def _attn_refused(case):
    n, s, d = (65536, 1, 32) if case == "samples" else (2, 16, 64)
    ops = list(_attn_operands(
        n, s, d, torch.float32 if case == "fp32" else torch.bfloat16))
    at = {"x": 0, "wqkv": 3, "wout": 5, "dy": 6}
    if case.endswith("misaligned"):
        i = at[case.split("_")[0]]
        ops[i] = _misaligned(ops[i])
    heads = 1 if case == "head_dim_64" else d // 32
    return ops, heads


@pytest.mark.parametrize("mode", AS.BWD_MODES)
@pytest.mark.parametrize("case,match", ATTN_REFUSALS)
def test_attn_sched_bwd_cuda_route_refuses(fake, case, match, mode):
    ops, heads = _attn_refused(case)
    before = AS.attn_sched_bwd.launches
    with pytest.raises((ValueError, TypeError), match=match):
        AS.attn_sched_bwd(*ops, heads, mode)
    assert fake.calls == [] and AS.attn_sched_bwd.launches == before


@pytest.mark.parametrize("mode", AS.BWD_MODES)
def test_attn_sched_bwd_refuses_s_beyond_the_modes_limit(fake, mode):
    limit = AS.MAX_SEQ_BWD[mode]
    assert limit == {"v0": 256, "stage2": 256, "uni": 256}[mode]
    ops, heads = list(_attn_operands(1, limit + 1, 64)), 2
    qkv = torch.zeros(1, limit + 1, 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"S <= {limit}"):
        AS.attn_sched_bwd(*ops, heads, mode)
    with pytest.raises(ValueError, match=f"S <= {limit}"):
        AS.attn_sched_bwd_core(qkv, ops[0], heads, mode)
    assert fake.calls == []
    AS.attn_sched_bwd(*_attn_operands(1, limit, 64), heads, mode)
    assert [c[0] for c in fake.calls] == ["vlp_attn_sched_bwd_workspace",
                                          "vlp_attn_sched_bwd"]


@pytest.mark.parametrize("case,match", [("fp32", "bfloat16"),
                                        ("qkv_misaligned", "16-byte aligned"),
                                        ("do_misaligned", "16-byte aligned"),
                                        ("head_dim_64", "head_dim 32")])
def test_attn_sched_bwd_core_cuda_route_refuses(fake, case, match):
    dt = torch.float32 if case == "fp32" else torch.bfloat16
    qkv = torch.zeros(2, 16, 192, dtype=dt)
    do = torch.zeros(2, 16, 64, dtype=dt)
    if case == "qkv_misaligned":
        qkv = _misaligned(qkv)
    if case == "do_misaligned":
        do = _misaligned(do)
    heads = 1 if case == "head_dim_64" else 2
    before = AS.attn_sched_bwd_core.launches
    with pytest.raises((ValueError, TypeError), match=match):
        AS.attn_sched_bwd_core(qkv, do, heads, "uni")
    assert fake.calls == [] and AS.attn_sched_bwd_core.launches == before


def _mlp_operands(m, d, f, dtype=torch.bfloat16):
    """x, gamma, beta, w1, b1, w2, dy."""
    vec = torch.zeros(d)
    return (torch.zeros(m, d, dtype=dtype), vec, vec + 1.0,
            torch.zeros(d, f, dtype=dtype), torch.zeros(f),
            torch.zeros(f, d, dtype=dtype), torch.zeros(m, d, dtype=dtype))


@pytest.mark.parametrize("tm,fs", MT.BWD_TILES)
@pytest.mark.parametrize("m,d,f", [(25088, 384, 1536), (1037, 384, 1536),
                                   (1, 32, 96), (77, 1024, 4096)])
def test_mlp_tile_bwd_cuda_route_passes_its_operands(fake, tm, fs, m, d, f):
    ops = _mlp_operands(m, d, f)
    before = MT.mlp_tile_bwd.launches
    outs = MT.mlp_tile_bwd(*ops, tm=tm, fs=fs)
    assert MT.mlp_tile_bwd.launches == before + 1
    dx, dg, db, dw1, db1, dw2, db2 = outs
    assert dx.shape == (m, d) and dx.dtype == torch.bfloat16
    assert dw1.shape == (d, f) and dw2.shape == (f, d)
    assert db1.shape == (1, f) and dg.shape == db.shape == db2.shape == (1, d)
    assert all(t.dtype == torch.float32 for t in outs[1:])
    (query, q_args), (name, args) = fake.calls
    assert (query, q_args) == ("vlp_mlp_tile_bwd_workspace", (m, d, f, tm))
    assert name == "vlp_mlp_tile_bwd"
    # x, gamma, beta, w1, b1, w2, dy; the seven cotangents; the workspace;
    # M, D, F, tm, fs, eps, stream
    assert args[:7] == _ptrs(*ops)
    assert args[7:14] == _ptrs(*outs)
    (ws,) = fake.workspaces
    assert ws.numel() == WS_BYTES and args[14] == ws.data_ptr()
    assert args[15:20] == (m, d, f, tm, fs)
    assert args[20] == pytest.approx(1e-6) and args[21] == 7


MLP_REFUSALS = [("fp32", "bfloat16"), ("x_misaligned", "16-byte aligned"),
                ("dy_misaligned", "16-byte aligned"),
                ("w1_misaligned", "16-byte aligned"),
                ("w2_misaligned", "16-byte aligned"),
                ("d48", "multiples of 32"), ("f200", "multiples of 32"),
                ("d1056", "D <= 1024"), ("tile_64_64", "instances"),
                ("tile_32_128", "instances")]


@pytest.mark.parametrize("case,match", MLP_REFUSALS)
def test_mlp_tile_bwd_cuda_route_refuses(fake, case, match):
    m, d, f = 40, 64, 256
    d = {"d48": 48, "d1056": 1056}.get(case, d)
    f = 200 if case == "f200" else f
    ops = list(_mlp_operands(
        m, d, f, torch.float32 if case == "fp32" else torch.bfloat16))
    if case.endswith("misaligned"):
        i = {"x": 0, "w1": 3, "w2": 5, "dy": 6}[case.split("_")[0]]
        ops[i] = _misaligned(ops[i])
    tile = {"tile_64_64": (64, 64), "tile_32_128": (32, 128)}.get(
        case, MT.BWD_TILES[0])
    before = MT.mlp_tile_bwd.launches
    with pytest.raises((ValueError, TypeError), match=match):
        MT.mlp_tile_bwd(*ops, tm=tile[0], fs=tile[1])
    assert fake.calls == [] and MT.mlp_tile_bwd.launches == before


def test_mlp_tile_bwd_instances_are_the_dual_tiles_widths():
    """(tm, fs): the dual tile's 128 rows and its 64- and 128-column
    instances (csrc/mlp_tile_bwd.cu); the default the first."""
    assert MT.BWD_TILES == ((128, 64), (128, 128))
    ops = _mlp_operands(4, 64, 256)
    before = MT.mlp_tile_bwd.launches
    plain = MT.mlp_tile_bwd(*ops)
    assert MT.mlp_tile_bwd.launches == before  # the CPU's plain version
    for got, want in zip(plain, MT.mlp_tile_bwd_plain(*ops)):
        assert torch.equal(got, want)


def _ab_probes():
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    path = root / "scripts" / "ab_probes.py"
    spec = importlib.util.spec_from_file_location("ab_probes", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    return ab, root


def test_ab_probes_script_reads_each_sides_instances(tmp_path):
    """``scripts/ab_probes.py`` runs #13, #19a and #14 at the instances
    each checkout's ``ops/mlp_tile.py`` lists, read from its source."""
    ab, root = _ab_probes()
    assert ab.parent_tiles(str(root), "BWD_TILES") == MT.BWD_TILES
    assert ab.parent_tiles(str(root), "TILES") == MT.TILES
    ops = tmp_path / "vlp_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    (ops / "mlp_tile.py").write_text(
        "TILES = ((64, 64),)\nBWD_TILES = ((64, 64), (32, 64), (32, 128))\n")
    assert ab.parent_tiles(str(tmp_path), "BWD_TILES") == (
        (64, 64), (32, 64), (32, 128))
    assert ab.parent_tiles(str(tmp_path), "TILES") == ((64, 64),)
    (ops / "mlp_tile.py").write_text("TILES = ((64, 64),)\n")
    with pytest.raises(ValueError, match="no BWD_TILES"):
        ab.parent_tiles(str(tmp_path), "BWD_TILES")


def test_ab_probes_script_serves_the_parents_probe_backwards():
    """In the parent's turns the attention probes' (#15's and #16's),
    #14's and #18's entry points and their workspace queries come from the
    parent's library, every other entry point (the shipped #1/#3/#4
    yardsticks among them) from this tree's."""
    ab, _ = _ab_probes()
    names = ab.PARENT_ENTRY_POINTS
    assert set(names) == {"vlp_attn_sched", "vlp_attn_sched_core",
                          "vlp_attn_sched_bwd", "vlp_attn_sched_bwd_workspace",
                          "vlp_attn_sched_bwd_core",
                          "vlp_attn_sched_bwd_core_workspace",
                          "vlp_mlp_tile_bwd", "vlp_mlp_tile_bwd_workspace",
                          "vlp_bn_relu_gemm"}
    own = type("Own", (), {n: "own" for n in names + (
        "vlp_ln_attention", "vlp_ln_attention_bwd", "vlp_ln_mlp_bwd",
        "vlp_attn_sched_core_smem")})()
    other = type("Other", (), {n: "parent" for n in names})()
    mixed = ab._Mixed(own, other, names)
    assert all(getattr(mixed, n) == "parent" for n in names)
    assert mixed.vlp_ln_attention_bwd == mixed.vlp_ln_mlp_bwd == "own"
    assert mixed.vlp_ln_attention == mixed.vlp_attn_sched_core_smem == "own"


def test_ab_probes_script_needs_a_card(monkeypatch, capsys):
    ab, root = _ab_probes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        ab.main(["--parent", str(root)])
    assert exc.value.code == 2 and capsys.readouterr().out == ""
