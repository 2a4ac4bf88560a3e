"""The CUDA route of the probe forward #15 (``attn_sched`` and its core
``attn_sched_core``) without a card.

With the library and the stream replaced by a recorder, ``attn_sched``
allocates qkv [N, S, 3D] and o [N, S, D] as its only scratch (#1's launch
sequence: the first launch writes LN(x) into o's buffer, which the qkv
product reads before the core writes o) beside y, ``attn_sched_core`` only
o; each makes one call of its C entry point with the operands' pointers in
the order of the C signature (``vlp_tpu_torch/ops/_build.py``'s
``_SIGNATURES``) and counts one launch. What the CUDA kernels do not take
raises before any call: fp32 operands, operands off 16-byte alignment (the
products read x, Wqkv and Wout by TMA, the core reads qkv by 16-byte
copies), a head dim other than 32, S beyond the mode's limit (``MAX_SEQ``:
256 in every mode, the register core's 16 key tiles) and more samples than
the core's grid.
"""
import contextlib

import pytest
import torch

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops import attn_sched as AS


class _FakeLibrary:
    """Records the probe forward's entry points in place of the card."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in ("vlp_attn_sched", "vlp_attn_sched_core"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(AS, "_route", lambda name, x: True)
    monkeypatch.setattr(AS, "_stream", lambda: 7)
    monkeypatch.setattr(AS._build, "load_library", lambda: lib)
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


def _operands(n, s, d, dtype=torch.bfloat16):
    """x, gamma, beta, wqkv, bqkv, wout, bout: x and the matrices in
    ``dtype``, the vectors fp32."""
    vec = torch.zeros(d)
    return (torch.zeros(n, s, d, dtype=dtype), vec, vec + 1.0,
            torch.zeros(d, 3 * d, dtype=dtype), torch.zeros(3 * d),
            torch.zeros(d, d, dtype=dtype), vec + 2.0)


def test_signature_table_matches_the_wrappers_calls():
    """The C signatures the wrappers below are held to: #15 18 arguments
    (10 pointers: seven operands, qkv, o, y; then N, S, D, H, scale, eps,
    mode, stream), its core 9 (qkv, o; N, S, D, H, scale, mode, stream)."""
    sig = _build._SIGNATURES
    args, ret = sig["vlp_attn_sched"]
    assert len(args) == 18 and ret is _build._I
    assert args[:10] == [_build._P] * 10 and args[-1] is _build._P
    args, ret = sig["vlp_attn_sched_core"]
    assert len(args) == 9 and ret is _build._I
    assert args[:2] == [_build._P] * 2 and args[-1] is _build._P
    assert sig["vlp_attn_sched_core_smem"] == ([_build._I] * 2, _build._Z)


# (N, S, D): the probe's batch, a ragged S, every mode's largest, one token
SHAPES = [(128, 196, 384), (4, 37, 384), (2, 256, 64), (1, 1, 32)]


@pytest.mark.parametrize("mode", AS.MODES)
@pytest.mark.parametrize("n,s,d", SHAPES)
def test_attn_sched_cuda_route_passes_its_operands(fake, allocations, mode,
                                                   n, s, d):
    ops = _operands(n, s, d)
    heads = d // 32
    before = AS.attn_sched.launches
    y = AS.attn_sched(*ops, heads, mode)
    assert AS.attn_sched.launches == before + 1
    assert y.shape == (n, s, d) and y.dtype == torch.bfloat16
    (name, args), = fake.calls
    assert name == "vlp_attn_sched"
    # x, gamma, beta, wqkv, bqkv, wout, bout (the fp32 vectors as they are:
    # ``_cast`` reshapes them without a copy), then qkv, o and y
    assert args[:7] == _ptrs(*ops)
    assert args[9] == y.data_ptr()
    assert len({*args[7:10], ops[0].data_ptr()}) == 4
    # the scratch qkv and o, then y: nothing else allocated
    assert allocations == {args[7]: ((n, s, 3 * d), torch.bfloat16),
                           args[8]: ((n, s, d), torch.bfloat16),
                           args[9]: ((n, s, d), torch.bfloat16)}
    # N, S, D, H, scale, eps, mode, stream
    assert args[10:14] == (n, s, d, heads)
    assert args[14] == pytest.approx(32 ** -0.5)
    assert args[15] == pytest.approx(1e-6)
    assert args[16:] == (AS.MODES.index(mode), 7)


@pytest.mark.parametrize("mode", AS.MODES)
@pytest.mark.parametrize("n,s,d", SHAPES)
def test_attn_sched_core_cuda_route_passes_its_operands(fake, allocations,
                                                        mode, n, s, d):
    qkv = torch.zeros(n, s, 3 * d, dtype=torch.bfloat16)
    heads = d // 32
    before = AS.attn_sched_core.launches
    o = AS.attn_sched_core(qkv, heads, mode)
    assert AS.attn_sched_core.launches == before + 1
    assert o.shape == (n, s, d) and o.dtype == torch.bfloat16
    (name, args), = fake.calls
    assert name == "vlp_attn_sched_core"
    # qkv, o; N, S, D, H, scale, mode, stream; o the only allocation
    assert args[:2] == _ptrs(qkv, o)
    assert allocations == {o.data_ptr(): ((n, s, d), torch.bfloat16)}
    assert args[2:6] == (n, s, d, heads)
    assert args[6] == pytest.approx(32 ** -0.5)
    assert args[7:] == (AS.MODES.index(mode), 7)


def _misaligned(t):
    """``t``'s values in a buffer 2 bytes off a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


REFUSALS = [("fp32", "bfloat16"), ("x_misaligned", "16-byte aligned"),
            ("wqkv_misaligned", "16-byte aligned"),
            ("wout_misaligned", "16-byte aligned"),
            ("head_dim_64", "head_dim 32"), ("s257", "S <= 256"),
            ("samples", "at most 65535")]


def _refused(case):
    """The operands of ``case`` and the head count: 65536 samples of one
    token, 257 tokens, or D = 64 split into one head."""
    n, s, d = {"samples": (65536, 1, 32), "s257": (1, 257, 64)}.get(
        case, (2, 16, 64))
    ops = list(_operands(
        n, s, d, torch.float32 if case == "fp32" else torch.bfloat16))
    if case.endswith("misaligned"):
        i = {"x": 0, "wqkv": 3, "wout": 5}[case.split("_")[0]]
        ops[i] = _misaligned(ops[i])
    return ops, 1 if case == "head_dim_64" else d // 32


@pytest.mark.parametrize("mode", AS.MODES)
@pytest.mark.parametrize("case,match", REFUSALS)
def test_attn_sched_cuda_route_refuses(fake, case, match, mode):
    ops, heads = _refused(case)
    before = AS.attn_sched.launches
    with pytest.raises((ValueError, TypeError), match=match):
        AS.attn_sched(*ops, heads, mode)
    assert fake.calls == [] and AS.attn_sched.launches == before


CORE_REFUSALS = [("fp32", "bfloat16"), ("qkv_misaligned", "16-byte aligned"),
                 ("head_dim_64", "head_dim 32"), ("s257", "S <= 256"),
                 ("samples", "at most 65535")]


@pytest.mark.parametrize("mode", AS.MODES)
@pytest.mark.parametrize("case,match", CORE_REFUSALS)
def test_attn_sched_core_cuda_route_refuses(fake, case, match, mode):
    n, s = {"samples": (65536, 1), "s257": (1, 257)}.get(case, (2, 16))
    qkv = torch.zeros(n, s, 192, dtype=torch.float32 if case == "fp32"
                      else torch.bfloat16)
    if case == "qkv_misaligned":
        qkv = _misaligned(qkv)
    heads = 1 if case == "head_dim_64" else 2
    before = AS.attn_sched_core.launches
    with pytest.raises((ValueError, TypeError), match=match):
        AS.attn_sched_core(qkv, heads, mode)
    assert fake.calls == [] and AS.attn_sched_core.launches == before


@pytest.mark.parametrize("mode", AS.MODES)
def test_attn_sched_takes_s_256_in_every_mode(fake, mode):
    """``MAX_SEQ`` is the register core's 16 key tiles in every mode: S 256
    reaches the library, S 257 does not."""
    assert AS.MAX_SEQ[mode] == 256
    ops = _operands(1, 256, 64)
    AS.attn_sched(*ops, 2, mode)
    AS.attn_sched_core(torch.zeros(1, 256, 192, dtype=torch.bfloat16), 2,
                       mode)
    assert [c[0] for c in fake.calls] == ["vlp_attn_sched",
                                          "vlp_attn_sched_core"]
    with pytest.raises(ValueError, match=f"S <= 256 \\(mode {mode}\\)"):
        AS.attn_sched(*_operands(1, 257, 64), 2, mode)
    assert len(fake.calls) == 2
