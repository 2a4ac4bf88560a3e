"""The CUDA route of the half-block attention forwards #1
(``ln_attention``) and #5 (``ln_attention_windows``) without a card.

With the library and the stream replaced by a recorder, each wrapper
allocates qkv [.., 3D] and o [.., D] as its only scratch (the first launch
writes LN(x) into o's buffer, which the qkv product reads before the core
writes o), makes one call of its C entry point with the operands' pointers
in the order of the C signature, and counts one launch. What the CUDA
kernel does not take raises before any call: operands off 16-byte
alignment (the products read x, Wqkv and Wout by TMA), fp32 operands, more
than 65535 attention units (the core's grid) and a head dim other than 32.
"""
import contextlib

import pytest
import torch

from vlp_tpu_torch.ops import fused_block as TFB


class _FakeLibrary:
    """Records the forward entry points' arguments in place of the card."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name not in ("vlp_ln_attention", "vlp_ln_attention_windows"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(TFB, "_route", lambda name, x: True)
    monkeypatch.setattr(TFB, "_stream", lambda: 7)
    monkeypatch.setattr(TFB._build, "load_library", lambda: lib)
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


def _params(d, dtype=torch.bfloat16):
    """gamma, beta [d], wqkv [d, 3d], bqkv [3d], wout [d, d], bout [d]: the
    matrices in ``dtype``, the vectors fp32."""
    return (torch.ones(d), torch.zeros(d),
            torch.zeros(d, 3 * d, dtype=dtype), torch.zeros(3 * d),
            torch.zeros(d, d, dtype=dtype), torch.zeros(d))


def _check_pointers(args, x, params, y):
    """x, gamma, beta, wqkv, bqkv, wout, bout (the fp32 vectors as they
    are: ``_cast`` reshapes them without a copy), then qkv, o and y."""
    assert args[:7] == (x.data_ptr(), *(t.data_ptr() for t in params))
    assert args[9] == y.data_ptr()
    assert len({*args[7:10], x.data_ptr()}) == 4


# (N, S, D, heads): NesT-Small level 0 at batch 8, serving's ragged 37
# images at level 2
SHAPES = [(8 * 16, 196, 96, 3), (37, 196, 384, 12)]


@pytest.mark.parametrize("n,s,d,heads", SHAPES)
def test_ln_attention_cuda_route_passes_its_operands(fake, allocations, n, s,
                                                     d, heads):
    x = torch.zeros(n, s, d, dtype=torch.bfloat16)
    params = _params(d)
    before = TFB.ln_attention.launches
    y = TFB.ln_attention(x, *params, heads)
    assert TFB.ln_attention.launches == before + 1
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    (name, args), = fake.calls
    assert name == "vlp_ln_attention"
    _check_pointers(args, x, params, y)
    # the scratch qkv and o, then y: nothing else allocated
    assert allocations == {args[7]: ((n, s, 3 * d), torch.bfloat16),
                           args[8]: ((n, s, d), torch.bfloat16),
                           args[9]: ((n, s, d), torch.bfloat16)}
    # N, S, D, H, scale, eps, stream
    assert args[10:14] == (n, s, d, heads)
    assert args[14] == pytest.approx(32 ** -0.5)
    assert args[15] == pytest.approx(1e-6) and args[16] == 7


# (B, H, W, D, block, heads): NesT-Small's level-0 map at batch 2, the
# ragged request's 37 level-2 maps
WINDOW_SHAPES = [(2, 56, 56, 96, 14, 3), (37, 14, 14, 384, 14, 12)]


@pytest.mark.parametrize("b,h,w,d,block,heads", WINDOW_SHAPES)
def test_ln_attention_windows_cuda_route_passes_its_operands(
        fake, allocations, b, h, w, d, block, heads):
    x = torch.zeros(b, h, w, d, dtype=torch.bfloat16)
    params = _params(d)
    before = TFB.ln_attention_windows.launches
    y = TFB.ln_attention_windows(x, block, *params, heads)
    assert TFB.ln_attention_windows.launches == before + 1
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    (name, args), = fake.calls
    assert name == "vlp_ln_attention_windows"
    _check_pointers(args, x, params, y)
    # qkv and o in the map's row order, then y
    assert allocations == {args[7]: ((b, h, w, 3 * d), torch.bfloat16),
                           args[8]: ((b, h, w, d), torch.bfloat16),
                           args[9]: ((b, h, w, d), torch.bfloat16)}
    # B, H, W, D, heads, block, scale, eps, stream
    assert args[10:16] == (b, h, w, d, heads, block)
    assert args[16] == pytest.approx(32 ** -0.5)
    assert args[17] == pytest.approx(1e-6) and args[18] == 7


def _misaligned(t):
    """``t``'s values in a buffer 2 bytes off a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


REFUSALS = [("x_misaligned", "16-byte aligned"),
            ("wqkv_misaligned", "16-byte aligned"),
            ("wout_misaligned", "16-byte aligned"),
            ("fp32", "bfloat16"),
            ("units65536", "at most 65535"),
            ("head_dim64", "head_dim 32")]


def _refused_operands(case, shape):
    """x of ``shape`` [.., D] and the parameters, with the case's fault:
    65536 units of one token, or D = 64 split into one head."""
    if case == "units65536":
        shape = (65536, 1, 32) if len(shape) == 3 else (1, 256, 256, 32)
    d = shape[-1]
    dt = torch.float32 if case == "fp32" else torch.bfloat16
    x = torch.zeros(shape, dtype=dt)
    g, b, wq, bq, wo, bo = _params(d, dt)
    mis = {"x": x, "wqkv": wq, "wout": wo}
    if case.endswith("misaligned"):
        name = case.split("_")[0]
        mis[name] = _misaligned(mis[name])
    heads = 1 if case == "head_dim64" else d // 32
    return mis["x"], (g, b, mis["wqkv"], bq, mis["wout"], bo), heads


@pytest.mark.parametrize("case,match", REFUSALS)
def test_ln_attention_cuda_route_refuses(fake, case, match):
    d = 64 if case == "head_dim64" else 96
    x, params, heads = _refused_operands(case, (4, 16, d))
    before = TFB.ln_attention.launches
    with pytest.raises((ValueError, TypeError), match=match):
        TFB.ln_attention(x, *params, heads)
    assert fake.calls == [] and TFB.ln_attention.launches == before


@pytest.mark.parametrize("case,match", REFUSALS)
def test_ln_attention_windows_cuda_route_refuses(fake, case, match):
    d = 64 if case == "head_dim64" else 96
    x, params, heads = _refused_operands(case, (2, 8, 8, d))
    block = 1 if case == "units65536" else 4
    before = TFB.ln_attention_windows.launches
    with pytest.raises((ValueError, TypeError), match=match):
        TFB.ln_attention_windows(x, block, *params, heads)
    assert fake.calls == [] and TFB.ln_attention_windows.launches == before
