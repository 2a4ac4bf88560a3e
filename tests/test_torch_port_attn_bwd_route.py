"""The CUDA route of the half-block attention backwards #3
(``ln_attention_bwd``) and #6 (``ln_attention_windows_bwd``) without a
card, and the unit sums behind their ``dbqkv``.

The route: with the library and the stream replaced by a recorder, each
wrapper asks the library for its workspace at the shape the kernel runs
(N units of S tokens), makes one call of its C entry point with the
operands' pointers and shapes, and counts one launch; what the CUDA kernel
does not take (S above 256, head dim other than 32, operands off 16-byte
alignment, more units than the attention core's grid) raises before any
call.

The sums: on the card each attention unit's fp32 dq, dk and dv are summed
over its rows into [N, 3D] partials, which a fixed-order pass adds in unit
order (windows in blockify order). The plain backward sums the fp32 dqkv
over all rows at once; both must agree with each other to fp32 rounding
and with ``jax.vjp`` of the JAX package's ``ln_attention`` and
``ln_attention_windows`` (Pallas kernels in interpret mode) within the
tolerances of ``test_torch_port_fused_block_bwd.py``.
"""
import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.ops import fused_block as JFB
from vlp_tpu_torch.ops import block_attention as TBA
from vlp_tpu_torch.ops import fused_block as TFB

WS_BYTES = 4096
REL = {"fp32": 1e-4, "bf16": 2.0 ** -5}


class _FakeLibrary:
    """Records the backward entry points' arguments in place of the card."""

    def __init__(self):
        self.calls = []

    def vlp_ln_attention_bwd_workspace(self, *args):
        self.calls.append(("workspace", args))
        return WS_BYTES

    def vlp_ln_attention_bwd(self, *args):
        self.calls.append(("ln_attention_bwd", args))
        return 0

    def vlp_ln_attention_windows_bwd(self, *args):
        self.calls.append(("ln_attention_windows_bwd", args))
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(TFB, "_route", lambda name, x: True)
    monkeypatch.setattr(TFB, "_stream", lambda: 7)
    monkeypatch.setattr(TFB._build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return lib


def _operands(shape, d, dtype=torch.bfloat16):
    """x, dy, qkv and o of ``shape`` (tokens ... D) and parameters."""
    x = torch.zeros(*shape, dtype=dtype)
    qkv = torch.zeros(*shape[:-1], 3 * d, dtype=dtype)
    vec = torch.zeros(d)
    return (x, vec, vec + 1.0, torch.zeros(d, 3 * d), torch.zeros(3 * d),
            torch.zeros(d, d), x.clone(), qkv, x.clone())


def _ptrs(*tensors):
    return tuple(t.data_ptr() for t in tensors)


@pytest.mark.parametrize("n,s,d,heads", [(3, 196, 96, 3), (2, 256, 64, 2),
                                         (5, 1, 32, 1)])
def test_ln_attention_bwd_cuda_route_passes_its_operands(fake, n, s, d,
                                                         heads):
    x, g, b, wq, bq, wo, dy, qkv, o = _operands((n, s, d), d)
    before = TFB.ln_attention_bwd.launches
    outs = TFB.ln_attention_bwd(x, g, b, wq, bq, wo, dy, heads, qkv, o)
    assert TFB.ln_attention_bwd.launches == before + 1
    dx, dg, db, dwq, dbq, dwo, dbo = outs
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert dwq.shape == (d, 3 * d) and dwq.dtype == torch.bfloat16
    assert dwo.shape == (d, d) and dbq.shape == (1, 3 * d)
    assert all(t.dtype == torch.float32 for t in (dg, db, dbq, dbo))
    (what, ws_args), (name, args) = fake.calls
    assert (what, ws_args) == ("workspace", (n, s, d, heads))
    assert name == "ln_attention_bwd"
    # x, dy, qkv and o as given; the cotangents in the order of the C
    # signature; then N, S, D, H, scale, eps, stream
    assert args[0] == x.data_ptr() and args[5:8] == _ptrs(qkv, o, dy)
    assert args[8:15] == _ptrs(dx, dg, db, dwq, dbq, dwo, dbo)
    assert args[16:20] == (n, s, d, heads)
    assert args[20] == pytest.approx(32 ** -0.5) and args[22] == 7


@pytest.mark.parametrize("b,h,w,d,block,heads", [(2, 28, 28, 96, 14, 3),
                                                 (1, 32, 16, 64, 16, 2)])
def test_ln_attention_windows_bwd_cuda_route_passes_its_operands(
        fake, b, h, w, d, block, heads):
    x, g, bt, wq, bq, wo, dy, qkv, o = _operands((b, h, w, d), d)
    before = TFB.ln_attention_windows_bwd.launches
    outs = TFB.ln_attention_windows_bwd(x, block, g, bt, wq, bq, wo, dy,
                                        heads, qkv, o)
    assert TFB.ln_attention_windows_bwd.launches == before + 1
    assert outs[0].shape == x.shape and outs[4].shape == (1, 3 * d)
    (what, ws_args), (name, args) = fake.calls
    units = b * (h // block) * (w // block)
    assert (what, ws_args) == ("workspace", (units, block * block, d, heads))
    assert name == "ln_attention_windows_bwd"
    assert args[0] == x.data_ptr() and args[5:8] == _ptrs(qkv, o, dy)
    assert args[8:15] == _ptrs(*outs)
    assert args[16:22] == (b, h, w, d, heads, block)
    assert args[24] == 7


def _misaligned(t):
    """``t``'s values in a buffer 2 bytes off a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("case,match", [
    ("s257", "S <= 256"),
    ("head64", "head_dim 32"),
    ("x_misaligned", "16-byte aligned"),
    ("qkv_misaligned", "16-byte aligned"),
    ("units", "65535"),
    ("fp32", "bfloat16"),
])
def test_ln_attention_bwd_cuda_route_refuses(fake, case, match):
    n, s, d, heads = 2, 16, 64, 2
    if case == "s257":
        s = 257
    if case == "head64":
        heads = 1
    if case == "units":
        n, s = 65536, 1
    x, g, b, wq, bq, wo, dy, qkv, o = _operands(
        (n, s, d), d, torch.float32 if case == "fp32" else torch.bfloat16)
    if case == "x_misaligned":
        x = _misaligned(x)
    if case == "qkv_misaligned":
        qkv = _misaligned(qkv)
    before = TFB.ln_attention_bwd.launches
    with pytest.raises((ValueError, TypeError), match=match):
        TFB.ln_attention_bwd(x, g, b, wq, bq, wo, dy, heads, qkv, o)
    assert fake.calls == [] and TFB.ln_attention_bwd.launches == before


@pytest.mark.parametrize("case,match", [
    ("block17", "S <= 256"),
    ("head64", "head_dim 32"),
    ("dy_misaligned", "16-byte aligned"),
    ("window", "divisible by the window"),
])
def test_ln_attention_windows_bwd_cuda_route_refuses(fake, case, match):
    b, h, w, d, block, heads = 1, 8, 8, 64, 4, 2
    if case == "block17":
        h = w = block = 17
    if case == "head64":
        heads = 1
    if case == "window":
        w = 10
    x, g, bt, wq, bq, wo, dy, qkv, o = _operands((b, h, w, d), d)
    if case == "dy_misaligned":
        dy = _misaligned(dy)
    before = TFB.ln_attention_windows_bwd.launches
    with pytest.raises(ValueError, match=match):
        TFB.ln_attention_windows_bwd(x, block, g, bt, wq, bq, wo, dy, heads,
                                     qkv, o)
    assert fake.calls == []
    assert TFB.ln_attention_windows_bwd.launches == before


def _inputs(seed, shape, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 0.5
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, dy, [np.asarray(p, np.float32) for p in (
        1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
        rng.standard_normal((d, 3 * d)) * d ** -0.5,
        0.02 * rng.standard_normal(3 * d),
        rng.standard_normal((d, d)) * d ** -0.5,
        0.02 * rng.standard_normal(d))]


def _unit_sums_in_order(x, params, dy, heads):
    """dbqkv as the card forms it from units [N, S, D]: each unit's column
    sums of the fp32 dqkv (the plain backward's own), then added in unit
    order."""
    g, b, wq, bq, wo = params[:5]
    dt = x.dtype
    (g, b, bq), (wq, wo) = TFB._cast(dt, vectors=(g, b, bq),
                                     matrices=(wq, wo))
    ln = (TFB._ln_fwd(x.float())[0] * g + b).to(dt)
    qkv = (TFB._mm(ln, wq) + bq).to(dt)
    do = TFB._mm(dy.float().to(dt), wo.T).to(dt)
    per_unit = TBA.dqkv_f32(qkv, do, heads).sum(1)        # [N, 3D]
    total = torch.zeros(per_unit.shape[1])
    for unit in per_unit:
        total = total + unit
    return total.reshape(1, -1)


def _jax_dbqkv(fn, x, dy, params, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jp = [jnp.asarray(p, jdt if p.ndim == 2 else jnp.float32).reshape(
        p.shape if p.ndim == 2 else (1, -1)) for p in params]
    _, vjp = jax.vjp(fn, jnp.asarray(x, jdt), *jp)
    return np.asarray(vjp(jnp.asarray(dy, jdt))[4], np.float32)  # bqkv's


def _torch(x, dy, params, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt),
            [torch.from_numpy(p).to(tdt if p.ndim == 2 else torch.float32)
             for p in params])


def _assert_dbqkv(plain, ordered, want, dtype):
    scale = max(np.abs(want).max(), 1e-30)
    # the same fp32 terms in two orders
    assert (plain - ordered).abs().max().item() <= 1e-5 * scale
    for got in (plain, ordered):
        err = np.abs(got.numpy().reshape(want.shape) - want).max() / scale
        assert err <= REL[dtype], err


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n,s,d,heads", [(3, 16, 64, 2), (2, 37, 32, 1)])
def test_dbqkv_is_the_unit_sums_in_unit_order(monkeypatch, n, s, d, heads,
                                              dtype):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    x, dy, params = _inputs(n * s + d, (n, s, d), d)
    want = _jax_dbqkv(lambda x_, g, b, wq, bq, wo, bo: JFB.ln_attention(
        x_, g, b, wq, bq, wo, bo, heads), x, dy, params, dtype)
    tx, tdy, tp = _torch(x, dy, params, dtype)
    plain = TFB.ln_attention_bwd_plain(tx, *tp[:5], tdy, heads)[4]
    _assert_dbqkv(plain, _unit_sums_in_order(tx, tp, tdy, heads), want,
                  dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_windows_dbqkv_is_the_window_sums_in_blockify_order(monkeypatch,
                                                            dtype):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    b, h, w, d, block, heads = 4, 8, 8, 32, 4, 2  # JFB.supports_window
    x, dy, params = _inputs(11, (b, h, w, d), d)
    want = _jax_dbqkv(
        lambda x_, g, bt, wq, bq, wo, bo: JFB.ln_attention_windows(
            x_, block, g, bt, wq, bq, wo, bo, heads), x, dy, params, dtype)
    tx, tdy, tp = _torch(x, dy, params, dtype)
    plain = TFB.ln_attention_windows_bwd_plain(tx, block, *tp[:5], tdy,
                                               heads)[4]
    ordered = _unit_sums_in_order(TFB._windows(tx, block), tp,
                                  TFB._windows(tdy, block), heads)
    _assert_dbqkv(plain, ordered, want, dtype)


def _ab_script():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / "ab_attention.py"
    spec = importlib.util.spec_from_file_location("ab_attention", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    return ab


def test_ab_script_serves_the_parents_half_block_backwards():
    """In the parent's turns ``scripts/ab_attention.py`` takes #1's, #5's,
    #3's and #6's entry points and the backwards' workspace query from the
    parent's library and every other entry point from this tree's."""
    ab = _ab_script()
    own = type("Own", (), {"vlp_ln_attention": "own fwd",
                           "vlp_ln_attention_bwd": "own bwd",
                           "vlp_ln_mlp_bwd": "own mlp",
                           "vlp_attend_qkv": "own core"})()
    other = type("Other", (), {
        "vlp_ln_attention": "parent fwd",
        "vlp_ln_attention_windows": "parent windows fwd",
        "vlp_ln_attention_bwd": "parent bwd",
        "vlp_ln_attention_windows_bwd": "parent windows bwd",
        "vlp_ln_attention_bwd_workspace": "parent workspace"})()
    mixed = ab._Mixed(own, other, ab.PARENT_HALF_BLOCK)
    assert mixed.vlp_ln_attention == "parent fwd"
    assert mixed.vlp_ln_attention_windows == "parent windows fwd"
    assert mixed.vlp_ln_attention_bwd == "parent bwd"
    assert mixed.vlp_ln_attention_windows_bwd == "parent windows bwd"
    assert mixed.vlp_ln_attention_bwd_workspace == "parent workspace"
    assert mixed.vlp_ln_mlp_bwd == "own mlp"
    assert mixed.vlp_attend_qkv == "own core"


@pytest.mark.parametrize("name,part", [
    ("void vlp::mhsa_bwd_kernel<32, vlp::IdentityRows>(...)",
     "attention core"),
    ("void vlp::reg::mhsa_reg_bwd_kernel<32, 13, vlp::WindowRows, true>(...)",
     "attention core"),
    ("void vlp::gemm_kernel<false, false, true, 4>(...)", "do GEMM"),
    ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::RowsNT, 128, 3, 2, "
     "__nv_bfloat16>(...)", "do GEMM"),
    ("void vlp::gemm_kernel<false, true, false, 3>(...)",
     "dWout + dWqkv GEMMs"),
    ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::ColsTN, 128, 3, 2, "
     "float>(...)", "dWout + dWqkv GEMMs"),
    ("void vlp::gemm_kernel<false, false, true, 3>(...)", "dln GEMM"),
    ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::RowsNT, 128, 3, 2, "
     "float>(...)", "dln GEMM"),
    ("void vlp::ln_bwd_rows_kernel<12>(...)", "row passes"),
    ("void vlp::reduce_rows_kernel<float>(...)", "row passes"),
    ("void vlp::ln_rows_kernel<4>(...)", "row passes"),
    ("Memset (Device)", "other"),
])
def test_ab_script_splits_both_sides_kernels_into_the_same_parts(name,
                                                                 part):
    """The split's parts name the same work in the parent's kernels
    (gemm.cuh, mhsa_bwd.cuh) and in this tree's (wgmma_gemm.cuh,
    mhsa_reg_bwd.cuh)."""
    ab = _ab_script()
    assert next(p for p, pat in ab.SPLIT_PARTS if re.search(pat, name)) \
        == part


_ROWS = "void vlp::ln_rows_kernel<4>(...)"
_DENSE64 = ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::DenseEpi<false>, 64, "
            "4, 2, __nv_bfloat16>(...)")
_DENSE128 = ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::DenseEpi<false>, 128, "
             "3, 2, __nv_bfloat16>(...)")
# a name with both of DenseEpi's parameters (kGelu, kErf)
_DENSE64_2 = ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::DenseEpi<false, "
              "false>, 64, 4, 2, __nv_bfloat16>(...)")
_REG = "void vlp::reg::mhsa_reg_kernel<32, 13, vlp::{}>(...)"
_OLD_QKV = "void vlp::gemm_kernel<true, false, false, 0>(...)"
_OLD_CORE = "void vlp::mhsa_kernel<32, vlp::{}>(...)"
_OLD_OUT = "void vlp::gemm_kernel<false, false, false, 2>(...)"
_FWD_PARTS = ["LN rows", "qkv product", "attention core", "out-projection"]


@pytest.mark.parametrize("names,parts", [
    # this tree: one DenseEpi<false> instance for both products, either map
    ([_ROWS, _DENSE64, _REG.format("IdentityRows"), _DENSE64], _FWD_PARTS),
    ([_ROWS, _DENSE64, _REG.format("WindowRows"), _DENSE64], _FWD_PARTS),
    ([_ROWS, _DENSE64_2, _REG.format("IdentityRows"), _DENSE64_2],
     _FWD_PARTS),
    # two widths, two instances
    ([_ROWS, _DENSE128, _REG.format("IdentityRows"), _DENSE64], _FWD_PARTS),
    ([_ROWS, _DENSE64, _REG.format("WindowRows"), _DENSE128], _FWD_PARTS),
    # the parent: gemm.cuh's LN-prologue GEMM, mhsa.cuh's core, gemm.cuh's
    # residual GEMM
    ([_OLD_QKV, _OLD_CORE.format("IdentityRows"), _OLD_OUT],
     _FWD_PARTS[1:]),
    ([_OLD_QKV, _OLD_CORE.format("WindowRows"), _OLD_OUT], _FWD_PARTS[1:]),
    # anything else the profiler records
    ([_ROWS, "Memset (Device)", _DENSE64, _REG.format("IdentityRows"),
      _DENSE64], ["LN rows", "other"] + _FWD_PARTS[1:]),
])
def test_ab_script_splits_the_forwards_by_launch_order(names, parts):
    """#1's and #5's four launches on this tree's side and three on the
    parent's fall into the same parts; two launches of one product
    instance split by their order in the call (the first is qkv)."""
    ab = _ab_script()
    assert ab._call_parts(names, ab.ATTN_FWD_SPLIT_PARTS) == parts


@pytest.mark.parametrize("parts_of", ["SPLIT_PARTS", "MLP_SPLIT_PARTS",
                                      "MLP_FWD_SPLIT_PARTS"])
def test_ab_script_order_rule_leaves_the_other_splits_by_name(parts_of):
    """Only the forwards' qkv part takes one kernel a call: in the other
    splits a repeated kernel keeps its part."""
    ab = _ab_script()
    table = getattr(ab, parts_of)
    names = [_ROWS, _DENSE64, _DENSE64, _ROWS]
    want = [next(p for p, pat in table if re.search(pat, n))
            for n in names]
    assert ab._call_parts(names, table) == want
