"""The CUDA route of the MLP backwards #4 (``ln_mlp_bwd``) and #10
(``fused_mlp_bwd``) without a card, the tile sums behind their ``db1``,
and ``scripts/ab_attention.py``'s handling of the MLP kernels (#2, #9, #4,
#10) on both sides.

The route: with the library and the stream replaced by a recorder, each
wrapper asks the library for its workspace at (M, D, F), makes one call of
its C entry point with the operands' pointers in the order of the C
signature, and counts one launch; what the CUDA kernel does not take
(operands off 16-byte alignment, which its products read by TMA, fp32
operands, D or F not divisible by 32, more than 65535 blocks of 256 rows)
raises before any call.

The sums: on the card the dual tile sums the fp32 dh32 over each 128-row
tile into [ceil(M / 128), F] partials, which a fixed-order pass adds in
tile order. The plain backward sums dh32 over all rows at once; both must
agree with each other to fp32 rounding and with ``jax.vjp`` of the JAX
package's ``ln_mlp`` and ``fused_mlp`` (Pallas kernels in interpret mode)
within the tolerances of ``test_torch_port_fused_block_bwd.py``.
"""
import contextlib
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.ops import fused_block as JFB
from vlp_tpu.ops import fused_mlp as JFM
from vlp_tpu_torch.ops import fused_block as TFB
from vlp_tpu_torch.ops import fused_mlp as TFM

WS_BYTES = 4096
REL = {"fp32": 1e-4, "bf16": 2.0 ** -5}


class _FakeLibrary:
    """Records the backward entry points' arguments in place of the card."""

    def __init__(self):
        self.calls = []

    def _record(self, name, result):
        def call(*args):
            self.calls.append((name, args))
            return result
        return call

    def __getattr__(self, name):
        if name.endswith("_workspace"):
            return self._record("workspace", WS_BYTES)
        if name in ("vlp_ln_mlp_bwd", "vlp_fused_mlp_bwd"):
            return self._record(name, 0)
        raise AttributeError(name)


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLibrary()
    for mod in (TFB, TFM):
        monkeypatch.setattr(mod, "_route", lambda name, x: True)
        monkeypatch.setattr(mod, "_stream", lambda: 7)
        monkeypatch.setattr(mod._build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return lib


def _operands(m, d, f, dtype=torch.bfloat16):
    """x, dy [m, d], w1 [d, f], w2 [f, d] in ``dtype``; gamma, beta [d] and
    b1 [f] fp32."""
    vec = torch.zeros(d)
    return (torch.zeros(m, d, dtype=dtype), torch.zeros(m, d, dtype=dtype),
            torch.zeros(d, f, dtype=dtype), torch.zeros(f, d, dtype=dtype),
            vec, vec + 1.0, torch.zeros(f))


def _ptrs(*tensors):
    return tuple(t.data_ptr() for t in tensors)


SHAPES = [(1568, 96, 384), (33, 384, 1536), (1, 32, 128)]


@pytest.mark.parametrize("m,d,f", SHAPES)
def test_ln_mlp_bwd_cuda_route_passes_its_operands(fake, m, d, f):
    x, dy, w1, w2, g, b, b1 = _operands(m, d, f)
    before = TFB.ln_mlp_bwd.launches
    outs = TFB.ln_mlp_bwd(x, g, b, w1, b1, w2, dy)
    assert TFB.ln_mlp_bwd.launches == before + 1
    dx, dg, db, dw1, db1, dw2, db2 = outs
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert dw1.shape == (d, f) and dw2.shape == (f, d)
    assert dw1.dtype == dw2.dtype == torch.bfloat16
    assert db1.shape == (1, f) and db2.shape == (1, d)
    assert all(t.dtype == torch.float32 for t in (dg, db, db1, db2))
    (what, ws_args), (name, args) = fake.calls
    assert (what, ws_args) == ("workspace", (m, d, f))
    assert name == "vlp_ln_mlp_bwd"
    # x, gamma, beta, w1, b1, w2, dy as given; the cotangents in the order
    # of the C signature; the workspace; then M, D, F, eps, stream
    assert args[:7] == _ptrs(x, g, b, w1, b1, w2, dy)
    assert args[7:14] == _ptrs(*outs)
    assert args[15:18] == (m, d, f)
    assert args[18] == pytest.approx(1e-6) and args[19] == 7


@pytest.mark.parametrize("m,d,f", SHAPES)
def test_fused_mlp_bwd_cuda_route_passes_its_operands(fake, m, d, f):
    x, dy, w1, w2, _, _, b1 = _operands(m, d, f)
    before = TFM.fused_mlp_bwd.launches
    outs = TFM.fused_mlp_bwd(x, w1, b1, w2, dy)
    assert TFM.fused_mlp_bwd.launches == before + 1
    dx, dw1, db1, dw2, db2 = outs
    assert dx.shape == x.shape and dx.dtype == torch.bfloat16
    assert dw1.shape == (d, f) and dw2.shape == (f, d)
    assert db1.shape == (1, f) and db2.shape == (1, d)
    (what, ws_args), (name, args) = fake.calls
    assert (what, ws_args) == ("workspace", (m, d, f))
    assert name == "vlp_fused_mlp_bwd"
    # x, w1, b1, w2, dy; dx, dw1, db1, dw2, db2; the workspace; M, D, F,
    # stream
    assert args[:5] == _ptrs(x, w1, b1, w2, dy)
    assert args[5:10] == _ptrs(*outs)
    assert args[11:14] == (m, d, f) and args[14] == 7


def _misaligned(t):
    """``t``'s values in a buffer 2 bytes off a 16-byte boundary."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


REFUSALS = [("x_misaligned", "16-byte aligned"),
            ("dy_misaligned", "16-byte aligned"),
            ("w1_misaligned", "16-byte aligned"),
            ("w2_misaligned", "16-byte aligned"),
            ("fp32", "bfloat16"),
            ("d48", "divisible by 32"),
            ("f200", "divisible by 32")]


def _refused_operands(case):
    m, d, f = 40, 64, 256
    if case == "d48":
        d = 48
    if case == "f200":
        f = 200
    x, dy, w1, w2, g, b, b1 = _operands(
        m, d, f, torch.float32 if case == "fp32" else torch.bfloat16)
    mis = {"x": x, "dy": dy, "w1": w1, "w2": w2}
    name = case.split("_")[0]
    if case.endswith("misaligned"):
        mis[name] = _misaligned(mis[name])
    return mis["x"], mis["dy"], mis["w1"], mis["w2"], g, b, b1


@pytest.mark.parametrize("case,match", REFUSALS)
def test_ln_mlp_bwd_cuda_route_refuses(fake, case, match):
    x, dy, w1, w2, g, b, b1 = _refused_operands(case)
    before = TFB.ln_mlp_bwd.launches
    with pytest.raises((ValueError, TypeError), match=match):
        TFB.ln_mlp_bwd(x, g, b, w1, b1, w2, dy)
    assert fake.calls == [] and TFB.ln_mlp_bwd.launches == before


@pytest.mark.parametrize("case,match", REFUSALS)
def test_fused_mlp_bwd_cuda_route_refuses(fake, case, match):
    x, dy, w1, w2, _, _, b1 = _refused_operands(case)
    before = TFM.fused_mlp_bwd.launches
    with pytest.raises((ValueError, TypeError), match=match):
        TFM.fused_mlp_bwd(x, w1, b1, w2, dy)
    assert fake.calls == [] and TFM.fused_mlp_bwd.launches == before


def test_backward_row_limit_is_the_partials_grid():
    """65535 blocks of 256 rows pass; one row more raises."""
    TFM.check_bwd_operands("fused_mlp_bwd", 65535 * 256)
    with pytest.raises(ValueError, match="at most 16776960 rows"):
        TFM.check_bwd_operands("fused_mlp_bwd", 65535 * 256 + 1)


def _inputs(seed, m, d):
    rng = np.random.default_rng(seed)
    f = 4 * d
    x = rng.standard_normal((m, d)).astype(np.float32) * 0.5
    dy = rng.standard_normal((m, d)).astype(np.float32)
    return x, dy, [np.asarray(p, np.float32) for p in (
        1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
        rng.standard_normal((d, f)) * d ** -0.5,
        0.5 * rng.standard_normal(f),
        rng.standard_normal((f, d)) * f ** -0.5,
        0.02 * rng.standard_normal(d))]


def _torch(x, dy, params, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt),
            [torch.from_numpy(p).to(tdt if p.ndim == 2 else torch.float32)
             for p in params])


def _tile_sums_in_order(a, w1, b1, w2, dy):
    """db1 as the card forms it: the column sums of the fp32 dh32 (the plain
    backward's own) over each 128-row tile, then added in tile order."""
    dt = a.dtype
    (b1,), (w1, w2) = TFM._cast(dt, vectors=(b1,), matrices=(w1, w2))
    dh32 = TFM.mlp_bwd_core(a, w1, b1, w2, dy.float().to(dt))[0]
    total = torch.zeros(dh32.shape[1], dtype=dh32.dtype)
    for tile in dh32.split(128):
        total = total + tile.sum(0)
    return total.reshape(1, -1)


def _assert_db1(plain, ordered, want, dtype):
    scale = max(np.abs(want).max(), 1e-30)
    # the same fp32 terms in two orders
    assert (plain - ordered).abs().max().item() <= 1e-5 * scale
    for got in (plain, ordered):
        err = np.abs(got.float().numpy().reshape(want.shape) - want).max() \
            / scale
        assert err <= REL[dtype], err


def _jax_db1(fn, args, dy, dtype, index):
    """The cotangent of argument ``index`` (b1) of ``fn`` from jax.vjp."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    _, vjp = jax.vjp(fn, *args)
    return np.asarray(vjp(jnp.asarray(dy, jdt))[index], np.float32)


def _jax_args(x, params, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return [jnp.asarray(x, jdt)] + [
        jnp.asarray(p, jdt if p.ndim == 2 else jnp.float32).reshape(
            p.shape if p.ndim == 2 else (1, -1)) for p in params]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("m,d", [(384, 32), (320, 64)])  # 3 tiles; 2.5
def test_ln_mlp_db1_is_the_tile_sums_in_tile_order(monkeypatch, m, d,
                                                   dtype):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    x, dy, params = _inputs(m + d, m, d)
    want = _jax_db1(JFB.ln_mlp, _jax_args(x, params, dtype), dy, dtype, 4)
    tx, tdy, tp = _torch(x, dy, params, dtype)
    g, b, w1, b1, w2 = tp[:5]
    plain = TFB.ln_mlp_bwd_plain(tx, g, b, w1, b1, w2, tdy)[4]
    (g32, b32), _ = TFB._cast(tx.dtype, vectors=(g, b))
    ln = (TFB._ln_fwd(tx.float())[0] * g32 + b32).to(tx.dtype)
    _assert_db1(plain, _tile_sums_in_order(ln, w1, b1, w2, tdy), want,
                dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("m,d", [(384, 32), (256, 64)])  # JFM.supports
def test_fused_mlp_db1_is_the_tile_sums_in_tile_order(m, d, dtype):
    x, dy, params = _inputs(m + d + 1, m, d)
    _, _, w1, b1, w2, b2 = params
    args = _jax_args(x, (w1, b1, w2, b2), dtype)
    want = _jax_db1(lambda *a: JFM._mlp(*a, True), args, dy, dtype, 2)
    tx, tdy, tp = _torch(x, dy, params, dtype)
    _, _, tw1, tb1, tw2, _ = tp
    plain = TFM.fused_mlp_bwd_plain(tx, tw1, tb1, tw2, tdy)[2]
    _assert_db1(plain, _tile_sums_in_order(tx, tw1, tb1, tw2, tdy), want,
                dtype)


def _ab_script():
    path = Path(__file__).resolve().parents[1] / "scripts" / "ab_attention.py"
    spec = importlib.util.spec_from_file_location("ab_attention", path)
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    return ab


def test_ab_script_serves_the_parents_mlp_backwards():
    """In the parent's turns ``scripts/ab_attention.py`` takes #4's and
    #10's entry points and their workspace queries from the parent's
    library, beside #3's and #6's and the forwards #2 and #9, and every
    other entry point (the dual tile and the forwards' products alone) from
    this tree's."""
    ab = _ab_script()
    names = ("vlp_ln_mlp_bwd", "vlp_ln_mlp_bwd_workspace",
             "vlp_fused_mlp_bwd", "vlp_fused_mlp_bwd_workspace",
             "vlp_ln_attention_bwd", "vlp_ln_mlp", "vlp_fused_mlp")
    own = type("Own", (), {n: "own" for n in names + (
        "vlp_mlp_dual", "vlp_mlp_gemm")})()
    other = type("Other", (), {n: "parent" for n in names})()
    mixed = ab._Mixed(own, other, ab.PARENT_ENTRY_POINTS)
    assert all(getattr(mixed, n) == "parent" for n in names)
    assert mixed.vlp_mlp_dual == mixed.vlp_mlp_gemm == "own"


@pytest.mark.parametrize("name,part", [
    ("void vlp::ln_rows_kernel<4>(...)", "LN rows"),
    ("void vlp::gemm_kernel<true, false, false, 1>(...)", "fc1 + GELU"),
    ("void vlp::gemm_kernel<false, false, false, 1>(...)", "fc1 + GELU"),
    ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::DenseEpi<true>, 128, 3, 2, "
     "__nv_bfloat16>(...)", "fc1 + GELU"),
    ("void vlp::gemm_kernel<false, false, false, 2>(...)",
     "fc2 + bias or residual"),
    ("void vlp::gemm_kernel<false, false, false, 0>(...)",
     "fc2 + bias or residual"),
    ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::DenseEpi<false>, 64, 4, 2, "
     "__nv_bfloat16>(...)", "fc2 + bias or residual"),
    ("Memset (Device)", "other"),
])
def test_ab_script_splits_both_sides_mlp_forwards_into_the_same_parts(name,
                                                                     part):
    """The MLP forwards' split names the same work in the parent's kernels
    (gemm.cuh's <LN, TA, TB, epilogue>: 1 bias + GELU, 2 bias + residual,
    0 bias) and in this tree's (ln_rows, then DenseEpi<GELU or not>)."""
    ab = _ab_script()
    assert next(p for p, pat in ab.MLP_FWD_SPLIT_PARTS
                if re.search(pat, name)) == part


@pytest.mark.parametrize("name,part", [
    ("void vlp::gemm_kernel<false, false, false, 5>(...)", "dual tile"),
    ("void vlp::gemm_kernel<false, false, true, 6>(...)", "dual tile"),
    ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::DualMlp, 64, 2, 2, "
     "__nv_bfloat16>(...)", "dual tile"),
    ("void vlp::gemm_kernel<false, true, false, 3>(...)",
     "dW1 + dW2 GEMMs"),
    ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::ColsTN, 128, 3, 2, "
     "float>(...)", "dW1 + dW2 GEMMs"),
    ("void vlp::gemm_kernel<false, false, true, 3>(...)", "dln / dx GEMM"),
    ("void vlp::gemm_kernel<false, false, true, 4>(...)", "dln / dx GEMM"),
    ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::RowsNT, 128, 3, 2, "
     "float>(...)", "dln / dx GEMM"),
    ("void vlp::wg::wgmma_gemm_kernel<vlp::wg::RowsNT, 128, 3, 2, "
     "__nv_bfloat16>(...)", "dln / dx GEMM"),
    ("void vlp::ln_bwd_rows_kernel<4>(...)", "row passes"),
    ("void vlp::col_partials_kernel<__nv_bfloat16>(...)", "row passes"),
    ("void vlp::reduce_rows_kernel<__nv_bfloat16>(...)", "row passes"),
    ("void vlp::ln_rows_kernel<4>(...)", "row passes"),
    ("Memset (Device)", "other"),
])
def test_ab_script_splits_both_sides_mlp_kernels_into_the_same_parts(name,
                                                                     part):
    """The MLP split's parts name the same work in the parent's kernels
    (gemm.cuh's <LN, TA, TB, epilogue>: 5 bias + GELU and its derivative,
    6 the product with it) and in this tree's (wgmma_gemm.cuh's forms)."""
    ab = _ab_script()
    assert next(p for p, pat in ab.MLP_SPLIT_PARTS if re.search(pat, name)) \
        == part


def _gap_script():
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "gelu_epilogue_gap.py"
    spec = importlib.util.spec_from_file_location("gelu_epilogue_gap", path)
    gap = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gap)
    return gap


@pytest.mark.parametrize("a,b,ulps", [
    (1.0, 1.0, 0), (1.0, 1.0078125, 1), (-1.0, -1.015625, 2),
    (0.0, -0.0, 0), (2.0 ** -133, -(2.0 ** -133), 2)])
def test_gelu_gap_script_counts_bf16_ulps_across_zero(a, b, ulps):
    """``scripts/gelu_epilogue_gap.py`` measures the distance between two
    bf16 values in steps of the format, also across zero."""
    gap = _gap_script()
    x = torch.tensor([a, b], dtype=torch.bfloat16)
    k = gap._ordered(x)
    assert int((k[0] - k[1]).abs()) == ulps


def test_gelu_gap_script_exits_2_without_a_card(monkeypatch, capsys):
    gap = _gap_script()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        gap.main([])
    assert exc.value.code == 2 and capsys.readouterr().out == ""
