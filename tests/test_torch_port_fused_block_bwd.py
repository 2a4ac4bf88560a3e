"""The port's half-block backwards (``vlp_tpu_torch.ops.fused_block``)
against ``jax.vjp`` of the JAX package's ``ln_attention``/``ln_mlp``, whose
custom VJPs run the Pallas backward kernels in interpret mode on the CPU.

The same numpy inputs and cotangent go to both sides; all seven cotangents
are compared. Tolerances, relative to each output's largest |value|:

- fp32: 1e-4. Both sides compute the same fp32 formulas; they differ in
  summation order (the Pallas grid sums weight gradients program by
  program, the port in one matmul), about 1e-6 relative per sum, and the
  LN backward subtracts means of similar size, which can lose a decade.
- bf16: 2^-5. Both round at the same points (ln, qkv, p, dov, ds, dqkv, h,
  dh, dx, weight gradients); a different fp32 summation order can flip a
  bf16 rounding of an intermediate (2^-8 relative), which then moves the
  sums downstream of it by a few such ulps.

The CPU ``autograd.Function`` must return exactly the plain backward, and
the plain backward in float64 (with the exact erf, so the GELU derivative
is exact) must equal autograd through the plain forward to 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.ops import fused_block as JFB
from vlp_tpu_torch.ops import _common
from vlp_tpu_torch.ops import fused_block as TFB

REL = {"fp32": 1e-4, "bf16": 2.0 ** -5}


def _attn_inputs(seed, n, s, d, row_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, s, d)).astype(np.float32) * 0.5
    x[:, 0] *= row_scale
    dy = rng.standard_normal((n, s, d)).astype(np.float32)
    return x, dy, [np.asarray(p, np.float32) for p in (
        1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
        rng.standard_normal((d, 3 * d)) * d ** -0.5,
        0.02 * rng.standard_normal(3 * d),
        rng.standard_normal((d, d)) * d ** -0.5,
        0.02 * rng.standard_normal(d))]


def _mlp_inputs(seed, m, d, row_scale=1.0):
    rng = np.random.default_rng(seed)
    f = 4 * d
    x = rng.standard_normal((m, d)).astype(np.float32) * 0.5
    x[0] *= row_scale
    dy = rng.standard_normal((m, d)).astype(np.float32)
    return x, dy, [np.asarray(p, np.float32) for p in (
        1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
        rng.standard_normal((d, f)) * d ** -0.5,
        0.02 * rng.standard_normal(f),
        rng.standard_normal((f, d)) * f ** -0.5,
        0.02 * rng.standard_normal(d))]


def _jax_vjp(fn, x, dy, params, dtype):
    """Cotangents of (x, *params) from jax.vjp; weights in ``dtype`` as the
    model hands them over, the rest fp32 [1, n] as the wrapper casts."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jp = [jnp.asarray(p, jdt if p.ndim == 2 else jnp.float32).reshape(
        p.shape if p.ndim == 2 else (1, -1)) for p in params]
    _, vjp = jax.vjp(fn, jnp.asarray(x, jdt), *jp)
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(dy, jdt))]


def _torch(x, dy, params, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tp = [torch.from_numpy(p).to(tdt if p.ndim == 2 else torch.float32)
          for p in params]
    return torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt), tp


def _assert_close(got, want, dtype, names):
    for name, g, w in zip(names, got, want):
        g = g.float().numpy().reshape(w.shape)
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max() / scale
        assert err <= REL[dtype], f"{name}: {err:.3g} > {REL[dtype]}"


ATTN_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwout", "dbout")
MLP_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("n,s,d,heads,row_scale,dtype", [
    (4, 16, 32, 2, 1.0, "fp32"),
    (2, 196, 64, 2, 1.0, "fp32"),     # NesT's S = 196 with Dh = 32
    (4, 16, 32, 1, 30.0, "fp32"),     # rows x30: softmax max, LN variance
    (2, 196, 64, 2, 1.0, "bf16"),
    (4, 16, 32, 1, 30.0, "bf16"),
])
def test_ln_attention_bwd_plain_matches_jax_vjp(monkeypatch, n, s, d, heads,
                                                row_scale, dtype):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    x, dy, params = _attn_inputs(n * 100 + s, n, s, d, row_scale)
    want = _jax_vjp(
        lambda x_, g, b, wq, bq, wo, bo: JFB.ln_attention(
            x_, g, b, wq, bq, wo, bo, heads),
        x, dy, params, dtype)
    tx, tdy, tp = _torch(x, dy, params, dtype)
    got = TFB.ln_attention_bwd_plain(tx, *tp[:5], tdy, heads)
    assert got[0].dtype == tx.dtype and got[3].dtype == tx.dtype
    assert got[1].dtype == torch.float32 and got[1].shape == (1, d)
    _assert_close(got, want, dtype, ATTN_NAMES)


@pytest.mark.parametrize("m,d,row_scale,dtype", [
    (128, 32, 1.0, "fp32"),
    (256, 96, 1.0, "fp32"),
    (64, 64, 30.0, "fp32"),
    (128, 64, 1.0, "bf16"),
    (64, 32, 30.0, "bf16"),
])
def test_ln_mlp_bwd_plain_matches_jax_vjp(monkeypatch, m, d, row_scale,
                                          dtype):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    x, dy, params = _mlp_inputs(m + d, m, d, row_scale)
    want = _jax_vjp(JFB.ln_mlp, x, dy, params, dtype)
    tx, tdy, tp = _torch(x, dy, params, dtype)
    got = TFB.ln_mlp_bwd_plain(tx, *tp[:5], tdy)
    assert got[0].dtype == tx.dtype and got[3].dtype == tx.dtype
    assert got[4].dtype == torch.float32 and got[4].shape == (1, 4 * d)
    _assert_close(got, want, dtype, MLP_NAMES)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_autograd_function_equals_plain_backward(dtype):
    """Autograd through the public wrappers on CPU tensors runs the plain
    backward, bit for bit, and returns gradients to fp32 parameters."""
    x, dy, params = _attn_inputs(7, 3, 16, 64)
    tx, tdy, _ = _torch(x, dy, params, dtype)
    leaves = [torch.from_numpy(p).requires_grad_() for p in params]
    xl = tx.clone().requires_grad_()
    TFB.ln_attention(xl, *leaves, 2).backward(tdy)
    want = TFB.ln_attention_bwd_plain(tx, *[p.detach() for p in leaves[:5]],
                                      tdy, 2)
    assert torch.equal(xl.grad, want[0])
    for leaf, w in zip(leaves, want[1:]):
        assert leaf.grad.dtype == torch.float32
        assert torch.equal(leaf.grad, w.float().reshape(leaf.shape))

    x, dy, params = _mlp_inputs(8, 96, 32)
    tx, tdy, _ = _torch(x, dy, params, dtype)
    leaves = [torch.from_numpy(p).requires_grad_() for p in params]
    xl = tx.clone().requires_grad_()
    TFB.ln_mlp(xl, *leaves).backward(tdy)
    want = TFB.ln_mlp_bwd_plain(tx, *[p.detach() for p in leaves[:5]], tdy)
    assert torch.equal(xl.grad, want[0])
    for leaf, w in zip(leaves, want[1:]):
        assert torch.equal(leaf.grad, w.float().reshape(leaf.shape))


def test_plain_backward_is_the_derivative_of_the_plain_forward(monkeypatch):
    """In float64 nothing rounds, so the hand-written backward must be the
    exact derivative of the forward (erf made exact on both sides)."""
    monkeypatch.setattr(_common, "_erf", torch.erf)  # the gelu family's erf
    rng = np.random.default_rng(3)
    f64 = lambda *s: torch.from_numpy(rng.standard_normal(s))  # noqa: E731
    d = 32
    x = f64(2, 10, d) * 0.5
    dy = f64(2, 10, d)
    attn = [1 + 0.1 * f64(d), 0.1 * f64(d), f64(d, 3 * d) * d ** -0.5,
            0.02 * f64(3 * d), f64(d, d) * d ** -0.5, 0.02 * f64(d)]
    leaves = [t.clone().requires_grad_() for t in [x] + attn]
    TFB.ln_attention_plain(*leaves, 2).backward(dy)
    got = TFB.ln_attention_bwd_plain(x, *attn[:5], dy, 2)
    for leaf, g in zip(leaves, got):
        np.testing.assert_allclose(g.reshape(leaf.shape).numpy(),
                                   leaf.grad.numpy(), rtol=0, atol=1e-9)

    rows = x.reshape(-1, d)
    drows = dy.reshape(-1, d)
    mlp = [1 + 0.1 * f64(d), 0.1 * f64(d), f64(d, 4 * d) * d ** -0.5,
           0.02 * f64(4 * d), f64(4 * d, d) * (4 * d) ** -0.5,
           0.02 * f64(d)]
    leaves = [t.clone().requires_grad_() for t in [rows] + mlp]
    TFB.ln_mlp_plain(*leaves).backward(drows)
    got = TFB.ln_mlp_bwd_plain(rows, *mlp[:5], drows)
    for leaf, g in zip(leaves, got):
        np.testing.assert_allclose(g.reshape(leaf.shape).numpy(),
                                   leaf.grad.numpy(), rtol=0, atol=1e-9)


def test_gelu_grad_matches_jax():
    from vlp_tpu.ops.fused_mlp import _gelu_and_grad, _gelu_grad

    z = np.linspace(-8.0, 8.0, 4001).astype(np.float32)
    jh, jg = (np.asarray(a) for a in _gelu_and_grad(jnp.asarray(z)))
    th, tg = TFB.gelu_and_grad(torch.from_numpy(z))
    # same formulas in fp32; exp differs by an ulp between XLA and torch
    np.testing.assert_allclose(th.numpy(), jh, atol=2e-6, rtol=0)
    np.testing.assert_allclose(tg.numpy(), jg, atol=2e-6, rtol=0)
    np.testing.assert_allclose(TFB.gelu_grad(torch.from_numpy(z)).numpy(),
                               np.asarray(_gelu_grad(jnp.asarray(z))),
                               atol=2e-6, rtol=0)
