"""The port's half-block plain versions (``vlp_tpu_torch.ops.fused_block``)
against the JAX package's Pallas kernels run in interpret mode on the CPU.

The same numpy inputs go to both sides. fp32 comparisons use atol 5e-5, the
JAX package's own mega-vs-plain bound (tests/test_fused_block.py). The bf16
cases allow two bf16 ulps at the largest |y| (< 4 here, so 2^-5): both sides
round to bf16 at the same five points, but XLA:CPU and PyTorch sum in
different orders, which can flip a rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.ops import fused_block as JFB
from vlp_tpu_torch.ops import fused_block as TFB

FP32_ATOL = 5e-5
BF16_ATOL = 2.0 ** -5


def _attn_inputs(seed, n, s, d, row_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, s, d)).astype(np.float32) * 0.5
    x[:, 0] *= row_scale
    return x, (1.0 + 0.1 * rng.standard_normal(d),
               0.1 * rng.standard_normal(d),
               rng.standard_normal((d, 3 * d)) * d ** -0.5,
               0.02 * rng.standard_normal(3 * d),
               rng.standard_normal((d, d)) * d ** -0.5,
               0.02 * rng.standard_normal(d))


def _mlp_inputs(seed, m, d, row_scale=1.0):
    rng = np.random.default_rng(seed)
    f = 4 * d
    x = rng.standard_normal((m, d)).astype(np.float32) * 0.5
    x[0] *= row_scale
    return x, (1.0 + 0.1 * rng.standard_normal(d),
               0.1 * rng.standard_normal(d),
               rng.standard_normal((d, f)) * d ** -0.5,
               0.02 * rng.standard_normal(f),
               rng.standard_normal((f, d)) * f ** -0.5,
               0.02 * rng.standard_normal(d))


def _both(x, params, dtype):
    """(jax x, jax params, torch x, torch params) from numpy; weights in
    ``dtype`` (as the model hands them to the kernels), the rest fp32."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = [jnp.asarray(p, jdt if p.ndim == 2 else jnp.float32)
          for p in params]
    tp = [torch.from_numpy(np.asarray(p, np.float32)).to(
        tdt if p.ndim == 2 else torch.float32) for p in params]
    return (jnp.asarray(x, jdt), jp, torch.from_numpy(x).to(tdt), tp)


@pytest.mark.parametrize("n,s,d,heads,row_scale,dtype", [
    (4, 16, 32, 2, 1.0, "fp32"),
    (3, 196, 64, 2, 1.0, "fp32"),     # NesT's S = 196 with Dh = 32
    (2, 196, 96, 3, 1.0, "fp32"),     # NesT-Small level 0 width
    (4, 16, 32, 1, 30.0, "fp32"),     # rows x30: softmax max, LN variance
    (2, 196, 64, 2, 1.0, "bf16"),
])
def test_ln_attention_plain_matches_jax_kernel(monkeypatch, n, s, d, heads,
                                               row_scale, dtype):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    x, params = _attn_inputs(n * 100 + s, n, s, d, row_scale)
    jx, jp, tx, tp = _both(x, params, dtype)
    want = np.asarray(JFB.ln_attention(jx, *jp, heads), np.float32)
    got = TFB.ln_attention_plain(tx, *tp, heads)
    assert got.dtype == tx.dtype
    atol = BF16_ATOL if dtype == "bf16" else FP32_ATOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    # a CPU tensor routes the public wrapper to the plain version
    assert torch.equal(TFB.ln_attention(tx, *tp, heads), got)


@pytest.mark.parametrize("m,d,row_scale,dtype", [
    (128, 32, 1.0, "fp32"),
    (256, 96, 1.0, "fp32"),
    (64, 64, 30.0, "fp32"),
    (128, 64, 1.0, "bf16"),
])
def test_ln_mlp_plain_matches_jax_kernel(monkeypatch, m, d, row_scale,
                                         dtype):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    x, params = _mlp_inputs(m + d, m, d, row_scale)
    jx, jp, tx, tp = _both(x, params, dtype)
    want = np.asarray(JFB.ln_mlp(jx, *jp), np.float32)
    got = TFB.ln_mlp_plain(tx, *tp)
    assert got.dtype == tx.dtype
    atol = BF16_ATOL if dtype == "bf16" else FP32_ATOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    assert torch.equal(TFB.ln_mlp(tx, *tp), got)


def test_gelu_matches_jax_exact_gelu():
    z = np.concatenate([np.linspace(-8.0, 8.0, 4001),
                        np.random.default_rng(0).standard_normal(4000) * 3]
                       ).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(z), approximate=False))
    got = TFB.gelu(torch.from_numpy(z)).numpy()
    # A&S 7.1.26 erf is within 1.5e-7 of erf; times |z|/2 <= 4, plus fp32
    # rounding of the polynomial
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_unsupported_device_raises_instead_of_falling_back():
    d = 32
    x = torch.zeros(2, 16, d, device="meta")
    v = torch.zeros(d, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        TFB.ln_attention(x, v, v, torch.zeros(d, 3 * d, device="meta"),
                         torch.zeros(3 * d, device="meta"),
                         torch.zeros(d, d, device="meta"), v, 1)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        TFB.ln_mlp(x.reshape(-1, d), v, v,
                   torch.zeros(d, 4 * d, device="meta"),
                   torch.zeros(4 * d, device="meta"),
                   torch.zeros(4 * d, d, device="meta"), v)
