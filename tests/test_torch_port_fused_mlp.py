"""The port's fused MLP (``vlp_tpu_torch.ops.fused_mlp``) against the JAX
package's Pallas kernel ``_mlp`` run in interpret mode on the CPU (forward,
and backward against ``jax.vjp`` through the Pallas VJP); ``MlpBlock`` on
both sides at a row count where the kernel does not run; and the port's
path predicates against the JAX ones on every shape the experiments give.

Tolerances as in test_torch_port_fused_block.py: fp32 atol 5e-5 of the
values' scale, bf16 2^-5 (two bf16 ulps at values below 4; both sides round
at the same points and differ in the order of the fp32 sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.models.vit import MlpBlock as JMlpBlock
from vlp_tpu.ops import fused_block as JFB
from vlp_tpu.ops import fused_mlp as JFM
from vlp_tpu_torch import convert
from vlp_tpu_torch.models.vit import MlpBlock
from vlp_tpu_torch.ops import fused_block as TFB
from vlp_tpu_torch.ops import fused_mlp as TFM

FP32_ATOL = 5e-5
BF16_ATOL = 2.0 ** -5


def _inputs(seed, m, d):
    rng = np.random.default_rng(seed)
    f = 4 * d
    return (rng.standard_normal((m, d)).astype(np.float32) * 0.5,
            rng.standard_normal((d, f)) * d ** -0.5,
            0.02 * rng.standard_normal(f),
            rng.standard_normal((f, d)) * f ** -0.5,
            0.02 * rng.standard_normal(d),
            rng.standard_normal((m, d)).astype(np.float32))


@pytest.mark.parametrize("m,d,dtype", [(128, 32, "fp32"), (256, 96, "fp32"),
                                       (64, 64, "bf16"), (512, 32, "bf16")])
def test_fused_mlp_plain_matches_jax_kernel(m, d, dtype):
    x, w1, b1, w2, b2, dy = _inputs(m + d, m, d)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    assert JFM.supports(m, d, 4 * d, jnp.dtype(jdt).itemsize)
    jargs = (jnp.asarray(x, jdt), jnp.asarray(w1, jdt),
             jnp.asarray(b1, jnp.float32).reshape(1, -1),
             jnp.asarray(w2, jdt), jnp.asarray(b2, jnp.float32).reshape(1, -1))
    want, vjp = jax.vjp(lambda *a: JFM._mlp(*a, True), *jargs)
    want_grads = vjp(jnp.asarray(dy, jdt))
    targs = [torch.from_numpy(np.asarray(a, np.float32)) for a in
             (x, w1, b1, w2, b2)]
    targs = [a.to(tdt) if a.ndim == 2 else a for a in targs]
    got = TFM.fused_mlp_plain(*targs)
    assert got.dtype == tdt
    atol = BF16_ATOL if dtype == "bf16" else FP32_ATOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol, rtol=0)
    assert torch.equal(TFM.fused_mlp(*targs), got)  # CPU: the plain version
    grads = TFM.fused_mlp_bwd_plain(targs[0], targs[1], targs[2], targs[3],
                                    torch.from_numpy(dy).to(tdt))
    assert torch.equal(TFM.fused_mlp_bwd(targs[0], targs[1], targs[2],
                                         targs[3],
                                         torch.from_numpy(dy).to(tdt))[0],
                       grads[0])
    # (dx, dw1, db1, dw2, db2); jax's are for (x, w1, b1, w2, b2)
    for i, g in enumerate(grads):
        w = np.asarray(want_grads[i], np.float32)
        assert g.dtype == (tdt if i in (0, 1, 3) else torch.float32)
        np.testing.assert_allclose(g.float().numpy().reshape(w.shape), w,
                                   atol=atol * max(1.0, np.abs(w).max()),
                                   rtol=0, err_msg=str(i))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_block_where_the_kernel_does_not_run(monkeypatch, dtype):
    """96 rows: no 64-multiple tile divides them, so both packages take
    Dense -> exact GELU -> Dense (the JAX side with Pallas interpret on)."""
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    m, d = 96, 64
    assert not JFM.supports(m, d, 4 * d) and not TFM.supports(m, d, 4 * d)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, m // 2, d)) * 2.0).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jblock = JMlpBlock(4 * d, dtype=jdt)
    variables = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32),
        jax.device_get(jblock.init(jax.random.key(0), jnp.asarray(x, jdt))))
    want = np.asarray(jblock.apply(variables, jnp.asarray(x, jdt)),
                      np.float32)
    block = MlpBlock(d, 4 * d)
    convert.load_weights(block, variables)
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    # bf16: the two Dense products sum in other orders, one bf16 ulp of
    # |y| < 4 either side of a rounding
    atol = BF16_ATOL if dtype == "bf16" else FP32_ATOL
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


# (n, s, d, heads) of the blocks each experiment runs: NesT-Small's three
# levels at batch 8, 32 and 64, ViT-B and ViT-L at batch 32 and 64, and the
# tiny test models
_NEST = [(b * nb, 196, d, h) for b in (8, 32, 64)
         for nb, d, h in ((16, 96, 3), (4, 192, 6), (1, 384, 12))]
_VIT = [(b, 197, d, h) for b in (32, 64) for d, h in ((768, 12), (1024, 16))]
_TINY = [(4 * 4, 16, 16, 2), (4, 16, 32, 4), (6 * 4, 16, 16, 2),
         (6, 16, 32, 4), (4, 17, 128, 2), (2, 17, 768, 12), (8, 16, 32, 2),
         (2, 196, 64, 2)]


@pytest.mark.parametrize("itemsize", [2, 4])
def test_path_predicates_equal_the_jax_ones(itemsize):
    for n, s, d, h in _NEST + _VIT + _TINY:
        f, m = 4 * d, n * s
        assert TFB.supports_attn(n, s, d, h, itemsize) == \
            JFB.supports_attn(n, s, d, h, itemsize), (n, s, d, h)
        assert TFB.supports_mlp(m, d, f, itemsize) == \
            JFB.supports_mlp(m, d, f, itemsize), (m, d)
        assert TFM.supports(m, d, f, itemsize) == \
            JFM.supports(m, d, f, itemsize), (m, d)
    if itemsize == 2:
        # the dispatch the slice relies on: NesT-Small at batch 64 keeps the
        # half-block kernels and the fused MLP at every level; ViT-B/L take
        # neither; batch 8 loses NesT's level-2 half-block MLP
        for n, s, d, h in _NEST[-3:]:
            assert TFB.supports_attn(n, s, d, h) and \
                TFB.supports_mlp(n * s, d, 4 * d) and \
                TFM.supports(n * s, d, 4 * d)
        for n, s, d, h in _VIT:
            assert not TFB.supports_attn(n, s, d, h)
            assert not TFB.supports_mlp(n * s, d, 4 * d)
            assert not TFM.supports(n * s, d, 4 * d)
        assert not TFB.supports_mlp(8 * 196, 384, 1536)
