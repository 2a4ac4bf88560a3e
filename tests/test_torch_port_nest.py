"""The port's NesT and EncoderBlock against the JAX modules (half-block
kernels in Pallas interpret mode), with the JAX variables carried over by
``vlp_tpu_torch.convert``; plus the converter's refusals.

Tiny NesT of tests/test_fused_block.py (img 16, patch 2, dims (16, 32),
heads (2, 4), depths (1, 1), block 4), fp32 on both sides, atol 5e-5 (the
JAX package's own mega-vs-plain bound). Parameters are perturbed with
numpy noise after init so that biases, LayerNorm scales and position
embeddings are all nonzero and a swapped mapping shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.models import nest as jnest
from vlp_tpu.models.vit import EncoderBlock as JEncoderBlock
from vlp_tpu_torch import convert
from vlp_tpu_torch.models import nest as tnest
from vlp_tpu_torch.models.vit import EncoderBlock

TINY = dict(img_size=16, patch_size=2, embed_dims=(16, 32), num_heads=(2, 4),
            depths=(1, 1), block_size=4)
ATOL = 5e-5


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), jax.device_get(variables))


@pytest.fixture
def tiny_nest(monkeypatch):
    """(JAX variables, numpy input, JAX features) of the tiny NesT."""
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    x = np.random.default_rng(22).standard_normal((4, 16, 16, 3)).astype(
        np.float32)
    model = jnest.NesT(dtype=jnp.float32, **TINY)
    variables = _perturbed(model.init(jax.random.key(0), jnp.asarray(x)), 1)
    want = np.asarray(model.apply(variables, jnp.asarray(x)))
    return variables, x, want


def test_tiny_nest_matches_jax(tiny_nest):
    variables, x, want = tiny_nest
    model = tnest.NesT(dtype=torch.float32, **TINY)
    convert.load_weights(model, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("batch", [4, 6])
def test_tiny_nest_unfused_matches_jax(monkeypatch, batch):
    """``megakernel=False``: the unfused blocks, ``attend_qkv`` at every
    level and ``fused_mlp`` where the rows divide into a tile (batch 4: both
    levels; batch 6: level 0, with level 1's 96 rows on Dense -> GELU ->
    Dense)."""
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    x = np.random.default_rng(23).standard_normal(
        (batch, 16, 16, 3)).astype(np.float32)
    jmodel = jnest.NesT(dtype=jnp.float32, megakernel=False, **TINY)
    variables = _perturbed(jmodel.init(jax.random.key(0), jnp.asarray(x)), 4)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model = tnest.NesT(dtype=torch.float32, megakernel=False, **TINY)
    convert.load_weights(model, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,s,d,heads", [(8, 16, 32, 2), (2, 196, 64, 2)])
def test_encoder_block_matches_jax(monkeypatch, n, s, d, heads):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    x = (np.random.default_rng(n + s).standard_normal((n, s, d)) * 0.5
         ).astype(np.float32)
    jblock = JEncoderBlock(num_heads=heads, dtype=jnp.float32)
    variables = _perturbed(jblock.init(jax.random.key(0), jnp.asarray(x)), 2)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x)))
    block = EncoderBlock(d, heads)
    convert.load_weights(block, variables)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_blockify_matches_jax_and_round_trips():
    x = np.random.default_rng(5).standard_normal((2, 8, 12, 3)).astype(
        np.float32)
    t = tnest.blockify(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jnest.blockify(jnp.asarray(x), 4)))
    assert t.shape == (2, 6, 16, 3)
    np.testing.assert_array_equal(
        tnest.unblockify(t, 4, 8, 12).numpy(), x)


def test_converter_rejects_missing_leftover_and_misshaped_keys(tiny_nest):
    variables, _, _ = tiny_nest
    flat = convert.flatten(variables)
    model = tnest.NesT(dtype=torch.float32, **TINY)

    missing = dict(flat)
    del missing["params/l1_block0/mlp/fc2/bias"]
    with pytest.raises(KeyError, match=r"levels\.1\.0\.mlp\.fc2\.bias"):
        convert.load_weights(model, missing)

    leftover = dict(flat, **{"params/l1_block1/ln1/scale": np.ones(32)})
    with pytest.raises(KeyError, match="l1_block1/ln1/scale"):
        convert.load_weights(model, leftover)

    misshaped = dict(flat)
    misshaped["params/pool0/conv/kernel"] = np.zeros((3, 3, 16, 31))
    with pytest.raises(ValueError, match="pool0/conv/kernel"):
        convert.load_weights(model, misshaped)


def test_converter_maps_flax_paths():
    assert convert.torch_key("params/backbone/l2_block19/attn/qkv/kernel") \
        == "backbone.levels.2.19.attn.qkv.weight"
    assert convert.torch_key("params/backbone/pool1/norm/scale") \
        == "backbone.pools.1.norm.weight"
    assert convert.torch_key("params/backbone/pos_embed_0") \
        == "backbone.pos_embed_0"
    assert convert.torch_key("params/head/bias") == "head.bias"
