"""The port's windowed half-block path (NesT with ``nhwc_windows=True``)
against the JAX package, whose ``ln_attention_windows`` runs the Pallas
kernels ``_lnattn_nhwc_fwd``/``_lnattn_nhwc_bwd`` in interpret mode on the
CPU. The same numpy inputs go to both sides.

- The plain forward and backward (``ln_attention_windows_plain``,
  ``ln_attention_windows_bwd_plain``) against ``ln_attention_windows`` and
  ``jax.vjp`` of it, all seven cotangents, at one small map (block 4, two
  windows per strip) and one at NesT's block 14 with head dim 32. fp32 within
  5e-5 of each output's scale (max(1, max|value|)): the JAX package's
  mega-vs-plain bound, and the backward's sums over the map grow with it.
  bf16 within 2^-5 of it: both sides round at the same points, and a
  different fp32 summation order can flip a rounding of an intermediate
  (test_torch_port_fused_block_bwd.py).
- ``EncoderBlock`` on a [B, H, W, D] map against the JAX block with
  ``window=``, where ``supports_mlp`` holds (``ln_mlp``) and where it fails
  (LayerNorm -> ``MlpBlock``), fp32 at 5e-5.
- The tiny NesT of tests/test_fused_block.py with ``nhwc_windows=True``:
  features within 5e-5 and every parameter gradient within 1e-4 of its
  largest |g| (fp32 sums in other orders, as test_torch_port_vit.py) of
  ``jax.grad``; and against the port's own blockified path on the same
  weights, which computes the same windows in another layout: the same
  features bit for bit.
- ``supports_window`` equal to the JAX predicate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.models import nest as jnest
from vlp_tpu.models.vit import EncoderBlock as JEncoderBlock
from vlp_tpu.ops import fused_block as JFB
from vlp_tpu_torch import convert
from vlp_tpu_torch.models import nest as tnest
from vlp_tpu_torch.models.vit import EncoderBlock
from vlp_tpu_torch.ops import fused_block as TFB

REL = {"fp32": 5e-5, "bf16": 2.0 ** -5}
GRAD_REL = 1e-4
TINY = dict(img_size=16, patch_size=2, embed_dims=(16, 32), num_heads=(2, 4),
            depths=(1, 1), block_size=4)
# (B, H, W, D, block, heads): two windows per strip at block 4, heads of 16;
# NesT's block 14 (S 196) with heads of 32, two windows per strip
SHAPES = [(4, 8, 8, 32, 4, 2), (2, 14, 28, 64, 14, 2)]
ATTN_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbqkv", "dwout", "dbout")


def _inputs(seed, b, h, w, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, d)).astype(np.float32) * 0.5
    dy = rng.standard_normal((b, h, w, d)).astype(np.float32)
    return x, dy, [np.asarray(p, np.float32) for p in (
        1.0 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d),
        rng.standard_normal((d, 3 * d)) * d ** -0.5,
        0.02 * rng.standard_normal(3 * d),
        rng.standard_normal((d, d)) * d ** -0.5,
        0.02 * rng.standard_normal(d))]


def _both(x, dy, params, dtype):
    """(jax x, dy, params, torch x, dy, params); weights in ``dtype`` as
    the model hands them to the kernels, the rest fp32."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = [jnp.asarray(p, jdt if p.ndim == 2 else jnp.float32) for p in params]
    tp = [torch.from_numpy(p).to(tdt if p.ndim == 2 else torch.float32)
          for p in params]
    return (jnp.asarray(x, jdt), jnp.asarray(dy, jdt), jp,
            torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt), tp)


def _assert_close(got, want, rel, name):
    got = np.asarray(got, np.float32).reshape(want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, f"{name}: {err:.3g} > {rel}"


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,w,d,block,heads", SHAPES)
def test_plain_forward_matches_jax(monkeypatch, b, h, w, d, block, heads,
                                   dtype):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    assert JFB.supports_window(b, h, w, d, heads, block, 4)
    x, _, params = _inputs(b * h + w + d, b, h, w, d)
    jx, _, jp, tx, _, tp = _both(x, x, params, dtype)
    want = np.asarray(JFB.ln_attention_windows(jx, block, *jp, heads),
                      np.float32)
    got = TFB.ln_attention_windows_plain(tx, block, *tp, heads)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_close(got.float().numpy(), want, REL[dtype], "y")
    # a CPU tensor routes the public wrapper to the plain version
    assert torch.equal(TFB.ln_attention_windows(tx, block, *tp, heads), got)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,w,d,block,heads", SHAPES)
def test_plain_backward_matches_jax_vjp(monkeypatch, b, h, w, d, block,
                                        heads, dtype):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    x, dy, params = _inputs(b * h + w + d + 1, b, h, w, d)
    jx, jdy, jp, tx, tdy, tp = _both(x, dy, params, dtype)
    _, vjp = jax.vjp(
        lambda x_, g, bt, wq, bq, wo, bo: JFB.ln_attention_windows(
            x_, block, g, bt, wq, bq, wo, bo, heads), jx, *jp)
    want = [np.asarray(g, np.float32) for g in vjp(jdy)]
    got = TFB.ln_attention_windows_bwd_plain(tx, block, *tp[:5], tdy, heads)
    assert got[0].shape == tx.shape and got[0].dtype == tx.dtype
    assert got[3].dtype == tx.dtype and got[4].shape == (1, 3 * d)
    for name, g, w_ in zip(ATTN_NAMES, got, want):
        _assert_close(g.float().numpy(), w_, REL[dtype], name)

    # autograd through the public wrapper runs the plain backward, bit for
    # bit, and returns the gradients to fp32 parameters
    leaves = [torch.from_numpy(p).requires_grad_() for p in params]
    xl = tx.clone().requires_grad_()
    TFB.ln_attention_windows(xl, block, *leaves, heads).backward(tdy)
    want_t = TFB.ln_attention_windows_bwd_plain(
        tx, block, *[p.detach() for p in leaves[:5]], tdy, heads)
    assert torch.equal(xl.grad, want_t[0])
    for leaf, w_ in zip(leaves, want_t[1:]):
        assert leaf.grad.dtype == torch.float32
        assert torch.equal(leaf.grad, w_.float().reshape(leaf.shape))


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), jax.device_get(variables))


@pytest.mark.parametrize("b,h,w,fused_mlp", [
    (4, 8, 8, True),    # 256 rows: supports_mlp holds, ln_mlp
    (3, 8, 4, False),   # 96 rows: LayerNorm -> MlpBlock -> residual
])
def test_encoder_block_on_the_map_matches_jax(monkeypatch, b, h, w,
                                              fused_mlp):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    d, heads, block = 32, 2, 4
    assert TFB.supports_mlp(b * h * w, d, 4 * d, 4) == fused_mlp == \
        JFB.supports_mlp(b * h * w, d, 4 * d, 4)
    x = (np.random.default_rng(b * h * w).standard_normal((b, h, w, d))
         * 0.5).astype(np.float32)
    jblock = JEncoderBlock(num_heads=heads, dtype=jnp.float32, window=block)
    variables = _perturbed(jblock.init(jax.random.key(0), jnp.asarray(x)), 2)
    want = np.asarray(jblock.apply(variables, jnp.asarray(x)))
    block_t = EncoderBlock(d, heads, window=block)
    convert.load_weights(block_t, variables)
    calls = []
    monkeypatch.setattr(TFB, "ln_mlp_plain", lambda *a, _f=TFB.ln_mlp_plain:
                        calls.append(1) or _f(*a))
    with torch.no_grad():
        got = block_t(torch.from_numpy(x)).numpy()
    assert bool(calls) == fused_mlp
    np.testing.assert_allclose(got, want, atol=REL["fp32"], rtol=0)


@pytest.fixture
def tiny_nest_nhwc(monkeypatch):
    """(JAX variables, numpy input and cotangent, JAX features and
    gradients) of the tiny NesT with ``nhwc_windows=True``."""
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(22)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    ct = rng.standard_normal((4, 32)).astype(np.float32)
    model = jnest.NesT(dtype=jnp.float32, nhwc_windows=True, **TINY)
    variables = _perturbed(model.init(jax.random.key(0), jnp.asarray(x)), 1)

    def loss(params):
        return jnp.sum(model.apply({"params": params}, jnp.asarray(x))
                       * jnp.asarray(ct))

    feats = np.asarray(model.apply(variables, jnp.asarray(x)))
    grads = jax.device_get(jax.grad(loss)(variables["params"]))
    return variables, x, ct, feats, grads


def _port_nest(variables, nhwc):
    model = tnest.NesT(dtype=torch.float32, nhwc_windows=nhwc, **TINY)
    convert.load_weights(model, variables)
    return model


def _feats_and_grads(model, x, ct):
    model.zero_grad(set_to_none=True)
    feats = model(torch.from_numpy(x))
    (feats * torch.from_numpy(ct)).sum().backward()
    return feats.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_tiny_nest_nhwc_features_and_gradients_match_jax(tiny_nest_nhwc,
                                                         monkeypatch):
    variables, x, ct, want_feats, jgrads = tiny_nest_nhwc
    model = _port_nest(variables, nhwc=True)
    assert all(model._level_uses_nhwc(torch.zeros(4, s, s, d), li)
               for li, (s, d) in enumerate(((8, 16), (4, 32))))
    # one windowed half block per level, forward and back
    calls = []
    for name in ("ln_attention_windows_plain",
                 "ln_attention_windows_bwd_plain"):
        monkeypatch.setattr(TFB, name, lambda *a, _f=getattr(TFB, name),
                            _n=name: calls.append(_n) or _f(*a))
    feats, grads = _feats_and_grads(model, x, ct)
    assert sorted(calls) == ["ln_attention_windows_bwd_plain"] * 2 + \
        ["ln_attention_windows_plain"] * 2
    np.testing.assert_allclose(feats.numpy(), want_feats, atol=REL["fp32"],
                               rtol=0)
    want = convert.state_dict_from_flax({"params": jgrads}, model)
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = want[name].abs().max().item()
        assert (g - want[name]).abs().max().item() <= \
            GRAD_REL * max(scale, 1e-12), name


def test_tiny_nest_nhwc_equals_the_blockified_path(tiny_nest_nhwc):
    """The same weights through both of the port's paths. The plain
    windowed version blockifies inside, so the features and every gradient
    outside the MLP halves are bit-equal; ``ln_mlp``'s weight and bias
    gradients sum the map's rows in another order (within 1e-6 of the
    largest |g|: fp32 sums of the same terms)."""
    variables, x, ct, _, _ = tiny_nest_nhwc
    model = _port_nest(variables, nhwc=True)
    feats_w, grads_w = _feats_and_grads(model, x, ct)
    model.nhwc_windows = False
    assert not model._level_uses_nhwc(torch.zeros(4, 8, 8, 16), 0)
    feats_b, grads_b = _feats_and_grads(model, x, ct)
    assert torch.equal(feats_w, feats_b)
    for name, g in grads_w.items():
        if ".mlp." in name or ".ln2." in name:
            scale = grads_b[name].abs().max().item()
            assert (g - grads_b[name]).abs().max().item() <= \
                1e-6 * max(scale, 1e-12), name
        else:
            assert torch.equal(g, grads_b[name]), name


@pytest.mark.parametrize("b,h,w,d,heads,block,itemsize,want", [
    (128, 56, 56, 96, 3, 14, 2, True),     # NesT-Small level 0
    (128, 28, 28, 192, 6, 14, 2, True),    # level 1
    (128, 14, 14, 384, 12, 14, 2, True),   # level 2
    (64, 56, 56, 96, 3, 14, 2, True),      # the batch the port trains at
    (4, 8, 8, 16, 2, 4, 4, True),          # the tiny NesT, fp32
    (128, 56, 56, 96, 5, 14, 2, False),    # heads do not divide D
    (128, 57, 56, 96, 3, 14, 2, False),    # H not a multiple of the block
    (128, 56, 42, 96, 3, 14, 2, False),    # 3 windows a strip: no group of 3
    (8, 14, 14, 384, 12, 14, 4, False),    # level 2 in fp32: over budget
])
def test_supports_window_matches_jax(b, h, w, d, heads, block, itemsize,
                                     want):
    assert TFB.supports_window(b, h, w, d, heads, block, itemsize) == want
    assert JFB.supports_window(b, h, w, d, heads, block, itemsize) == want
