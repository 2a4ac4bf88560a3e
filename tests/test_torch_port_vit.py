"""The port's ViT (``vlp_tpu_torch.models.vit``) against the JAX package's,
with the JAX variables carried over by ``vlp_tpu_torch.convert``.

- A tiny ViT classifier (img 32, patch 8, D 128, 2 heads of 64, depth 2,
  ``megakernel=False``: the path ViT-B/16 takes at full width; at D 128 the
  reference would take the half-block kernels) through both packages'
  ``OnlyImagingTask``, fp32, ``attend_qkv`` in Pallas interpret mode on the
  JAX side: features and logits within 5e-5 (the JAX package's
  kernel-vs-plain bound), the BCE gradients within 1e-4 of each tensor's
  largest |g| (fp32 sums in other orders, as test_torch_port_train_step.py).
- One block at ViT-B's width (D 768, 12 heads, N 2, S 17), bf16: both
  packages take the unfused path there, and agree within 2^-5 of the
  output's scale.
- The converter's round trip of the ViT tree, and its refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.config import get_experiment
from vlp_tpu.models import vit as jvit
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.ops import fused_block as JFB
from vlp_tpu.ops.augment import AugmentConfig as JAugment
from vlp_tpu_torch import convert
from vlp_tpu_torch.config import TrainConfig
from vlp_tpu_torch.models import vit as tvit
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.ops import fused_block as TFB
from vlp_tpu_torch.ops.augment import AugmentConfig
from vlp_tpu_torch.train.step import to_device

TINY = dict(img_size=32, patch_size=8, hidden_dim=128, depth=2, num_heads=2)
MEAN, STD, CW = 120.0, 50.0, (0.7, 1.3)
ATOL = 5e-5
GRAD_REL = 1e-4


def _batch(seed, b=6):
    rng = np.random.default_rng(seed)
    return {"image_u8": rng.integers(0, 256, (b, 32, 32), dtype=np.uint8),
            "label": np.asarray([0, 1, 1, 0, 1, 0][:b], np.int32),
            "mask": np.asarray([1, 1, 1, 1, 1, 0][:b], np.float32),
            "dataset_id": np.zeros(b, np.int32)}


@pytest.fixture
def tiny_vit(monkeypatch):
    """(cfg, JAX task, perturbed params, port task with them) of the tiny
    ViT classifier, ``megakernel=False``."""
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jvit, "vit_base_patch16_224",
                        lambda **kw: jvit.ViT(**TINY, **kw))
    monkeypatch.setattr(tvit, "vit_base_patch16_224",
                        lambda **kw: tvit.ViT(**TINY, **kw))
    cfg = get_experiment("baseline_only_imaging_vit_base")
    cfg.trainer.precision = "fp32"
    cfg.data.image_size = 32
    cfg.data.disable_augmentations = True
    cfg.model.megakernel = False
    jtask = jbuild_task(cfg, JStatics(mean=MEAN, std=STD, class_weights=CW,
                                      augment=JAugment(enabled=False)))
    variables = jtask.init_variables(
        jax.random.key(0), jax.tree.map(jnp.asarray, _batch(0)))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), jax.device_get(variables["params"]))
    tcfg = TrainConfig.from_config(cfg)
    assert not tcfg.serve.megakernel
    task = build_task(tcfg, TaskStatics(mean=MEAN, std=STD, class_weights=CW,
                                        augment=AugmentConfig(enabled=False)))
    convert.load_weights(task.model, {"params": params})
    return cfg, jtask, params, task


def test_tiny_vit_features_logits_and_gradients_match_jax(tiny_vit):
    _, jtask, params, task = tiny_vit
    batch = _batch(10)
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = to_device(batch, torch.device("cpu"))
    want_feats = np.asarray(jtask.features_fn({"params": params}, jbatch))
    want_logits = np.asarray(jtask.eval_fn({"params": params}, jbatch)
                             ["logits"])
    feats = task.features_fn(tbatch).numpy()
    logits = task.eval_fn(tbatch)["logits"].numpy()
    assert feats.shape == want_feats.shape == (6, 128)
    np.testing.assert_allclose(feats, want_feats, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits, want_logits, atol=ATOL, rtol=0)

    (jloss, _), jgrads = jax.value_and_grad(jtask.loss_fn, has_aux=True)(
        params, {}, jbatch, jax.random.key(4))
    loss, _ = task.loss_fn(tbatch, torch.Generator())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = convert.state_dict_from_flax({"params": jax.device_get(jgrads)},
                                        task.model)
    for name, p in task.model.named_parameters():
        scale = want[name].abs().max().item()
        assert (p.grad - want[name]).abs().max().item() <= \
            GRAD_REL * max(scale, 1e-12), name


def test_vit_b_width_block_takes_the_unfused_path_in_both(monkeypatch):
    """D 768 fails both half-block budgets (14.2 MB of weights and
    accumulators against 11 MB; 28.3 MB against 15 MB): both packages run
    LayerNorm -> attention -> residual -> LayerNorm -> MLP -> residual, and
    a call to a half-block kernel on either side would raise here."""
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    n, s, d, heads = 2, 17, 768, 12
    assert not JFB.supports_attn(n, s, d, heads) and \
        not TFB.supports_attn(n, s, d, heads)
    assert not JFB.supports_mlp(n * s, d, 4 * d) and \
        not TFB.supports_mlp(n * s, d, 4 * d)

    def refuse(*_, **__):
        raise AssertionError("a half-block kernel ran")

    for mod, name in ((JFB, "ln_attention"), (JFB, "ln_mlp"),
                      (tvit, "ln_attention"), (tvit, "ln_mlp")):
        monkeypatch.setattr(mod, name, refuse)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, s, d)).astype(np.float32)
    jblock = jvit.EncoderBlock(num_heads=heads, dtype=jnp.bfloat16)
    variables = jax.tree.map(
        lambda p: np.asarray(p) + 0.02 * rng.standard_normal(p.shape).astype(
            np.float32),
        jax.device_get(jblock.init(jax.random.key(0),
                                   jnp.asarray(x, jnp.bfloat16))))
    want = np.asarray(jblock.apply(variables, jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    block = tvit.EncoderBlock(d, heads)
    convert.load_weights(block, variables)
    with torch.no_grad():
        got = block(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    # bf16 Dense products of 768 and 3072 terms, summed in other orders by
    # XLA and PyTorch, can each flip a rounding: 2^-5 of the output's scale
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=2.0 ** -5 * np.abs(want).max(), rtol=0)


def test_converter_round_trip_and_refusals(tiny_vit):
    _, _, params, task = tiny_vit
    flat = convert.flatten({"params": params})
    assert convert.torch_key("params/backbone/block1/attn/qkv/kernel") == \
        "backbone.blocks.1.attn.qkv.weight"
    assert convert.torch_key("params/backbone/final_ln/scale") == \
        "backbone.final_ln.weight"
    sd = task.model.state_dict()
    assert np.array_equal(
        sd["backbone.patch_embed.weight"].numpy(),
        flat["params/backbone/patch_embed/kernel"].transpose(3, 2, 0, 1))
    for key in ("cls_token", "pos_embed"):
        assert np.array_equal(sd[f"backbone.{key}"].numpy(),
                              flat[f"params/backbone/{key}"])
    assert len(sd) == len(flat)

    missing = dict(flat)
    del missing["params/backbone/block1/mlp/fc2/bias"]
    with pytest.raises(KeyError, match=r"blocks\.1\.mlp\.fc2\.bias"):
        convert.load_weights(task.model, missing)
    leftover = dict(flat, **{"params/backbone/block2/ln1/scale":
                             np.ones(128, np.float32)})
    with pytest.raises(KeyError, match="block2/ln1/scale"):
        convert.load_weights(task.model, leftover)
    misshaped = dict(flat)
    misshaped["params/backbone/pos_embed"] = np.zeros((1, 16, 128))
    with pytest.raises(ValueError, match="pos_embed"):
        convert.load_weights(task.model, misshaped)


def test_unported_switches_raise():
    """``fused_attention=False`` and ``remat=True`` still raise; NesT's
    ``nhwc_windows=True`` (kernels #5/#6) is ported: it builds and runs a
    tiny forward on the windowed path."""
    from vlp_tpu_torch.models.nest import NesT
    model = NesT(img_size=16, patch_size=2, embed_dims=(16, 32),
                 num_heads=(2, 4), depths=(1, 1), block_size=4,
                 dtype=torch.float32, nhwc_windows=True)
    tvit.flax_init_(model, torch.Generator().manual_seed(0))
    before = TFB.ln_attention_windows.launches
    with torch.no_grad():
        feats = model(torch.randn(2, 16, 16, 3,
                                  generator=torch.Generator().manual_seed(1)))
    assert feats.shape == (2, 32) and bool(torch.isfinite(feats).all())
    assert TFB.ln_attention_windows.launches == before  # CPU: plain version
    assert model._level_uses_nhwc(torch.zeros(2, 8, 8, 16), 0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tvit.EncoderBlock(64, 2, fused_attention=False)
    from vlp_tpu_torch.models.registry import create_backbone
    with pytest.raises(NotImplementedError, match="remat"):
        create_backbone("vit_base_patch16_224", remat=True)
