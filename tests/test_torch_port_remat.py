"""Per-block rematerialisation (``model.remat``) and flax's attention
layout (``model.fused_attention=false``) in the port's ViT and NesT,
against the JAX package's, fp32 on the CPU.

- ViT and NesT (blockified and ``nhwc_windows``), and both models in flax's
  layout, with ``remat`` on and off: features and every gradient
  bit-equal in the port (remat reruns the same plain arithmetic).
- The port with ``remat`` against the JAX package's ``remat=True`` models
  at ``tests/test_models.py:205-270``'s shapes, the JAX side's Pallas
  kernels in interpret mode: features within 5e-5 and gradients within
  1e-4 of each one's largest |g| (``tests/test_torch_port_vit.py``'s).
- ``fused_attention=False`` ViT and NesT against the JAX package's
  (flax ``MultiHeadDotProductAttention``, carried across by ``convert``'s
  q|k|v packing): the same tolerances; the fp32 classifier's one SGD step
  against the JAX step: loss and parameters within 1e-4.
- A state dict of one layout loads strictly into the other (the port's
  keys are the same: the JAX package's ``adapt_attention_layout`` has the
  identity as its counterpart here) with logits within 5e-5, and a
  dual tower's or a classifier's backbone warm-starts a classifier of the
  other layout through ``graft_backbone``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.config import get_experiment
from vlp_tpu.models import nest as jnest
from vlp_tpu.models import vit as jvit
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.ops.augment import AugmentConfig as JAugment
from vlp_tpu.train.optim import make_optimizer as jmake_optimizer
from vlp_tpu.train.state import TrainState as JState
from vlp_tpu.train.step import make_train_step as jmake_train_step
from vlp_tpu.utils.checkpoint import adapt_attention_layout
from vlp_tpu_torch import convert
from vlp_tpu_torch.config import TrainConfig
from vlp_tpu_torch.models import nest as tnest
from vlp_tpu_torch.models import vit as tvit
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.ops.augment import AugmentConfig
from vlp_tpu_torch.train.optim import make_optimizer
from vlp_tpu_torch.train.step import make_train_step, to_device
from vlp_tpu_torch.utils import checkpoint as ckpt

ATOL = 5e-5
GRAD_REL = 1e-4
STEP_ABS = 1e-4
# tests/test_models.py's TestRemat shapes
VIT = dict(patch_size=8, hidden_dim=32, depth=2, num_heads=4, img_size=56)
NEST = dict(img_size=32, patch_size=4, embed_dims=(8, 16), num_heads=(2, 2),
            depths=(1, 1), block_size=4)
# the windowed path needs windows of at least 4 x 4 and heads of 16
NEST_NHWC = dict(img_size=16, patch_size=2, embed_dims=(16, 32),
                 num_heads=(2, 4), depths=(1, 1), block_size=4)
MODELS = {"vit": (jvit.ViT, tvit.ViT, VIT, {}, 56),
          "nest": (jnest.NesT, tnest.NesT, NEST, {}, 32),
          "nest_nhwc": (jnest.NesT, tnest.NesT, NEST_NHWC,
                        {"nhwc_windows": True}, 16)}


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
        p.shape).astype(np.float32), jax.device_get(variables))


def _case(name, seed=0, **kw):
    """(JAX module class, the port's class, shape and extra kwargs, input,
    cotangent, the JAX variables of the model with ``kw``)."""
    jcls, tcls, shape, extra, size = MODELS[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    jmodel = jcls(dtype=jnp.float32, **shape, **extra, **kw)
    variables = _perturbed(jax.jit(jmodel.init)(jax.random.key(0),
                                                jnp.asarray(x)), seed + 1)
    width = shape.get("hidden_dim") or shape["embed_dims"][-1]
    ct = rng.standard_normal((2, width)).astype(np.float32)
    return jcls, tcls, shape, extra, x, ct, variables


def _jax_feats_grads(jcls, kw, x, ct, variables):
    model = jcls(dtype=jnp.float32, **kw)

    def loss(params):
        return jnp.sum(model.apply({"params": params}, jnp.asarray(x))
                       * jnp.asarray(ct))

    feats = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    grads = jax.device_get(jax.jit(jax.grad(loss))(variables["params"]))
    return feats, grads


def _port(tcls, kw, variables):
    model = tcls(dtype=torch.float32, **kw)
    convert.load_weights(model, variables)
    return model


def _feats_grads(model, x, ct):
    model.zero_grad(set_to_none=True)
    feats = model(torch.from_numpy(x))
    (feats * torch.from_numpy(ct)).sum().backward()
    return feats.detach(), {n: p.grad.clone()
                            for n, p in model.named_parameters()}


def _close_to_jax(model, feats, grads, want_feats, jgrads):
    np.testing.assert_allclose(feats.numpy(), want_feats, atol=ATOL, rtol=0)
    want = convert.state_dict_from_flax({"params": jgrads}, model)
    assert set(grads) == set(want)
    for name, g in grads.items():
        scale = want[name].abs().max().item()
        assert (g - want[name]).abs().max().item() <= \
            GRAD_REL * max(scale, 1e-12), name


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "flax"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_is_bit_equal_in_the_port(name, fused):
    _, tcls, shape, extra, size = MODELS[name]
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, size, size, 3, generator=gen).numpy()
    kw = dict(shape, **extra, fused_attention=fused)
    plain = tcls(dtype=torch.float32, **kw)
    tvit.flax_init_(plain, gen)
    with torch.no_grad():
        for p in plain.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    ct = torch.randn(2, plain.num_features, generator=gen).numpy()
    remat = tcls(dtype=torch.float32, remat=True, **kw)
    remat.load_state_dict(plain.state_dict())
    assert remat.remat and not plain.remat
    feats_p, grads_p = _feats_grads(plain, x, ct)
    feats_r, grads_r = _feats_grads(remat, x, ct)
    assert torch.equal(feats_p, feats_r)
    for n, g in grads_p.items():
        assert torch.equal(grads_r[n], g), n
    with torch.no_grad():  # no autograd: no checkpointing
        assert torch.equal(remat(torch.from_numpy(x)), feats_p)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_remat_matches_the_jax_remat_model(monkeypatch, name):
    """The ViT's JAX side runs its Pallas kernels in interpret mode inside
    the checkpointed blocks (``test_vit_remat_with_pallas_interpret``'s
    case); the NesTs' JAX sides take their plain references, which keeps
    the interpreter's time out of the suite."""
    if name == "vit":
        monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    jcls, tcls, shape, extra, x, ct, variables = _case(name, seed=3)
    kw = dict(shape, **extra, remat=True)
    want_feats, jgrads = _jax_feats_grads(jcls, kw, x, ct, variables)
    model = _port(tcls, kw, variables)
    _close_to_jax(model, *_feats_grads(model, x, ct), want_feats, jgrads)


@pytest.mark.parametrize("name", ["vit", "nest"])
def test_flax_attention_layout_matches_jax(monkeypatch, name):
    """Neither side reaches a half-block kernel; the MLP halves take
    ``fused_mlp`` where it fits (interpret mode on the JAX side)."""
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    jcls, tcls, shape, _, x, ct, variables = _case(
        name, 5, fused_attention=False)
    kw = dict(shape, fused_attention=False)
    flat = convert.flatten(variables)
    assert any(k.endswith("/attn/query/kernel") for k in flat)
    want_feats, jgrads = _jax_feats_grads(jcls, kw, x, ct, variables)
    model = _port(tcls, kw, variables)
    assert all(isinstance(b.attn, tvit.MultiHeadAttention)
               for b in model.modules() if isinstance(b, tvit.EncoderBlock))
    _close_to_jax(model, *_feats_grads(model, x, ct), want_feats, jgrads)


# --------------------------------------------------------------------------
# the classifier's step, and checkpoints across the layouts
# --------------------------------------------------------------------------

TINY_VIT = dict(img_size=32, patch_size=8, hidden_dim=64, depth=2,
                num_heads=2)
MEAN, STD, CW = 120.0, 50.0, (0.7, 1.3)


def _batch(seed, b=6):
    rng = np.random.default_rng(seed)
    return {"image_u8": rng.integers(0, 256, (b, 32, 32), dtype=np.uint8),
            "label": np.asarray([0, 1, 1, 0, 1, 0][:b], np.int32),
            "mask": np.asarray([1, 1, 1, 1, 1, 0][:b], np.float32),
            "dataset_id": np.zeros(b, np.int32)}


@pytest.fixture
def tiny_vit(monkeypatch):
    """Builds (config, JAX task, port task) of the tiny ViT classifier
    (fp32, SGD at 0.01, no augmentation) in a given layout."""
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jvit, "vit_base_patch16_224",
                        lambda **kw: jvit.ViT(**TINY_VIT, **kw))
    monkeypatch.setattr(tvit, "vit_base_patch16_224",
                        lambda **kw: tvit.ViT(**TINY_VIT, **kw))

    def build(fused, remat=False):
        cfg = get_experiment("baseline_only_imaging_vit_base")
        cfg.trainer.precision = "fp32"
        cfg.data.image_size = 32
        cfg.data.disable_augmentations = True
        cfg.model.fused_attention = fused
        cfg.model.remat = remat
        cfg.optimizer.name = "sgd"
        cfg.optimizer.lr = 0.01
        cfg.scheduler.name = "none"
        jtask = jbuild_task(cfg, JStatics(mean=MEAN, std=STD,
                                          class_weights=CW,
                                          augment=JAugment(enabled=False)))
        task = build_task(TrainConfig.from_config(cfg), TaskStatics(
            mean=MEAN, std=STD, class_weights=CW,
            augment=AugmentConfig(enabled=False)))
        return cfg, jtask, task

    return build


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_flax_layout_classifier_step_matches_jax(tiny_vit, remat):
    cfg, jtask, task = tiny_vit(False, remat)
    batch = _batch(10)
    jbatch = jax.tree.map(jnp.asarray, batch)
    variables = _perturbed(jtask.init_variables(jax.random.key(0), jbatch),
                           2)
    convert.load_weights(task.model, variables)
    params = variables["params"]
    tx = jmake_optimizer(cfg, params, 10)
    state = JState.create(params, {}, tx, jax.random.key(1))
    new, aux = jmake_train_step(jtask, tx)(state, jbatch)
    opt, schedules = make_optimizer(TrainConfig.from_config(cfg),
                                    task.model, 10)
    from vlp_tpu_torch.train.state import TrainState
    tstate = TrainState.create(task.model, opt, schedules, seed=1)
    got = make_train_step(task, opt, schedules)(
        tstate, to_device(batch, torch.device("cpu")))
    assert abs(float(got["loss"]) - float(aux["loss"])) < STEP_ABS
    want = convert.state_dict_from_flax(
        {"params": jax.device_get(new.params)}, task.model)
    for k, v in task.model.state_dict().items():
        assert float((v - want[k]).abs().max()) < STEP_ABS, k


def test_checkpoints_cross_the_attention_layouts(tiny_vit, tmp_path):
    """The port's keys are the same in both layouts, so a state dict of
    one loads strictly into the other, and the JAX package's layout
    migration maps onto the identity here."""
    _, jfused, fused = tiny_vit(True)
    _, jflax, flax_layout = tiny_vit(False)
    batch = _batch(11)
    jbatch = jax.tree.map(jnp.asarray, batch)
    variables = _perturbed(jfused.init_variables(jax.random.key(0), jbatch),
                           4)
    convert.load_weights(fused.model, variables)
    assert set(fused.model.state_dict()) == set(flax_layout.model.state_dict())
    # the JAX migration fused -> flax, carried across, is the same state
    target = jax.device_get(jflax.init_variables(jax.random.key(0), jbatch))
    migrated, n = adapt_attention_layout(variables, target)
    assert n == TINY_VIT["depth"]
    assert "query" in migrated["params"]["backbone"]["block0"]["attn"]
    want = convert.state_dict_from_flax(migrated, flax_layout.model)
    for k, v in fused.model.state_dict().items():
        assert torch.equal(want[k], v), k
    # a trainer checkpoint of one layout restores into the other
    path = ckpt.save(str(tmp_path / "fused.pt"),
                     {"model": fused.model.state_dict()})
    flax_layout.model.load_state_dict(ckpt.restore_raw(path)["model"],
                                      strict=True)
    tb = to_device(batch, torch.device("cpu"))
    np.testing.assert_allclose(flax_layout.eval_fn(tb)["logits"].numpy(),
                               fused.eval_fn(tb)["logits"].numpy(),
                               atol=ATOL, rtol=0)
    # warm starts: a classifier's backbone and a dual tower's image tower
    for src, dst in ((fused, flax_layout), (flax_layout, fused)):
        sd = src.model.state_dict()
        encoder = {k[len("backbone."):]: v for k, v in sd.items()
                   if k.startswith("backbone.")}
        grafted = ckpt.graft_backbone(dst.model.state_dict(), encoder)
        dst.model.load_state_dict(grafted)
        tower = ckpt.extract_image_encoder(
            {f"image_encoder.{k}": v for k, v in encoder.items()})
        assert ckpt.graft_backbone(dst.model.state_dict(), tower).keys() \
            == grafted.keys()
