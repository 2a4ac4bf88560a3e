"""The port's ResNets (``vlp_tpu_torch/models/resnet.py``), its BatchNorm,
the CORAL loss and the imaging task with CORAL against the JAX package, on
inputs drawn by numpy from a seed, fp32 compute on both sides; the weights
and batch statistics go across through ``vlp_tpu_torch.convert``.

Parameters and running statistics are perturbed after init so that every
BatchNorm scale, bias, mean and variance differs from its initial value and
a swapped mapping shows.

Tolerances, relative to the reference's largest |value|:
- eval mode (running statistics): 2e-5; the same fp32 arithmetic, summed
  in other orders by XLA's and PyTorch's CPU convolutions.
- train mode, features and running statistics: 1e-4 for the micro ResNet
  (two stages of one BasicBlock, one with an identity residual, one with a
  strided downsample), 2e-3 for ResNet50 at 64 px, whose last stages normalise
  over 4 x 2 x 2 values per channel: the fast variance E[x^2] - E[x]^2
  cancels there and magnifies the fp32 summation-order differences.
- ``bn_dtype=bf16``: every BatchNorm rounds its output to bf16 (2^-9) and a
  summation-order difference can flip one rounding (2^-8); 2^-5 on the
  micro ResNet, in both modes.
- CORAL: 1e-5 of the value and of each gradient's largest |g|.
- the task's loss and gradients: loss 1e-5, gradients 1e-3 of each
  tensor's largest |g| (train-mode BatchNorm's backward cancels the same
  way as its variance, and CORAL with weight 1000 is added in).
- parameters after one AdamW step: where |g| > 1e-2 of the tensor's
  largest (ten times the gradient bound) both sides step by lr * sign(g)
  within two fp32 ulps plus 1e-5 * lr; elsewhere within 2 * lr
  (``test_torch_port_train_step.py`` gives the reasoning); running
  statistics after the step 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.config import get_experiment
from vlp_tpu.models import resnet as jr
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.ops import losses as jlosses
from vlp_tpu.ops.augment import AugmentConfig as JAugment
from vlp_tpu.train.optim import make_optimizer as jmake_optimizer
from vlp_tpu.train.state import TrainState as JState
from vlp_tpu.train.step import make_train_step as jmake_train_step
from vlp_tpu_torch import convert
from vlp_tpu_torch.config import TrainConfig, as_serve_config
from vlp_tpu_torch.models import resnet as tr
from vlp_tpu_torch.models.registry import create_backbone
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.models.vit import BatchNorm, conv_nhwc, flax_init_
from vlp_tpu_torch.ops import losses
from vlp_tpu_torch.serve import Predictor
from vlp_tpu_torch.train.optim import make_optimizer
from vlp_tpu_torch.train.state import TrainState
from vlp_tpu_torch.train.step import make_train_step, to_device

EVAL_REL = 2e-5
GRAD_REL = 1e-3
SIGNIFICANT = 10 * GRAD_REL
B, SIZE, LR, SPE = 6, 32, 1e-3, 2
MEAN, STD, CW = 120.0, 50.0, (0.7, 1.3)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _perturbed(variables, seed):
    """Parameters plus N(0, 0.05^2) noise, running means plus N(0, 0.1^2),
    running variances plus 0.5 |N(0, 1)|."""
    rng = np.random.default_rng(seed)
    v = jax.device_get(variables)

    def noise(p, scale):
        return rng.standard_normal(p.shape).astype(np.float32) * scale

    out = {"params": jax.tree.map(lambda p: np.asarray(p) + noise(p, 0.05),
                                  v["params"])}
    out["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, p: np.asarray(p) + (
            np.abs(noise(p, 0.5)) if path[-1].key == "var"
            else noise(p, 0.1)), v["batch_stats"])
    return out


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _stats_rel(model, mutated):
    """Largest relative difference of every running statistic against the
    flax ``batch_stats`` tree."""
    sd = model.state_dict()
    flat = convert.flatten({"batch_stats": jax.device_get(mutated)})
    return max(_rel(sd[convert.torch_key(k)].numpy(), a)
               for k, a in flat.items())


@pytest.mark.parametrize("name,stem,chans,bn,size,train_rel", [
    ("resnet_micro", "conv7", 3, "fp32", 32, 1e-4),
    ("resnet_micro", "s2d", 1, "fp32", 32, 1e-4),
    ("resnet_micro", "s2d", 3, "fp32", 64, 1e-4),
    ("resnet50", "conv7", 1, "fp32", 64, 2e-3),
    ("resnet_micro", "conv7", 1, "bf16", 32, 2.0 ** -5),
    ("resnet_micro", "s2d", 3, "bf16", 32, 2.0 ** -5),
])
def test_backbone_matches_jax_in_eval_and_train_mode(name, stem, chans, bn,
                                                     size, train_rel):
    jnorm, tnorm = DTYPES[bn]
    jm = getattr(jr, name)(dtype=jnp.float32, norm_dtype=jnorm, stem=stem)
    x = np.random.default_rng(size + chans).standard_normal(
        (4, size, size, chans)).astype(np.float32)
    variables = _perturbed(jax.jit(jm.init, static_argnames="train")(
        jax.random.key(0), jnp.asarray(x), train=False), 1)
    apply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    want_eval = apply(variables, jnp.asarray(x), train=False)
    want_train, mutated = apply(variables, jnp.asarray(x), train=True,
                                mutable="batch_stats")
    model = getattr(tr, name)(dtype=torch.float32, norm_dtype=tnorm,
                              stem=stem, in_chans=chans)
    convert.load_weights(model, variables)
    assert model.num_features == tr.FEATURE_DIMS[name]
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x))
        assert all(torch.equal(v, model.state_dict()[k])
                   for k, v in stats0.items())  # eval updates nothing
        got_train = model.train()(torch.from_numpy(x))
    assert got_eval.dtype == got_train.dtype == torch.float32
    assert got_eval.shape == (4, tr.FEATURE_DIMS[name])
    eval_rel = EVAL_REL if bn == "fp32" else train_rel
    assert _rel(got_eval.numpy(), want_eval) <= eval_rel
    assert _rel(got_train.numpy(), want_train) <= train_rel
    assert _stats_rel(model, mutated["batch_stats"]) <= train_rel


def test_batchnorm_keeps_the_biased_variance_and_no_counter():
    """One training-mode call: running = 0.9 running + 0.1 batch with the
    biased batch variance (torch's BatchNorm2d keeps the unbiased one), no
    num_batches_tracked buffer, output in the norm dtype."""
    bn = BatchNorm(3, torch.bfloat16)
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    bn.train()(x)
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-5,
                               atol=1e-6)
    assert set(bn.state_dict()) == {"weight", "bias", "running_mean",
                                    "running_var"}
    assert bn.eval()(x).dtype == torch.bfloat16


def test_convert_maps_params_and_batch_stats():
    assert convert.torch_key("params/backbone/stage1_block0/ds_conv/kernel") \
        == "backbone.stages.1.0.ds_conv.weight"
    assert convert.torch_key("params/backbone/stem_conv_s2d/kernel") == \
        "backbone.stem_conv.weight"
    assert convert.torch_key("params/backbone/stem_bn/scale") == \
        "backbone.stem_bn.weight"
    assert convert.torch_key("batch_stats/backbone/stage0_block1/bn2/mean") \
        == "backbone.stages.0.1.bn2.running_mean"
    assert convert.torch_key("batch_stats/backbone/stem_bn/var") == \
        "backbone.stem_bn.running_var"
    with pytest.raises(KeyError, match="batch_stats"):
        convert.torch_key("cache/backbone/x")
    jm = jr.resnet_micro(dtype=jnp.float32)
    variables = _perturbed(jm.init(jax.random.key(0),
                                   jnp.zeros((1, 32, 32, 3)), train=False), 2)
    model = tr.resnet_micro(dtype=torch.float32)
    convert.load_weights(model, variables)  # strict
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["stages.1.0.conv1.weight"].numpy(),
        variables["params"]["stage1_block0"]["conv1"]["kernel"].transpose(
            3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["stages.1.0.ds_bn.running_var"].numpy(),
        variables["batch_stats"]["stage1_block0"]["ds_bn"]["var"])
    with pytest.raises(KeyError, match="running_mean"):
        convert.load_weights(model, {"params": variables["params"]})
    # the optimizer state maps parameters only
    opt = torch.optim.AdamW(model.parameters())
    convert.load_optimizer_state(opt, model, variables["params"],
                                 variables["params"], 3)
    assert all(opt.state[p]["step"].item() == 3 for p in model.parameters())


@pytest.mark.parametrize("domains", [
    [0, 1, 0, 1, 0, 1], [0, 0, 0, 1, 1, 1], [0, 1, 1, 1, 1, 1],
    [1, 1, 1, 1, 1, 1]])
def test_coral_loss_and_gradient_match_jax(domains):
    rng = np.random.default_rng(len(domains) + sum(domains))
    feats = rng.standard_normal((6, 8)).astype(np.float32) + 2.0
    dom = np.asarray(domains)
    mask = np.asarray([1, 1, 1, 1, 1, 0], np.float32)
    sm, tm = mask * (dom == 0), mask * (dom == 1)

    def jloss(f):
        return jlosses.coral_loss(f, f, jnp.asarray(sm), jnp.asarray(tm))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_()
    got = losses.coral_loss(f, f, torch.from_numpy(sm), torch.from_numpy(tm))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5, abs=1e-12)
    assert bool(torch.isfinite(f.grad).all())
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-5 * max(np.abs(want_g).max(), 1e-6))
    if min((sm > 0).sum(), (tm > 0).sum()) < 2:
        assert got.item() == 0.0 and not f.grad.any()


def _cfg(**changes):
    """baseline_only_imaging_resnet34 (CORAL 1000) at a test size: the
    micro ResNet, 32 px, fp32, augmentation off, and the cosine schedule,
    whose first lr is the base lr (cosine_warmup's is 0)."""
    cfg = get_experiment("baseline_only_imaging_resnet34")
    cfg.model.model = "resnet_micro"
    cfg.trainer.precision = "fp32"
    cfg.data.image_size = SIZE
    cfg.data.disable_augmentations = True
    cfg.optimizer.lr = LR
    cfg.scheduler.name = "cosine"
    for key, value in changes.items():
        section, field = key.split("__")
        setattr(getattr(cfg, section), field, value)
    return cfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image_u8": rng.integers(0, 256, (B, SIZE, SIZE), dtype=np.uint8),
            "label": np.asarray([0, 1, 1, 0, 1, 0], np.int32),
            "mask": np.asarray([1, 1, 1, 1, 1, 0], np.float32),
            "dataset_id": np.asarray([0, 1, 0, 1, 0, 1], np.int32),
            "clinical": np.zeros((B, 15), np.float32)}


def _tasks(cfg, seed=3):
    """(JAX task, perturbed variables, the port's task with them)."""
    chans = cfg.data.in_channels
    jtask = jbuild_task(cfg, JStatics(mean=MEAN, std=STD, class_weights=CW,
                                      out_channels=chans,
                                      augment=JAugment(enabled=False)))
    variables = _perturbed(jtask.init_variables(
        jax.random.key(0), jax.tree.map(jnp.asarray, _batch(0))), seed)
    tcfg = TrainConfig.from_config(cfg)
    task = build_task(tcfg, TaskStatics(mean=MEAN, std=STD,
                                        class_weights=CW,
                                        out_channels=chans,
                                        augment=tcfg.augment()))
    convert.load_weights(task.model, variables)
    return jtask, variables, task


def _check_grads(model, want_tree):
    want = convert.state_dict_from_flax({"params": jax.device_get(want_tree)},
                                        model, params_only=True)
    for name, p in model.named_parameters():
        scale = want[name].abs().max().item()
        assert (p.grad - want[name]).abs().max().item() <= GRAD_REL * scale, \
            name


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_task_loss_and_gradients_with_coral_match_jax(stem):
    cfg = _cfg(model__stem=stem)
    jtask, variables, task = _tasks(cfg)
    assert task.coral_lambda == 1000.0
    jbatch = jax.tree.map(jnp.asarray, _batch(1))
    (jloss, (mutated, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jtask.loss_fn, has_aux=True))(variables["params"],
                                     {"batch_stats": variables["batch_stats"]},
                                     jbatch, jax.random.key(4))
    task.model.eval()  # loss_fn sets the training mode itself
    loss, aux = task.loss_fn(to_device(_batch(1), torch.device("cpu")),
                             torch.Generator())
    assert task.model.training
    loss.backward()
    assert float(jaux["coral"]) > 0
    for key in ("bce", "coral", "loss"):
        assert aux[key].item() == pytest.approx(float(jaux[key]), rel=1e-5)
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    _check_grads(task.model, jgrads)
    assert _stats_rel(task.model, mutated["batch_stats"]) <= 1e-5


def _check_params(model, want, grads, lr):
    for name, p in model.named_parameters():
        diff = (p.detach() - want[name]).abs()
        tight = 2 * 2.0 ** -23 * want[name].abs() + 1e-5 * lr
        g = grads[name].abs()
        big = g > SIGNIFICANT * g.max()
        assert (diff <= tight)[big].all(), name
        assert (diff <= 2 * lr + tight).all(), name


def test_one_train_step_matches_jax_params_and_batch_stats():
    cfg = _cfg()
    jtask, variables, task = _tasks(cfg, seed=5)
    params, extra = variables["params"], {
        "batch_stats": variables["batch_stats"]}
    tx = jmake_optimizer(cfg, params, SPE)
    jstate = JState.create(params, extra, tx, jax.random.key(3))
    jstate1, jaux = jmake_train_step(jtask, tx)(
        jstate, jax.tree.map(jnp.asarray, _batch(2)))

    tcfg = TrainConfig.from_config(cfg)
    opt, schedules = make_optimizer(tcfg, task.model, SPE)
    state = TrainState.create(task.model, opt, schedules, seed=0)
    aux = make_train_step(task, opt, schedules)(
        state, to_device(_batch(2), torch.device("cpu")))
    assert aux["lr"] == pytest.approx(LR, rel=1e-7)
    assert aux["loss"].item() == pytest.approx(float(jaux["loss"]),
                                               rel=1e-5)
    assert aux["coral"].item() == pytest.approx(float(jaux["coral"]),
                                                rel=1e-5)
    grads = {n: p.grad for n, p in task.model.named_parameters()}
    want = convert.state_dict_from_flax(
        {"params": jax.device_get(jstate1.params)}, task.model,
        params_only=True)
    _check_params(task.model, want, grads, LR)
    assert _stats_rel(task.model,
                      jstate1.extra_vars["batch_stats"]) <= 1e-5


def test_eval_uses_the_running_statistics_after_a_loss_fn():
    """loss_fn updates the running statistics; eval_fn, features_fn and
    Predictor then normalise with them (the JAX ``train=False`` apply) and
    change nothing, whatever mode the model was left in."""
    cfg = _cfg()
    jtask, variables, task = _tasks(cfg, seed=6)
    batch = _batch(3)
    jbatch = jax.tree.map(jnp.asarray, batch)
    _, (mutated, _) = jtask.loss_fn(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        jbatch, jax.random.key(0))
    task.loss_fn(to_device(batch, torch.device("cpu")), torch.Generator())
    after = {"params": variables["params"], **mutated}
    want = jtask.eval_fn(after, jbatch)
    stats = {k: v.clone() for k, v in task.model.state_dict().items()
             if "running" in k}
    task.model.train()
    got = task.eval_fn(to_device(batch, torch.device("cpu")))
    assert not task.model.training
    assert _rel(got["logits"].numpy(), want["logits"]) <= EVAL_REL
    assert got["loss"].item() == pytest.approx(float(want["loss"]),
                                               rel=1e-5)
    task.model.train()
    feats = task.features_fn(to_device(batch, torch.device("cpu")))
    assert _rel(feats.numpy(), jtask.features_fn(after, jbatch)) <= EVAL_REL
    assert all(torch.equal(v, task.model.state_dict()[k])
               for k, v in stats.items())

    # Predictor on a model left in training mode: one image's logit does
    # not depend on the rest of its batch
    pred = Predictor(as_serve_config(cfg), None, MEAN, STD, batch_size=B,
                     device="cpu")
    pred.task.model.load_state_dict(task.model.state_dict())
    pred.task.model.train()
    images = batch["image_u8"]
    full = pred.predict_logits(images)
    alone = pred.predict_logits(images[:1])
    assert abs(full[0] - alone[0]) <= EVAL_REL * max(1.0, abs(full[0]))
    np.testing.assert_allclose(full, np.asarray(want["logits"]), rtol=0,
                               atol=EVAL_REL * np.abs(full).max())


def test_registry_and_task_build_the_resnets():
    for name, dim in (("resnet18", 512), ("resnet34", 512),
                      ("resnet50", 2048), ("resnet50-res512-all", 2048),
                      ("resnet_micro", 128)):
        model, feature_dim = create_backbone(name, dtype=torch.float32,
                                             in_chans=1)
        assert feature_dim == dim == model.num_features
        assert model.stem_conv.weight.shape[1] == 1
    model, _ = create_backbone("resnet_micro", stem="s2d",
                               norm_dtype=torch.bfloat16)
    assert model.stem_conv.weight.shape == (64, 12, 4, 4)
    assert model.stem_bn.dtype == torch.bfloat16
    assert all(m.bias is None for m in model.modules()
               if isinstance(m, torch.nn.Conv2d))
    with pytest.raises(ValueError, match="Unknown backbone"):
        create_backbone("resnet101")
    with pytest.raises(ValueError, match="stem"):
        create_backbone("resnet18", stem="patch")
    cfg = _cfg(model__stem="s2d", trainer__bn_dtype="bf16",
               data__in_channels=1)
    task = build_task(as_serve_config(cfg), TaskStatics(out_channels=1))
    backbone = task.model.backbone
    assert backbone.stem == "s2d" and backbone.stem_bn.dtype == torch.bfloat16
    assert backbone.stem_conv.weight.shape[1] == 4


def test_flax_init_takes_bias_free_convs_and_batchnorm():
    model = tr.resnet_micro(dtype=torch.float32)
    with torch.no_grad():
        for b in model.buffers():
            b.add_(1.0)
    flax_init_(model, torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert not m.bias.any() and not m.running_mean.any()
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))
    w = model.stages[0][0].conv1.weight
    assert w.std().item() == pytest.approx((64 * 9) ** -0.5, rel=0.1)
    x = torch.randn(2, 5, 5, 64)
    y = conv_nhwc(x, model.stages[0][0].conv1, 1, 1)
    assert y.shape == (2, 5, 5, 64)


def test_remat_builds_a_resnet_and_still_raises_for_the_transformers():
    """``remat`` reaches only ViT and NesT in the reference's registry, so a
    ResNet takes ``remat=True`` and ignores it: the same module, the same
    forward. The transformers still raise until remat is ported."""
    plain, _ = create_backbone("resnet34", dtype=torch.float32)
    flax_init_(plain, torch.Generator().manual_seed(0))
    remat, dim = create_backbone("resnet34", dtype=torch.float32, remat=True)
    assert dim == 512
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    plain.eval()
    remat.eval()
    with torch.no_grad():
        assert torch.equal(remat(x), plain(x))
    for name in ("vit_base_patch16_224", "nest_small"):
        with pytest.raises(NotImplementedError, match="remat"):
            create_backbone(name, remat=True)
