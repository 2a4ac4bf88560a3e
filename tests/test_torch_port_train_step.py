"""One training step of the port (``vlp_tpu_torch.train``) against the JAX
package's ``make_train_step``, on the tiny NesT of test_torch_port_nest.py
(img 16, patch 2, dims (16, 32), heads (2, 4), depths (1, 1), block 4), fp32,
augmentation off, half-block kernels in Pallas interpret mode on the JAX
side and the plain backwards on the port's side; plus the schedules and the
experiment's training fields.

Tolerances:
- loss: 1e-5 relative (fp32 forward, the two sides within 5e-5 on features).
- gradients: 1e-4 of each tensor's largest |g| (fp32 on both sides, summed
  in other orders: the Pallas grid sums weight gradients program by
  program, the port in one matmul, conv gradients by cuDNN-free CPU code).
- parameters after the first AdamW step: the update is
  lr * g / (|g| + eps), close to lr * sign(g). Where |g| is well above eps
  and above the gradients' disagreement (|g| > 1e-3 of the tensor's
  largest, ten times the gradient bound) the two sides take the same step,
  and the parameters agree to two fp32 ulps of their value plus 1e-5 * lr;
  elsewhere m_hat / sqrt(v_hat) of a near-zero gradient is the ratio of two
  rounding noises and may take any value in [-1, 1] on either side (the key
  bias, whose exact gradient is 0 since softmax ignores a shift of the
  scores, is such a case), so they agree within 2 * lr.
- after the second step, from JAX's carried-over moments: the first moment
  mixes two gradients and can sit near 0, so each element is held to the
  first-order change of lr * m_hat / (sqrt(v_hat) + eps) under the
  gradient bound, capped at 2 * lr, plus the same two ulps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vlp_tpu.config import get_experiment
from vlp_tpu.models import nest as jnest
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.ops import fused_block as JFB
from vlp_tpu.ops.augment import AugmentConfig as JAugment
from vlp_tpu.train.optim import make_optimizer as jmake_optimizer
from vlp_tpu.train.optim import make_schedule as jmake_schedule
from vlp_tpu.train.state import TrainState as JState
from vlp_tpu.train.step import make_train_step as jmake_train_step
from vlp_tpu_torch import convert
from vlp_tpu_torch.config import TRAIN_EXPERIMENTS, TrainConfig
from vlp_tpu_torch.models import nest as tnest
from vlp_tpu_torch.models import vit as tvit
from vlp_tpu_torch.models.tasks import TaskStatics, build_task
from vlp_tpu_torch.models.vit import flax_init_
from vlp_tpu_torch.ops.augment import AugmentConfig
from vlp_tpu_torch.train.optim import make_optimizer, make_schedule
from vlp_tpu_torch.train.setup import build_training, random_batch
from vlp_tpu_torch.train.state import TrainState
from vlp_tpu_torch.train.step import make_train_step, to_device, train_steps

TINY = dict(img_size=16, patch_size=2, embed_dims=(16, 32), num_heads=(2, 4),
            depths=(1, 1), block_size=4)
EXPERIMENT = "baseline_only_imaging_nest_small"
B, LR, SPE = 6, 1e-3, 2
MEAN, STD, CW = 120.0, 50.0, (0.7, 1.3)
GRAD_REL = 1e-4
SIGNIFICANT = 10 * GRAD_REL


def _jax_cfg():
    cfg = get_experiment(EXPERIMENT)
    cfg.trainer.precision = "fp32"
    cfg.data.image_size = 16
    cfg.data.disable_augmentations = True
    cfg.optimizer.lr = LR
    cfg.scheduler.name = "cosine"
    return cfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image_u8": rng.integers(0, 256, (B, 16, 16), dtype=np.uint8),
            "label": np.asarray([0, 1, 1, 0, 1, 0], np.int32),
            "mask": np.asarray([1, 1, 1, 1, 1, 0], np.float32),
            "dataset_id": np.zeros(B, np.int32),
            "clinical": np.zeros((B, 15), np.float32)}


@pytest.fixture
def tiny_port(monkeypatch):
    """The experiment's config with the port's NesT made tiny."""
    monkeypatch.setattr(tnest, "nest_small",
                        lambda **kw: tnest.NesT(**TINY, **kw))
    return _jax_cfg()


@pytest.fixture
def tiny(monkeypatch, tiny_port):
    """(config, JAX task, perturbed initial parameters) of the tiny NesT on
    both sides."""
    return _tiny(monkeypatch, tiny_port)


@pytest.fixture
def tiny_unfused(monkeypatch, tiny_port):
    """``tiny`` with ``model.megakernel=false``: the unfused block path
    (``attend_qkv``, and ``fused_mlp`` where its rows divide)."""
    tiny_port.model.megakernel = False
    return _tiny(monkeypatch, tiny_port)


def _tiny(monkeypatch, cfg):
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jnest, "nest_small",
                        lambda **kw: jnest.NesT(**TINY, **kw))
    jtask = jbuild_task(cfg, JStatics(mean=MEAN, std=STD, class_weights=CW,
                                      augment=JAugment(enabled=False)))
    batch = _batch(0)
    variables = jtask.init_variables(
        jax.random.key(0), jax.tree.map(jnp.asarray, batch))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(
            np.float32), jax.device_get(variables["params"]))
    return cfg, jtask, params


def _torch_task(cfg, params=None):
    """The port's task, optimizer and schedules for ``cfg``; weights from a
    flax ``params`` tree, or the flax-scaled random init when None."""
    tcfg = TrainConfig.from_config(cfg)
    task = build_task(tcfg, TaskStatics(mean=MEAN, std=STD,
                                        class_weights=CW,
                                        augment=tcfg.augment()))
    if params is None:
        flax_init_(task.model, torch.Generator().manual_seed(0))
    else:
        convert.load_weights(task.model, {"params": params})
    opt, schedules = make_optimizer(tcfg, task.model, SPE)
    return task, opt, schedules


def _as_torch(tree, model):
    return convert.state_dict_from_flax({"params": jax.device_get(tree)},
                                        model)


def _adam_state(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _check_params(model, want, grads, lr, opt=None):
    """After step 1 (``opt`` None) the update is lr * g / (|g| + eps): tight
    where |g| is significant. After step 2 the first moment mixes two
    gradients and can sit near 0 where they disagree in sign, so the bound
    there is the first-order change of lr * m_hat / (sqrt(v_hat) + eps)
    under a gradient error of GRAD_REL * max|g| (the bound the gradients
    were held to), from the moments ``opt`` holds."""
    for name, p in model.named_parameters():
        diff = (p.detach() - want[name]).abs()
        tight = 2 * 2.0 ** -23 * want[name].abs() + 1e-5 * lr
        g = grads[name].abs()
        if opt is None:
            big = g > SIGNIFICANT * g.max()
            assert (diff <= tight)[big].all(), name
        else:
            st = opt.state[p]
            b1, b2 = opt.param_groups[0]["betas"]
            eps = opt.param_groups[0]["eps"]
            bc1, bc2 = 1 - b1 ** st["step"], 1 - b2 ** st["step"]
            err = GRAD_REL * g.max()
            dm = (1 - b1) * err / bc1
            dv = (1 - b2) * (2 * g + err) * err / bc2
            s = (st["exp_avg_sq"] / bc2).sqrt()
            m = st["exp_avg"].abs() / bc1
            bound = lr * (dm / (s + eps) + m * dv / (2 * s * (s + eps) ** 2
                                                     + 1e-30))
            assert (diff <= bound.clamp(max=2 * lr) + tight).all(), name
        assert (diff <= 2 * lr + tight).all(), name


def _check_first_step(cfg, jtask, params):
    """One step on both sides from the same parameters: loss, gradients and
    the updated parameters agree. Returns (JAX state after it, JAX step)."""
    tx = jmake_optimizer(cfg, params, SPE)
    jstate = JState.create(params, {}, tx, jax.random.key(3))
    jstep = jmake_train_step(jtask, tx)
    batch0 = _batch(10)
    jbatch = jax.tree.map(jnp.asarray, batch0)
    (jloss, _), jgrads = jax.value_and_grad(jtask.loss_fn, has_aux=True)(
        params, {}, jbatch, jax.random.key(4))
    jstate1, jaux = jstep(jstate, jbatch)

    task, opt, schedules = _torch_task(cfg, params)
    state = TrainState.create(task.model, opt, schedules, seed=0)
    step = make_train_step(task, opt, schedules)
    aux = step(state, to_device(batch0, torch.device("cpu")))
    assert state.step == 1 and aux["lr"] == pytest.approx(LR, rel=1e-7)
    np.testing.assert_allclose(aux["loss"].item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["loss"].item(), float(jaux["loss"]),
                               rtol=1e-5)
    assert set(aux) >= {"logits", "labels", "mask", "bce", "loss"}
    want_g = _as_torch(jgrads, task.model)
    grads = {n: p.grad for n, p in task.model.named_parameters()}
    for name, g in grads.items():
        scale = want_g[name].abs().max().item()
        assert (g - want_g[name]).abs().max().item() <= GRAD_REL * scale, \
            name
    _check_params(task.model, _as_torch(jstate1.params, task.model), grads,
                  LR)
    return jstate1, jstep


def test_one_train_step_and_a_carried_over_second_match_jax(tiny):
    cfg, jtask, params = tiny
    jstate1, jstep = _check_first_step(cfg, jtask, params)

    # step 2 from JAX's state: weights and AdamW moments carried over
    adam = _adam_state(jstate1.opt_state)
    task2, opt2, schedules2 = _torch_task(cfg,
                                          jax.device_get(jstate1.params))
    convert.load_optimizer_state(opt2, task2.model,
                                 jax.device_get(adam.mu),
                                 jax.device_get(adam.nu), int(adam.count))
    state2 = TrainState.create(task2.model, opt2, schedules2, seed=0)
    state2.step = 1
    batch1 = _batch(11)
    jstate2, _ = jstep(jstate1, jax.tree.map(jnp.asarray, batch1))
    aux2 = make_train_step(task2, opt2, schedules2)(
        state2, to_device(batch1, torch.device("cpu")))
    lr1 = float(jmake_schedule(LR, cfg, SPE)(1))
    assert aux2["lr"] == pytest.approx(lr1, rel=1e-6)
    grads2 = {n: p.grad for n, p in task2.model.named_parameters()}
    _check_params(task2.model, _as_torch(jstate2.params, task2.model),
                  grads2, lr1, opt2)


def test_one_unfused_train_step_matches_jax(monkeypatch, tiny_unfused):
    """``model.megakernel=false`` (the experiment's unfused switch): a call
    to a half-block kernel on either side would raise."""
    cfg, jtask, params = tiny_unfused

    def refuse(*_, **__):
        raise AssertionError("a half-block kernel ran")

    for mod in (JFB, tvit):
        for name in ("ln_attention", "ln_mlp"):
            monkeypatch.setattr(mod, name, refuse)
    assert not TrainConfig.from_config(cfg).serve.megakernel
    _check_first_step(cfg, jtask, params)


@pytest.mark.parametrize("name", ["none", "cosine", "cosine_warmup"])
def test_schedules_match_jax(name):
    cfg = get_experiment(EXPERIMENT)
    cfg.scheduler.name = name
    want = jmake_schedule(1e-3, cfg, 7)
    got = make_schedule(1e-3, TrainConfig.from_config(cfg), 7)
    for step in (0, 1, 6, 7, 13, 27, 28, 29, 40, 69, 70, 71, 200):
        w = want if isinstance(want, float) else float(want(jnp.int32(step)))
        # the JAX schedule computes in fp32: a few ulps relative, and near
        # the end of the cosine 1 + cos(pi * progress) cancels to an
        # absolute error of about one fp32 ulp of 1, times base_lr
        assert got(step) == pytest.approx(w, rel=2e-6,
                                          abs=2 * 1e-3 * 2.0 ** -23), step
    if name == "cosine_warmup":
        assert got(0) == 0.0


def test_train_experiment_matches_jax_experiment():
    cfg = get_experiment(EXPERIMENT)
    port = TRAIN_EXPERIMENTS[EXPERIMENT]
    assert port == TrainConfig.from_config(cfg)
    assert port.optimizer == "adamw" and port.scheduler == "cosine_warmup"
    assert port.lr == 1.2925748253710286e-4 and port.batch_size == 64
    assert port.coral_lambda == 0.0 and port.max_epochs == 10
    assert port.augment() == AugmentConfig(noise_prob=0.5, shear_deg=0.0)


def test_coral_is_carried_and_vision_encoder_lr_builds_two_groups(
        tiny_port):
    """CORAL is ported: with ``coral_lambda`` set the loss carries it (it
    is not ignored; ``test_torch_port_resnet.py`` holds its value to the
    JAX task's). ``vision_encoder_lr`` builds two param groups, the
    backbone at that lr and the head at the base lr, each with its own
    schedule; ``freeze_encoder`` leaves the backbone out and frozen."""
    cfg = tiny_port
    cfg.model.coral_lambda = 10.0
    task, _, _ = _torch_task(cfg)
    batch = _batch(0)
    batch["dataset_id"] = np.asarray([0, 1, 0, 1, 0, 1], np.int32)
    loss, aux = task.loss_fn(to_device(batch, torch.device("cpu")),
                             torch.Generator())
    assert aux["coral"].item() > 0
    assert loss.item() == pytest.approx(
        aux["bce"].item() + 10.0 * aux["coral"].item(), rel=1e-6)
    cfg.model.vision_encoder_lr = 1e-5
    opt, schedules = make_optimizer(TrainConfig.from_config(cfg), task.model,
                                    SPE)
    backbone = list(task.model.backbone.parameters())
    assert [g["name"] for g in opt.param_groups] == ["backbone", "head"]
    assert opt.param_groups[0]["params"] == backbone
    assert opt.param_groups[1]["params"] == list(
        task.model.head.parameters())
    assert [g["lr"] for g in opt.param_groups] == [1e-5, LR]
    assert [s(0) for s in schedules] == [1e-5, LR]
    assert schedules[0](3) == pytest.approx(1e-5 / LR * schedules[1](3),
                                            rel=1e-12)
    cfg.model.freeze_encoder = True
    opt, schedules = make_optimizer(TrainConfig.from_config(cfg), task.model,
                                    SPE)
    assert [g["name"] for g in opt.param_groups] == ["head"]
    assert len(schedules) == 1
    assert not any(p.requires_grad for p in backbone)


def test_train_steps_with_augmentation_on(tiny_port):
    """The experiment's augmentation (shear warp and noise) through
    ``train_steps`` on the CPU: finite losses, the warmup lr, parameters
    moving from the second step on, the generator advancing."""
    cfg = tiny_port
    cfg.data.disable_augmentations = False
    cfg.scheduler.name = "cosine_warmup"
    task, opt, schedules = _torch_task(cfg)
    assert task.statics.augment.enabled
    state = TrainState.create(task.model, opt, schedules, seed=5)
    step = make_train_step(task, opt, schedules)
    before = [p.detach().clone() for p in task.model.parameters()]
    auxes = train_steps(step, state, [_batch(20)])
    assert auxes[0]["lr"] == 0.0
    assert all(torch.equal(a, p) for a, p in zip(before,
                                                 task.model.parameters()))
    auxes += train_steps(step, state, [_batch(21), _batch(22)])
    assert [a["lr"] for a in auxes] == [schedules[0](i) for i in range(3)]
    assert all(np.isfinite(a["loss"].item()) for a in auxes)
    assert not all(torch.equal(a, p) for a, p in zip(
        before, task.model.parameters()))
    assert state.step == 3


def test_build_training_drives_the_experiments_step(tiny_port):
    """``train.setup.build_training``, the run that chip_smoke.py times and
    profile_slice.py profiles, on the tiny NesT: the task takes the
    experiment's channels, intensity scaling and augmentation, the weights
    follow the seed, and the lr the optimizer used is cosine_warmup's
    warmup written out, base_lr * step / (warmup_epochs * steps_per_epoch),
    which is 0 at step 0."""
    cfg = tiny_port
    cfg.data.disable_augmentations = False
    cfg.scheduler.name = "cosine_warmup"
    tcfg = TrainConfig.from_config(cfg)
    task, state, step = build_training(tcfg, torch.device("cpu"), SPE)
    statics = task.statics
    assert statics.augment == tcfg.augment() and statics.augment.enabled
    assert statics.out_channels == tcfg.serve.in_channels
    assert statics.scale_intensity == tcfg.serve.scale_intensity
    again, _, _ = build_training(tcfg, torch.device("cpu"), SPE)
    assert all(torch.equal(a, b) for a, b in zip(
        task.model.state_dict().values(), again.model.state_dict().values()))
    rng = np.random.default_rng(3)
    used = []
    for _ in range(3):
        batch = random_batch(rng, 4, 16)
        assert batch["image_u8"].shape == (4, 16, 16)
        assert batch["image_u8"].dtype == np.uint8
        (aux,) = train_steps(step, state, [batch])
        assert np.isfinite(aux["loss"].item())
        used.append(state.optimizer.param_groups[0]["lr"])
    warm = tcfg.warmup_epochs * SPE
    assert used == pytest.approx([LR * i / warm for i in range(3)],
                                 rel=1e-12)
    assert used[0] == 0.0 and state.step == 3
