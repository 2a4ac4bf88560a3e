"""The late-fusion task of the port (``vlp_tpu_torch/models/heads.py``,
``FusionModel`` and ``FusionTask`` in ``models/tasks.py``) against the JAX
package's, on inputs drawn by numpy from a seed, fp32 on both sides, the
weights and batch statistics carried across by ``convert`` (which maps the
fusion model's leaves with no rule of its own); the fusion experiments'
tasks and parameter groups; ``Predictor`` serving a fusion model from an
``.npz`` and from a checkpoint the port wrote; and the warm start of the
fusion model's backbone from a VLP checkpoint.

Backbones: ``resnet_micro`` at 32 px and the tiny two-level NesT of
test_torch_port_nest.py at 16 px (half-block kernels in Pallas interpret
mode on the JAX side), batch 8 (6 in the task tests, one row padded).
Parameters and running statistics are perturbed after init so that a
swapped mapping shows.

Tolerances, relative to the reference's largest |value|:
- the clinical MLP and the fusion head alone: 1e-5 in both modes, and the
  running statistics 1e-5;
- ``FusionModel``: logits, features and running statistics 1e-5 in both
  modes (the micro ResNet's train-mode gaps read ~2e-6 on these seeds);
- the task's loss terms 1e-5; its gradients 1e-3 of each tensor's largest
  |g| (test_torch_port_resnet.py's ``GRAD_REL``; the clinical MLP's Dense
  biases, whose exact gradient is 0 since a BatchNorm follows each, 1e-3
  of their kernel's largest |g|), the running statistics
  after ``loss_fn`` 1e-5; one AdamW step as
  ``test_one_train_step_matches_jax_params_and_batch_stats``;
- ``eval_fn``, ``features_fn`` and ``Predictor``'s logits: 2e-5 (eval
  mode, summation order);
- a checkpoint served back and the warm start: bit-equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.config import get_experiment as jget
from vlp_tpu.models import heads as jheads
from vlp_tpu.models import nest as jnest
from vlp_tpu.models.tasks import FusionModel as JFusionModel
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.ops.augment import AugmentConfig as JAugment
from vlp_tpu.train.optim import make_optimizer as jmake_optimizer
from vlp_tpu.train.optim import param_group_label_fn
from vlp_tpu.train.state import TrainState as JState
from vlp_tpu.train.step import make_train_step as jmake_train_step
from vlp_tpu_torch import convert
from vlp_tpu_torch.config import (TRAIN_EXPERIMENTS, TrainConfig,
                                  apply_overrides, get_experiment,
                                  list_experiments)
from vlp_tpu_torch.models import nest as tnest
from vlp_tpu_torch.models.heads import ClinicalMLP, FusionHead
from vlp_tpu_torch.models.tasks import (FusionModel, FusionTask,
                                        TaskStatics, build_task)
from vlp_tpu_torch.models.vit import flax_init_
from vlp_tpu_torch.serve import Predictor
from vlp_tpu_torch.train import driver
from vlp_tpu_torch.train.loop import Trainer
from vlp_tpu_torch.train.optim import make_optimizer, param_groups
from vlp_tpu_torch.train.setup import random_clinical
from vlp_tpu_torch.train.state import TrainState
from vlp_tpu_torch.train.step import make_train_step, to_device
from vlp_tpu_torch.utils import checkpoint as ckpt

CPU = torch.device("cpu")
REL = 1e-5
EVAL_REL = 2e-5
GRAD_REL = 1e-3
SIGNIFICANT = 10 * GRAD_REL
B, LR, SPE = 6, 1e-3, 2
MEAN, STD, CW = 120.0, 50.0, (0.7, 1.3)
TINY = dict(img_size=16, patch_size=2, embed_dims=(16, 32), num_heads=(2, 4),
            depths=(1, 1), block_size=4)
FUSION = sorted(n for n in list_experiments()
                if get_experiment(n).model.task == "fusion")


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


def _stats_rel(model, batch_stats):
    sd = model.state_dict()
    flat = convert.flatten({"batch_stats": jax.device_get(batch_stats)})
    return max(_rel(sd[convert.torch_key(k)].numpy(), a)
               for k, a in flat.items())


def _clinical(seed, n=8):
    """Clinical vectors as the corpus forms them, plus noise so that no two
    rows tie in a BatchNorm statistic."""
    rng = np.random.default_rng(seed)
    return (random_clinical(rng, n) + 0.1 * rng.standard_normal(
        (n, 15))).astype(np.float32)


@pytest.fixture
def tiny_nest(monkeypatch):
    """nest_small made the tiny NesT on both sides, the JAX one's kernels
    in interpret mode."""
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(jnest, "nest_small",
                        lambda **kw: jnest.NesT(**TINY, **kw))
    monkeypatch.setattr(tnest, "nest_small",
                        lambda **kw: tnest.NesT(**TINY, **kw))


# --------------------------------------------------------------------------
# (a) the heads and the model against flax
# --------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_clinical_mlp_matches_flax(train):
    x = _clinical(0)
    jm = jheads.ClinicalMLP()
    variables = _perturbed(jm.init(jax.random.key(0), jnp.asarray(x)), 1)
    model = ClinicalMLP()
    assert [n for n, _ in model.named_children()] == \
        ["fc0", "bn0", "fc1", "bn1", "fc2", "bn2"]
    convert.load_weights(model, variables)
    model.train(train)
    got = model(torch.from_numpy(x)).detach().numpy()
    if train:
        want, mutated = jm.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        assert _stats_rel(model, mutated["batch_stats"]) <= REL
    else:
        want = jm.apply(variables, jnp.asarray(x), train=False)
        assert _stats_rel(model, variables["batch_stats"]) == 0.0
    assert got.shape == (8, 10) and (got >= 0).all()
    assert _rel(got, want) <= REL


def test_fusion_head_matches_flax():
    rng = np.random.default_rng(2)
    img, clin = (rng.standard_normal((8, 10)).astype(np.float32)
                 for _ in range(2))
    jm = jheads.FusionHead()
    params = jax.device_get(jm.init(jax.random.key(0), img, clin))
    head = FusionHead()
    convert.load_weights(head, params)
    want = jm.apply(params, img, clin)
    # bf16 image logits are taken in fp32, as flax promotes them
    got = head(torch.from_numpy(img).bfloat16(), torch.from_numpy(clin))
    assert got.dtype == torch.float32 and got.shape == (8, 1)
    jwant = jm.apply(params, jnp.asarray(img, jnp.bfloat16), clin)
    assert _rel(got.detach().numpy(), jwant) <= REL
    got = head(torch.from_numpy(img), torch.from_numpy(clin))
    assert _rel(got.detach().numpy(), want) <= REL


@pytest.mark.parametrize("backbone,size", [("resnet_micro", 32),
                                           ("nest_small", 16)],
                         ids=["resnet_micro", "tiny_nest"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fusion_model_matches_flax(tiny_nest, backbone, size, train):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((8, size, size, 3)).astype(np.float32)
    clin = _clinical(3)
    jm = JFusionModel(backbone_name=backbone, dtype=jnp.float32)
    init = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x),
                            jnp.asarray(clin))
    variables = _perturbed(init, 4)
    apply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    assert set(variables["params"]) == {"backbone", "image_head",
                                        "clinical_mlp", "fusion_head"}
    model = FusionModel(backbone, torch.float32)
    convert.load_weights(model, variables)
    model.train(train)
    with torch.no_grad():
        logits, feats = model(torch.from_numpy(x), torch.from_numpy(clin))
    if train:
        (want, wfeats), mutated = apply(
            variables, jnp.asarray(x), jnp.asarray(clin), train=True,
            mutable=("batch_stats",))
        assert _stats_rel(model, mutated["batch_stats"]) <= REL
    else:
        want, wfeats = apply(variables, jnp.asarray(x), jnp.asarray(clin),
                             train=False)
    assert logits.shape == (8,) and logits.dtype == torch.float32
    assert _rel(logits.numpy(), want) <= REL
    assert _rel(feats.numpy(), wfeats) <= REL


# --------------------------------------------------------------------------
# (b), (c) the task against the JAX task
# --------------------------------------------------------------------------

RESNET = ("baseline_fusion_resnet34", "resnet_micro", 32)
NEST = ("baseline_fusion_nest_small", "nest_small", 16)


def _cfg(experiment="baseline_fusion_resnet34", backbone="resnet_micro",
         size=32):
    """The experiment (baseline_fusion_resnet34: CORAL 1000;
    baseline_fusion_nest_small: none) at a test size: fp32, augmentation
    off, and the cosine schedule, whose first lr is the base lr."""
    cfg = jget(experiment)
    cfg.model.model = backbone
    cfg.trainer.precision = "fp32"
    cfg.data.image_size = size
    cfg.data.disable_augmentations = True
    cfg.optimizer.lr = LR
    cfg.scheduler.name = "cosine"
    return cfg


def _batch(seed, size=32):
    rng = np.random.default_rng(seed)
    return {"image_u8": rng.integers(0, 256, (B, size, size),
                                     dtype=np.uint8),
            "label": np.asarray([0, 1, 1, 0, 1, 0], np.int32),
            "mask": np.asarray([1, 1, 1, 1, 1, 0], np.float32),
            "dataset_id": np.asarray([0, 1, 0, 1, 0, 1], np.int32),
            "clinical": _clinical(seed + 100, B)}


def _tasks(cfg, seed=3):
    """(JAX task, perturbed variables, the port's task with them)."""
    size = cfg.data.image_size
    jtask = jbuild_task(cfg, JStatics(mean=MEAN, std=STD, class_weights=CW,
                                      augment=JAugment(enabled=False)))
    variables = _perturbed(jtask.init_variables(
        jax.random.key(0), jax.tree.map(jnp.asarray, _batch(0, size))),
        seed)
    tcfg = TrainConfig.from_config(cfg)
    task = build_task(tcfg, TaskStatics(mean=MEAN, std=STD,
                                        class_weights=CW,
                                        augment=tcfg.augment()))
    assert isinstance(task, FusionTask)
    assert task.coral_lambda == cfg.model.coral_lambda
    convert.load_weights(task.model, variables)
    return jtask, variables, task


def _check_grads(model, want_tree):
    """Each gradient within ``GRAD_REL`` of its tensor's largest |g|; the
    clinical MLP's Dense biases, whose exact gradient is 0 (the BatchNorm
    after each takes out the batch mean), within ``GRAD_REL`` of their
    Dense kernel's largest |g|."""
    want = convert.state_dict_from_flax({"params": jax.device_get(want_tree)},
                                        model, params_only=True)
    for name, p in model.named_parameters():
        scale = _grad_scale(name, want).item()
        assert (p.grad - want[name]).abs().max().item() <= GRAD_REL * scale, \
            name


@pytest.mark.parametrize("experiment,backbone,size", [RESNET, NEST],
                         ids=["resnet_micro", "tiny_nest"])
def test_task_loss_and_gradients_match_jax(tiny_nest, experiment, backbone,
                                           size):
    cfg = _cfg(experiment, backbone, size)
    jtask, variables, task = _tasks(cfg)
    jbatch = jax.tree.map(jnp.asarray, _batch(1, size))
    (jloss, (mutated, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jtask.loss_fn, has_aux=True))(
            variables["params"], {"batch_stats": variables["batch_stats"]},
            jbatch, jax.random.key(4))
    task.model.eval()  # loss_fn sets the training mode itself
    loss, aux = task.loss_fn(to_device(_batch(1, size), CPU),
                             torch.Generator())
    assert task.model.training
    loss.backward()
    coral = cfg.model.coral_lambda > 0
    assert set(aux) == set(jaux) == {"logits", "labels", "mask", "bce",
                                     "loss"} | ({"coral"} if coral else set())
    assert not coral or float(jaux["coral"]) > 0
    for key in ("bce", "coral", "loss") if coral else ("bce", "loss"):
        assert aux[key].item() == pytest.approx(float(jaux[key]), rel=REL)
    assert _rel(aux["logits"].detach().numpy(), jaux["logits"]) <= REL
    _check_grads(task.model, jgrads)
    assert _stats_rel(task.model, mutated["batch_stats"]) <= REL


def _grad_scale(name, grads):
    """The largest |g| a tensor's gradient is measured against: its own,
    or for the clinical MLP's Dense biases (exact gradient 0) their
    kernel's."""
    if name.startswith("clinical_mlp.fc") and name.endswith(".bias"):
        name = name.replace(".bias", ".weight")
    return grads[name].abs().max()


def _check_params(model, want, grads, lr):
    for name, p in model.named_parameters():
        diff = (p.detach() - want[name]).abs()
        tight = 2 * 2.0 ** -23 * want[name].abs() + 1e-5 * lr
        g = grads[name].abs()
        big = g > SIGNIFICANT * _grad_scale(name, grads)
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
    aux = make_train_step(task, opt, schedules)(state,
                                                to_device(_batch(2), CPU))
    assert aux["lr"] == pytest.approx(LR, rel=1e-7)
    for key in ("loss", "coral"):
        assert aux[key].item() == pytest.approx(float(jaux[key]), rel=REL)
    grads = {n: p.grad for n, p in task.model.named_parameters()}
    want = convert.state_dict_from_flax(
        {"params": jax.device_get(jstate1.params)}, task.model,
        params_only=True)
    _check_params(task.model, want, grads, LR)
    assert _stats_rel(task.model,
                      jstate1.extra_vars["batch_stats"]) <= REL


@pytest.mark.parametrize("experiment,backbone,size", [RESNET, NEST],
                         ids=["resnet_micro", "tiny_nest"])
def test_eval_and_features_match_jax(tiny_nest, experiment, backbone, size):
    """eval_fn (the keys of the imaging task's) and features_fn, in eval
    mode whatever mode the model was left in, after a loss_fn moved the
    running statistics on both sides."""
    jtask, variables, task = _tasks(_cfg(experiment, backbone, size),
                                    seed=6)
    batch = _batch(3, size)
    jbatch = jax.tree.map(jnp.asarray, batch)
    _, (mutated, _) = jax.jit(jtask.loss_fn)(
        variables["params"], {"batch_stats": variables["batch_stats"]},
        jbatch, jax.random.key(0))
    task.loss_fn(to_device(batch, CPU), torch.Generator())
    after = {"params": variables["params"], **mutated}
    want = jax.jit(jtask.eval_fn)(after, jbatch)
    task.model.train()
    got = task.eval_fn(to_device(batch, CPU))
    assert not task.model.training
    assert set(got) == set(want) == {"logits", "labels", "mask",
                                     "dataset_id", "loss"}
    assert _rel(got["logits"].numpy(), want["logits"]) <= EVAL_REL
    assert got["loss"].item() == pytest.approx(float(want["loss"]),
                                               rel=REL)
    feats = task.features_fn(to_device(batch, CPU))
    assert _rel(feats.numpy(), jax.jit(jtask.features_fn)(after, jbatch)) \
        <= EVAL_REL
    # the logit reads the clinical vector; the features do not
    other = dict(batch, clinical=_clinical(7, B))
    moved = task.eval_fn(to_device(other, CPU))["logits"]
    assert not torch.equal(moved, got["logits"])
    assert torch.equal(task.features_fn(to_device(other, CPU)), feats)


# --------------------------------------------------------------------------
# (d) the fusion experiments, their tasks and parameter groups
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _flax_param_paths(backbone: str, in_channels: int):
    """The flax FusionModel's parameter paths (shapes only, nothing run)."""
    jm = JFusionModel(backbone_name=backbone, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda x, c: jm.init(jax.random.key(0), x, c),
        jax.ShapeDtypeStruct((1, 224, 224, in_channels), jnp.float32),
        jax.ShapeDtypeStruct((1, 15), jnp.float32))
    return tuple(convert.flatten({"params": shapes["params"]}))


def test_the_twelve_fusion_experiments_are_registered():
    assert len(FUSION) == 12
    assert {"baseline_fusion_resnet34", "baseline_fusion_nest_small",
            "fusion_xrv_resnet50", "vlp_finetune_fusion_resnet34",
            "vlp_finetune_fusion_resnet34_split_lr",
            "vlp_finetune_fusion_resnet34_frozen_encoder"} <= set(FUSION)


@pytest.mark.parametrize("name", FUSION)
def test_fusion_experiment_builds_and_groups_as_jax(monkeypatch, name):
    """The experiment's task at its own widths, and its parameter groups:
    each parameter in the group JAX's label function gives its flax path,
    every group at JAX's lr, and the frozen encoder's backbone (exactly
    ``backbone.*``) left out of the optimizer."""
    monkeypatch.setenv("VLP_PALLAS_INTERPRET", "1")
    cfg = get_experiment(name)
    tcfg = TRAIN_EXPERIMENTS[name]
    task = build_task(tcfg, TaskStatics(out_channels=cfg.data.in_channels),
                      CPU)
    assert isinstance(task, FusionTask)
    assert task.coral_lambda == cfg.model.coral_lambda
    assert task.model.backbone.num_features == task.model.feature_dim
    names = [n for n, _ in task.model.named_parameters()]
    jlabel = param_group_label_fn(jget(name))
    paths = _flax_param_paths(cfg.model.model, cfg.data.in_channels)
    assert sorted(convert.torch_key(p) for p in paths) == sorted(names)
    groups = param_groups(tcfg, task.model)
    if jlabel is None:
        assert [(g, lr) for g, lr, _ in groups] == [("all", tcfg.lr)]
    else:
        want = {convert.torch_key(p): jlabel(p.split("/", 1)[1])
                for p in paths}
        got = {n: g for g, _, ps in groups
               for n, p in task.model.named_parameters()
               if any(p is q for q in ps)}
        assert got == want
    opt, _ = make_optimizer(tcfg, task.model, 1)
    frozen = sorted(n for n, p in task.model.named_parameters()
                    if not p.requires_grad)
    if tcfg.freeze_encoder or tcfg.vision_encoder_lr == 0.0:
        assert frozen == sorted(n for n in names if n.startswith("backbone."))
        assert [g["name"] for g in opt.param_groups] == ["head"]
    else:
        assert frozen == []


# --------------------------------------------------------------------------
# (e) serving
# --------------------------------------------------------------------------

def test_predictor_serves_a_fusion_model(tmp_path):
    """From the JAX variables as an .npz (the JAX eval_fn's logits), with
    the clinical vectors chunk by chunk; ``clinical=None`` is zeros; and a
    checkpoint the port's Checkpointer wrote serves its task's logits."""
    cfg = _cfg()
    jtask, variables, task = _tasks(cfg, seed=8)
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **convert.flatten(variables))
    rng = np.random.default_rng(9)
    n = 7
    images = rng.integers(0, 256, (n, 32, 32), dtype=np.uint8)
    clin = _clinical(10, n)
    pred = Predictor(cfg, npz, MEAN, STD, batch_size=3, device="cpu")
    got = pred.predict_logits(images, clin)
    jbatch = {"image_u8": images, "clinical": clin,
              "label": np.zeros(n, np.int32),
              "dataset_id": np.zeros(n, np.int32),
              "mask": np.ones(n, np.float32)}
    want = np.asarray(jtask.eval_fn(variables,
                                    jax.tree.map(jnp.asarray, jbatch))
                      ["logits"])
    assert _rel(got, want) <= EVAL_REL
    np.testing.assert_array_equal(
        pred.predict_logits(images),
        pred.predict_logits(images, np.zeros((n, 15), np.float32)))
    probs = pred.predict_arrays(images, clin)
    np.testing.assert_allclose(probs, 1 / (1 + np.exp(-got)), rtol=1e-6)

    # a checkpoint of the port's trainer
    state = TrainState.create(task.model, *make_optimizer(
        TrainConfig.from_config(cfg), task.model, 1), seed=0)
    saver = ckpt.Checkpointer(str(tmp_path / "ck"), "val/acc",
                              async_write=False)
    assert saver.maybe_save({"val/acc": 0.5}, state, 0)
    served = Predictor(cfg, None, MEAN, STD, batch_size=B, device="cpu",
                       checkpoint=saver.best_path)
    batch = _batch(11)
    want = task.eval_fn(to_device(batch, CPU))["logits"].numpy()
    got = served.predict_logits(batch["image_u8"], batch["clinical"])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not both"):
        Predictor(cfg, npz, MEAN, STD, device="cpu",
                  checkpoint=saver.best_path)


def test_serve_cli_takes_a_checkpoint_or_weights(tmp_path):
    import cv2

    from vlp_tpu_torch.serve import main, parse_args

    cfg = apply_overrides(get_experiment("baseline_fusion_resnet34"),
                          ["model.model=resnet_micro", "data.image_size=16",
                           "trainer.precision=fp32"])
    task = build_task(TrainConfig.from_config(cfg), TaskStatics(), CPU)
    flax_init_(task.model, torch.Generator().manual_seed(1))
    path = ckpt.save(str(tmp_path / "m.pt"),
                     {"model": task.model.state_dict()})
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(img_dir / f"{i}.png"),
                    rng.integers(0, 256, (20, 24), dtype=np.uint8))
    out = tmp_path / "preds.csv"
    common = ["--images", str(img_dir), "--output", str(out), "--device",
              "cpu", "--batch-size", "2", "experiment=baseline_fusion_resnet34",
              "model.model=resnet_micro", "data.image_size=16",
              "trainer.precision=fp32"]
    assert main(["--checkpoint", path] + common) == 0
    assert len(out.read_text().splitlines()) == 4
    for bad in ([], ["--checkpoint", path, "--weights", "w.npz"]):
        with pytest.raises(SystemExit):
            parse_args(bad + common)


# --------------------------------------------------------------------------
# (j) the warm start of the fusion model's backbone
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["vlp_finetune_fusion_resnet34",
                                  "vlp_finetune_fusion_resnet34_frozen_encoder"])
def test_fusion_warm_start_grafts_the_vlp_image_tower(tmp_path, name):
    """The VLP checkpoint's image tower (its running statistics included)
    becomes the fusion model's backbone, bit for bit; the image head, the
    clinical branch and the fusion head keep the trainer's init."""
    small = ["model.model=resnet_micro", "model.text_model=microbert",
             "data.image_size=32"]
    vcfg = apply_overrides(get_experiment("smoke_synthetic_pretrain"), small)
    vlp = build_task(TrainConfig.from_config(vcfg), TaskStatics(), CPU)
    flax_init_(vlp.model, torch.Generator().manual_seed(5))
    with torch.no_grad():  # running statistics unlike the init's
        for b in vlp.model.buffers():
            b.add_(torch.rand_like(b))
    path = ckpt.save(str(tmp_path / "vlp.pt"),
                     {"model": vlp.model.state_dict()})
    cfg = apply_overrides(get_experiment(name), small + [
        f"model.pretrained_ckpt={path}", "data.name=synthetic_downstream",
        "data.synthetic_num_samples=40", "data.batch_size=8"])
    cfg.output_dir = str(tmp_path / "run")
    fold = next(driver.build_datamodule(cfg, CPU).folds())
    task = build_task(TrainConfig.from_config(cfg), fold.statics, CPU)
    trainer = Trainer(cfg, task, fold.train_loader, fold.val_loaders)
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    driver._maybe_warm_start(cfg, trainer)
    after = task.model.state_dict()
    source = vlp.model.state_dict()
    for key, value in after.items():
        if key.startswith("backbone."):
            assert torch.equal(value, source["image_encoder."
                                             + key[len("backbone."):]]), key
        else:
            assert torch.equal(value, before[key]), key
    assert any(k.startswith("clinical_mlp.bn") and "running" in k
               for k in after)
