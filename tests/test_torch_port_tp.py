"""Tensor parallelism in the port (``mesh.model_parallel=M
mesh.param_sharding=tp``, ``vlp_tpu_torch/parallel/tp.py``) on gloo ranks
on the CPU at (D, M) = (1, 2) and (2, 2), against the JAX package's TP step
on ``create_mesh(data_parallel=D, model_parallel=M)`` with
``shard_train_state(..., "tp")`` and against the port's own unsplit runs.

One spawn of the ranks per mesh runs the steps
(``torch_parallel_workers.run_steps``), one the tiny models, one (at
(2, 2)) the trainer, its checkpoints and the driver. At the test widths
most weights fall under the JAX rule's 2^16 elements, so the cases marked
``LOW`` lower the threshold on both sides: the port's ``fsdp.MIN_SIZE`` in
the rank processes and ``vlp_tpu.parallel.mesh._FSDP_MIN_SIZE`` here; the
others keep 2^16, as ``tests/test_parallel.py``'s TP test does. What is
held, and to what:

- one SGD step of the VLM (``resnet_micro`` + ``microbert``) against the
  JAX TP step, at 2^16 and at ``LOW`` (BERT's attention and FFN, the stem's
  stage and the projections split too), and of tiny ViT and NesT
  classifiers (``TINY``: the registry's ViT-B and NesT-Small built small
  on both sides, at thresholds under which the ViT's patch embedding,
  heads and MLPs split, and NesT's level 1 and ConvPool split while its
  level 0 stays whole): loss within 1e-4, gradients within 1e-5 of each
  one's largest |g| (against the JAX gradient of the same loss),
  parameters and BatchNorm statistics within 1e-4
  (``tests/test_parallel.py:397-401``);
- one AdamW step at ``LOW`` against the port's replicated step on the same
  ranks (M replicas): the data-parallel tests' rule;
- three AdamW steps with augmentation: every replicated leaf bit-equal on
  every rank, every shard bit-equal across the data ranks, the gathered
  state bit-equal everywhere;
- the elements a rank holds of the parameters plus the AdamW moments
  against the JAX placement at 2^16: every leaf the JAX rule shards is
  split, and the leaves split beyond it (a split conv's BatchNorm) are
  under 2^16 and account for the whole difference;
- tiny ViTs (fused and flax layouts), NesT (level 0 whole, level 1 split;
  with ``nhwc_windows`` the split level off the windowed route) and a
  Bottleneck ResNet on the s2d stem against the same models unsplit,
  forward and backward in training mode: within 1e-5 of each one's
  largest value; the running statistics too;
- ``test_trainer_e2e_under_tp``'s counterpart (the smoke experiment's
  driver run: epoch loss within 1e-3 of the replicated run; only global
  rank 0 writes), resume bit
  for bit, a TP checkpoint (the replicated format) served on one process,
  a replicated checkpoint resumed under TP, the VLP driver under TP against
  replicated, and the warm start;
- ``python -m torch.distributed.run`` of the training CLI under tp at
  both meshes against one process: the fold's metrics within 1e-5, the
  checkpoint in the replicated format;
- the refusals (``test_torch_port_parallel_data.py``) and a TP run that
  splits nothing.
"""
import contextlib
import functools
import json
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlp_tpu.parallel.mesh as jmesh
from test_torch_port_parallel import (CW, MEAN, STD, _batch, _check_adamw,
                                      _close, _jax_case)
from test_torch_port_fsdp import _packed
from torch_parallel_workers import build, run_ranks, steps_worker
from torch_tp_workers import (blocks_worker, nothing_splits_worker,
                              trainer_worker)
from vlp_tpu.config import apply_overrides as japply
from vlp_tpu.config import get_experiment as jget
from vlp_tpu.models import nest as jnest
from vlp_tpu.models import vit as jvit
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.ops.augment import AugmentConfig as JAugment
from vlp_tpu.parallel.mesh import create_mesh, shard_batch, shard_train_state
from vlp_tpu.train.optim import make_optimizer as jmake_optimizer
from vlp_tpu.train.state import TrainState as JState
from vlp_tpu.train.step import make_train_step as jmake_train_step
from vlp_tpu_torch import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((1, 2), (2, 2))
LOW = 4096  # the lowered threshold of the JAX rule
STEP_ABS = 1e-4
GRAD_REL = 1e-5
ADAMW = ["optimizer.name=adamw", "optimizer.lr=0.001"]
# tiny classifiers: name -> (experiment, its backbone built small on both
# sides, the lowered threshold of the JAX rule)
TINY = {
    "vit": ("baseline_only_imaging_vit_base", {"vit_base_patch16_224": dict(
        img_size=32, patch_size=8, hidden_dim=64, depth=2, num_heads=4)},
        1024),
    "nest": ("baseline_only_imaging_nest_small", {"nest_small": dict(
        img_size=32, patch_size=4, embed_dims=(32, 64), num_heads=(2, 4),
        depths=(1, 1), block_size=4)}, 8192)}
CLASSIFIER = ["trainer.precision=fp32", "data.image_size=32",
              "data.disable_augmentations=true", "optimizer.name=sgd",
              "scheduler.name=none", "optimizer.lr=0.01"]


def _tp(spec, m, **kw):
    return dict(spec, overrides=list(spec["overrides"]) + [
        "mesh.param_sharding=tp", f"mesh.model_parallel={m}"], **kw)


def _adamw(spec, m):
    return dict(spec, overrides=[o for o in spec["overrides"]
                                 if not o.startswith(("optimizer",
                                                      "scheduler"))]
                + ADAMW + [f"mesh.model_parallel={m}"])


@contextlib.contextmanager
def _jax_tiny(tiny):
    """While open, the JAX registry builds each backbone named in ``tiny``
    small (flax runs ``setup`` at every trace, so around the steps too)."""
    saved = []
    for name, kw in tiny.items():
        module, cls = (jnest, jnest.NesT) if name.startswith("nest") \
            else (jvit, jvit.ViT)
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, functools.partial(cls, **kw))
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


@functools.lru_cache(maxsize=None)
def _jax_tiny_case(kind):
    """``_jax_case`` of the tiny classifier ``kind`` (``TINY``)."""
    exp, tiny, _ = TINY[kind]
    jcfg = japply(jget(exp), CLASSIFIER)
    jtask = jbuild_task(jcfg, JStatics(mean=MEAN, std=STD, class_weights=CW,
                                       augment=JAugment(enabled=False)))
    batch = _batch(kind)
    with _jax_tiny(tiny):
        variables = jax.device_get(jtask.init_variables(
            jax.random.key(0), jax.tree.map(jnp.asarray, batch)))
    spec = {"experiment": exp, "overrides": CLASSIFIER, "mean": MEAN,
            "std": STD, "class_weights": CW, "spe": 10, "batch": batch,
            "weights": None, "tiny": tiny}
    task, _, _ = build(spec, None)
    convert.load_weights(task.model, variables)
    spec["weights"] = {k: v.numpy().copy()
                       for k, v in task.model.state_dict().items()}
    return jcfg, jtask, variables, spec, task.model


def _case(kind):
    return _jax_case("vlp_gspmd") if kind == "vlp" else _jax_tiny_case(kind)


@functools.lru_cache(maxsize=None)
def _port_steps(d, m, tmp):
    base = _jax_case("vlp_gspmd")[3]
    adamw = _adamw(base, m)
    specs = {
        "sgd": _tp(base, m),
        "sgd_low": _tp(base, m, min_size=LOW),
        "adamw": _tp(adamw, m, elements=True),
        "adamw_low": _tp(adamw, m, min_size=LOW),
        "adamw_low_replicated": dict(adamw, min_size=LOW),
        "three": _tp(dict(adamw, overrides=[
            o for o in adamw["overrides"]
            if "disable_augmentations" not in o]), m, steps=3, augment=True,
            weights=None, min_size=LOW, local=True)}
    for kind, (_, _, low) in TINY.items():
        specs[kind] = _tp(_jax_tiny_case(kind)[3], m, min_size=low)
    return run_ranks(steps_worker, d * m, tmp, specs, model_parallel=m), specs


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_steps")
    return lambda mesh: _port_steps(*mesh, str(tmp))


@contextlib.contextmanager
def _jax_min_size(value):
    old = jmesh._FSDP_MIN_SIZE
    jmesh._FSDP_MIN_SIZE = value
    try:
        yield
    finally:
        jmesh._FSDP_MIN_SIZE = old


def _jax_tp_state(d, m, min_size, optimizer_overrides=(), kind="vlp"):
    """(task, tx, spec, the TrainState placed on the (D, M) mesh by the
    JAX rule at ``min_size``, its shardings, the mesh) of the VLM or a
    tiny classifier (``kind``)."""
    jcfg, jtask, variables, spec, _ = _case(kind)
    if optimizer_overrides:
        from vlp_tpu.config import apply_overrides as japply

        jcfg = japply(jcfg, list(optimizer_overrides))
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    tx = jmake_optimizer(jcfg, params, spec["spe"])
    mesh = create_mesh(data_parallel=d, model_parallel=m,
                       devices=jax.devices()[:d * m])
    with _jax_min_size(min_size):
        state, shardings = shard_train_state(
            JState.create(params, extra, tx, jax.random.key(1)), mesh, "tp")
    specs = [str(x.sharding.spec) for x in jax.tree.leaves(state.params)]
    assert any("model" in sp for sp in specs), specs
    return jtask, tx, spec, state, shardings, mesh


@functools.lru_cache(maxsize=None)
def _jax_tp_step(d, m, min_size, kind="vlp"):
    """(loss, parameters and statistics after the step as the port's state
    dict, the gradient of the loss as the port's parameters) of the JAX TP
    step; the gradient is ``loss_fn``'s on the same placed state."""
    jtask, tx, spec, state, shardings, mesh = _jax_tp_state(
        d, m, min_size, kind=kind)
    batch = shard_batch(jax.tree.map(jnp.asarray, spec["batch"]), mesh)
    model = _case(kind)[4]
    with _jax_tiny(spec.get("tiny") or {}):
        _, grads = jax.jit(jax.value_and_grad(jtask.loss_fn, has_aux=True))(
            state.params, state.extra_vars, batch, jax.random.key(4))
        s, aux = jmake_train_step(jtask, tx, mesh=mesh,
                                  state_shardings=shardings)(state, batch)
    grads = convert.state_dict_from_flax(
        {"params": jax.device_get(grads)}, model, params_only=True)
    want = convert.state_dict_from_flax(
        {"params": jax.device_get(s.params),
         **jax.device_get(s.extra_vars)}, model)
    return float(aux["loss"]), {k: v.numpy() for k, v in want.items()}, \
        {k: v.numpy() for k, v in grads.items()}


def _check_grad(name, got, want, top):
    """Within ``GRAD_REL`` of the JAX gradient's largest |g|; a packed
    q|k|v bias in its flax parts, the key bias (exact gradient 0: the
    softmax does not see it) within 1e-6 of the largest |g| of all."""
    if name.endswith("attn.qkv.bias"):
        for part, g, w in zip("qkv", np.split(got, 3, -1),
                              np.split(want, 3, -1)):
            if part == "k":
                assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * top
            else:
                _check_grad(name + part, g, w, top)
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= GRAD_REL * scale, (name, err, scale)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case,min_size", [
    ("sgd", 2 ** 16), ("sgd_low", LOW), ("vit", TINY["vit"][2]),
    ("nest", TINY["nest"][2])])
def test_one_sgd_step_matches_the_jax_tp_step(step_ranks, mesh, case,
                                              min_size):
    ranks, _ = step_ranks(mesh)
    want_loss, want, want_grads = _jax_tp_step(
        *mesh, min_size, case if case in TINY else "vlp")
    for out in ranks:
        got = out[case]
        assert abs(got["losses"][0] - want_loss) < STEP_ABS
        assert set(got["state"]) == set(want)
        for k, w in want.items():
            diff = float(np.abs(got["state"][k] - w).max())
            assert diff < STEP_ABS, (k, diff)
        assert set(got["grads"]) == set(want_grads)
        top = max(float(np.abs(g).max()) for g in want_grads.values())
        for k, g in got["grads"].items():
            _check_grad(k, g, want_grads[k], top)


@pytest.mark.parametrize("mesh", MESHES)
def test_adamw_step_matches_the_replicated_step(step_ranks, mesh):
    ranks, _ = step_ranks(mesh)
    for out in ranks:
        got, one = out["adamw_low"], out["adamw_low_replicated"]
        assert got["losses"][0] == pytest.approx(one["losses"][0], abs=1e-6)
        assert set(got["grads"]) == set(one["grads"])
        for k, g in one["grads"].items():
            _close(got["grads"][k], g, 1e-4)
        for k, want in one["state"].items():
            if k.endswith(("running_mean", "running_var")):
                _close(got["state"][k], want, 1e-5)
                continue
            _check_adamw(k, got["state"][k], want, one["grads"][k], 1e-3)


@pytest.mark.parametrize("mesh", MESHES)
def test_three_steps_leave_the_ranks_bit_equal(step_ranks, mesh):
    d, m = mesh
    ranks, _ = step_ranks(mesh)
    first = ranks[0]["three"]
    assert len(first["losses"]) == 3 and np.isfinite(first["losses"]).all()
    for g, out in enumerate(ranks):
        three = out["three"]
        assert three["losses"] == first["losses"]
        for k, v in first["state"].items():
            np.testing.assert_array_equal(three["state"][k], v, err_msg=k)
        # a shard against the same shard on the other data ranks; a whole
        # leaf against every rank's
        peer = ranks[g % m]["three"]["local"]
        for k, v in three["local"].items():
            same = peer[k] if v.shape != first["state"][k].shape \
                else first["local"][k]
            np.testing.assert_array_equal(v, same, err_msg=k)
    # the split leaves hold a share
    assert any(v.shape != first["state"][k].shape
               for k, v in first["local"].items())


@functools.lru_cache(maxsize=None)
def _jax_placement(m):
    """(elements a device holds of the parameters plus the Adam moments,
    the port names of the leaves the JAX rule shards) of the VLM's AdamW
    state on the (1, M) mesh at 2^16."""
    _, _, _, state, _, _ = _jax_tp_state(1, m, 2 ** 16, ADAMW)
    params = convert.flatten({"params": jax.device_get(state.params)})
    sharded = {_packed(k) for k, v in params.items()
               if jmesh._fsdp_spec(v.shape, m, "model")
               != jax.sharding.PartitionSpec()}

    def local(leaves):
        return sum(leaf.addressable_shards[0].data.size for leaf in leaves)

    moments = [leaf for path, leaf in jax.tree_util.tree_flatten_with_path(
        state.opt_state)[0] if any(getattr(k, "name", None) in ("mu", "nu")
                                   for k in path)]
    return local(jax.tree.leaves(state.params)) + local(moments), sharded


@pytest.mark.parametrize("mesh", MESHES)
def test_per_rank_elements_against_the_jax_placement(step_ranks, mesh):
    _, m = mesh
    ranks, specs = step_ranks(mesh)
    elements, sharded = _jax_placement(m)
    full = specs["adamw"]["weights"]
    assert sharded
    for out in ranks:
        split = set(out["adamw"]["sharded"])
        assert sharded <= split
        extra = split - sharded
        assert extra and all(full[k].size < 2 ** 16 for k in extra), extra
        assert all(".bn" in k for k in extra), extra
        saved = sum(3 * full[k].size * (m - 1) // m for k in extra)
        params, moments = out["adamw"]["elements"]
        assert params + moments == elements - saved


# --------------------------------------------------------------------------
# tiny models split against unsplit
# --------------------------------------------------------------------------

BLOCKS = {"vit_fused": 1024, "vit_flax": 1024, "nest": 8192,
          "nest_nhwc": 8192, "resnet_bottleneck": 2 ** 16}


@functools.lru_cache(maxsize=None)
def _block_ranks(d, m, tmp):
    return run_ranks(blocks_worker, d * m, tmp, BLOCKS, model_parallel=m)


@pytest.fixture(scope="module")
def block_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_blocks")
    return lambda mesh: _block_ranks(*mesh, str(tmp))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_tiny_model_split_matches_unsplit(block_ranks, mesh, kind):
    for out in block_ranks(mesh):
        res = out[kind]
        want, got = res["want"], res["got"]
        _close(got["y"], want["y"], 1e-5)
        _close(got["dx"], want["dx"], 1e-5)
        assert set(got["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            _close(got["grads"][k], g, 1e-5)
        for k, v in want["state"].items():
            _close(got["state"][k], v, 1e-5)
        rep = res["report"]
        assert rep["split"], rep
        if kind.startswith("nest"):
            # level 0 whole (every weight under the threshold), level 1
            # split; the ConvPool conv by output channels
            assert not any(k.startswith("levels.0.") for k in
                           rep["split"] + rep["split_extra"])
            assert "levels.1.0.attn.qkv.weight" in rep["split"]
            assert "pools.0.conv.weight" in rep["split"]
        if kind == "nest_nhwc":
            assert res["level_nhwc"] == [True, False]
        if kind.startswith("vit"):
            assert {"patch_embed.weight", "blocks.0.attn.qkv.weight",
                    "blocks.1.mlp.fc2.weight"} <= set(rep["split"])
        if kind == "resnet_bottleneck":
            assert "stages.1.0.conv2.weight" in rep["split"]
            assert "stages.1.0.ds_conv.weight" in rep["split"]
            assert "stages.1.0.conv3.weight" in rep["split"]
            assert "stages.1.0.conv1.weight" in rep["whole"]
            assert "stages.1.0.bn2.running_var" in rep["split_extra"]


def test_a_tp_run_that_splits_nothing_raises(tmp_path):
    (msg, _) = run_ranks(nothing_splits_worker, 2, tmp_path,
                         model_parallel=2)
    assert msg.startswith("mesh.param_sharding='tp': no layer of the model "
                          "splits over 2 model ranks")
    assert "rather than train replicated" in msg


# --------------------------------------------------------------------------
# the trainer, its checkpoints, serving them and the driver
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trainer_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_trainer"))
    return run_ranks(trainer_worker, 4, tmp, tmp, timeout=300.0,
                     model_parallel=2)


def test_trainer_e2e_under_tp(trainer_ranks):
    """The smoke experiment (ResNet18, fp32) through the driver on the
    (2, 2) mesh under tp: the epoch loss within 1e-3 of the replicated
    run's; every rank reports the same; only the run's files."""
    for out in trainer_ranks:
        rep, tp = out["smoke"]["replicated"], out["smoke"]["tp"]
        key = [k for k in rep if k.endswith("train/loss_mean")]
        assert key, sorted(rep)
        assert tp[key[0]] == tp[key[0]]
        assert abs(tp[key[0]] - rep[key[0]]) < 1e-3
        assert out["smoke"] == trainer_ranks[0]["smoke"]
    assert {"checkpoints", "cv_summary.json", "fold0.done.json",
            "metrics_fold0.jsonl"} <= set(trainer_ranks[0]["files"])
    assert all(out["files"] is None for out in trainer_ranks[1:])


def test_resume_under_tp_reproduces_the_straight_run(trainer_ranks):
    first = trainer_ranks[0]["resume"]
    for out in trainer_ranks:
        res = out["resume"]
        assert res["split"] > 0 and res["start_epoch"] == 1
        assert res["history_first"] + res["history_resumed"] == \
            res["history_straight"]
        for k, v in first["straight_state"].items():
            np.testing.assert_array_equal(res["resumed_state"][k], v,
                                          err_msg=k)
            np.testing.assert_array_equal(res["straight_state"][k], v,
                                          err_msg=k)


def test_tp_checkpoint_serves_on_one_process(trainer_ranks):
    res = trainer_ranks[0]["serve"]
    assert res["format"] == "replicated"
    # the replicated run's shapes: stage 2's convs whole in the file
    assert res["shapes"]["backbone.stages.1.0.conv1.weight"] == \
        (128, 64, 3, 3)
    np.testing.assert_allclose(res["predictor"], res["split"], atol=1e-5,
                               rtol=0)
    assert np.isfinite(res["predictor"]).all()


def test_a_replicated_checkpoint_resumes_under_tp(trainer_ranks):
    """Loaded, a replicated run's ``last`` is the file's state bit for bit
    under both, and so is a tp run's under replicated; then both train
    on."""
    for out in trainer_ranks:
        res = out["cross"]
        assert res["loaded_replicated"] and res["loaded_tp"]
        assert res["tp_file_loaded_replicated"]
        rep, tp = res["history_replicated"], res["history_tp"]
        assert [r["epoch"] for r in rep] == [r["epoch"] for r in tp]
        for a, b in zip(rep, tp):
            assert set(a) == set(b)
            for k in ("train/loss", "val/combined/loss"):
                assert b[k] == pytest.approx(a[k], rel=1e-4), k


def test_vlp_driver_under_tp_matches_replicated(trainer_ranks):
    rep = trainer_ranks[0]["vlp"]["replicated"]
    tp = trainer_ranks[0]["vlp"]["tp"]
    assert set(rep) == set(tp)
    assert any("linear_probe_auroc" in k for k in rep)
    for k in rep:
        assert tp[k] == pytest.approx(rep[k], rel=1e-4, abs=1e-6), k
    for out in trainer_ranks[1:]:
        assert out["vlp"] == trainer_ranks[0]["vlp"]


def test_warm_start_from_a_vlp_checkpoint_under_tp(trainer_ranks):
    for out in trainer_ranks:
        warm = out["warm"]
        assert warm["split"]
        assert set(warm["backbone"]) == set(warm["encoder"])
        for k, v in warm["encoder"].items():
            np.testing.assert_array_equal(warm["backbone"][k], v, err_msg=k)


# --------------------------------------------------------------------------
# the training entry point under the launcher
# --------------------------------------------------------------------------

CLI = ["experiment=baseline_only_imaging_resnet34",
       "model.model=resnet_micro", "data.name=synthetic_downstream",
       "data.image_size=32", "data.batch_size=16", "data.eval_batch_size=8",
       "data.synthetic_num_samples=40", "data.disable_augmentations=true",
       "trainer.precision=fp32", "trainer.max_epochs=1",
       "k_fold_cross_validation=false", "trainer.async_checkpointing=false"]


def _cli(cmd, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, timeout=400,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return proc


@pytest.fixture(scope="module")
def one_process_cli(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_cli") / "one"
    _cli([sys.executable, "-m", "vlp_tpu_torch.train", "--device", "cpu",
          *CLI, f"output_dir={out}"], out.parent)
    with open(out / "cv_summary.json") as fh:
        return json.load(fh)


@pytest.mark.parametrize("mesh", MESHES)
def test_the_cli_trains_under_tp_on_the_launcher(one_process_cli, mesh,
                                                 tmp_path):
    """``python -m torch.distributed.run --nproc_per_node=D*M -m
    vlp_tpu_torch.train --device cpu ... mesh.model_parallel=M
    mesh.param_sharding=tp``: the split is logged once (global rank 0),
    the fold's metrics equal the one-process run's (the counts exactly,
    the rest within 1e-5: the split sums in another order), only rank 0
    writes, and its checkpoint is in the replicated run's format."""
    d, m = mesh
    out = tmp_path / "tp"
    proc = _cli([sys.executable, "-m", "torch.distributed.run",
                 "--standalone", f"--nproc_per_node={d * m}", "-m",
                 "vlp_tpu_torch.train", "--device", "cpu", *CLI,
                 f"mesh.model_parallel={m}", "mesh.param_sharding=tp",
                 f"output_dir={out}"], tmp_path)
    assert len(re.findall(rf"tensor parallelism: \d+ state entries split "
                          rf"over {m} model ranks",
                          proc.stdout + proc.stderr)) == 1
    with open(out / "cv_summary.json") as fh:
        got = json.load(fh)
    for k, want in one_process_cli.items():
        if "time/" in k or "images_per_sec" in k:
            continue
        metric = k.split("_best_")[-1].rsplit("_", 1)[0].split("/")[-1]
        if metric in ("accuracy", "precision", "recall", "f1",
                      "balanced_accuracy", "auroc") or k == "num_folds":
            assert got[k] == want, k
        else:
            assert got[k] == pytest.approx(want, rel=1e-5, abs=1e-7), k
    tree = torch.load(out / "checkpoints" / "fold0" / "last.pt",
                      weights_only=True)
    assert all(isinstance(i, int) for i in tree["optimizer"]["state"])
    assert tuple(tree["model"]["backbone.stages.1.0.conv2.weight"].shape) \
        == (128, 128, 3, 3)
