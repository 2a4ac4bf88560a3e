"""``mesh.param_sharding=fsdp`` in the port (``vlp_tpu_torch/parallel/
fsdp.py``) at 2 and 4 gloo ranks on the CPU, against the JAX package's
FSDP placement and step (``vlp_tpu/parallel/mesh.py:95-139``) and against
the port's replicated data-parallel step.

One spawn of the ranks per world size runs the steps
(``torch_parallel_workers.run_steps`` on the cases of
``test_torch_port_parallel.py``, with the override added), one more the
trainer, the checkpoints and the driver. What is held, and to what:

- one SGD step of the VLP (``gspmd``), the classifier with CORAL and the
  fusion task against the JAX step on
  ``shard_train_state(..., "fsdp")``: loss and gathered parameters within
  1e-4 (``tests/test_parallel.py:119-136``);
- one AdamW step against the port's replicated DP step on the same ranks:
  the data-parallel tests' rule (``test_torch_port_parallel._check_adamw``);
  the gradients within 1e-4 of each one's largest |g|;
- three AdamW steps with augmentation: every rank's gathered state
  bit-equal;
- the elements a rank holds of the parameters plus the AdamW moments equal
  to the JAX state's addressable elements, summed over the leaves; the
  sharded parameters the ones ``_fsdp_spec`` shards;
- the trainer under fsdp resumed from ``last`` reproducing the straight
  run's metrics bit for bit, and its gathered weights;
- its best checkpoint (the replicated run's format) served by a one-process
  ``Predictor``: logits equal to the sharded model's eval forward within
  1e-6;
- the k-fold driver under fsdp (the counterpart of
  ``tests/test_e2e.py:133``), and a checkpoint of the replicated run
  resumed under fsdp: the state after the load bit-equal to the file's,
  the losses after within 1e-4;
- the VLP driver under fsdp against the replicated one: the linear probe
  every epoch and the downstream precision@k of the reloaded best
  checkpoint, each equal; a classifier under fsdp warm-started from that
  checkpoint: its gathered backbone, when ``fit`` starts, the checkpoint's
  image tower bit for bit;
- the train step's reduction spans under fsdp: the reduce-scatters
  counted beside the all-reduce.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_port_parallel import CASES, WORLDS, _check_adamw, _jax_case
from torch_parallel_workers import (fsdp_trainer_worker, run_ranks,
                                    run_steps, steps_worker)
from vlp_tpu.parallel.mesh import _fsdp_spec, create_mesh, shard_batch
from vlp_tpu.parallel.mesh import shard_train_state
from vlp_tpu.train.optim import make_optimizer as jmake_optimizer
from vlp_tpu.train.state import TrainState as JState
from vlp_tpu.train.step import make_train_step as jmake_train_step
from vlp_tpu_torch import convert
from vlp_tpu_torch.parallel.fsdp import MIN_SIZE, shard_dim

FSDP = "mesh.param_sharding=fsdp"
STEP_ABS = 1e-4
SGD_CASES = ("vlp_gspmd", "coral", "fusion")
ADAMW = ["optimizer.name=adamw", "optimizer.lr=0.001"]


def _fsdp(spec, **kw):
    return dict(spec, overrides=list(spec["overrides"]) + [FSDP], **kw)


def _adamw(spec):
    return dict(spec, overrides=[o for o in spec["overrides"]
                                 if not o.startswith(("optimizer",
                                                      "scheduler"))] + ADAMW)


@functools.lru_cache(maxsize=None)
def _port_steps(world, tmp):
    base = {name: _jax_case(name)[3] for name in SGD_CASES}
    specs = {name: _fsdp(spec) for name, spec in base.items()}
    adamw = _adamw(base["vlp_gspmd"])
    specs["adamw"] = _fsdp(adamw, elements=True, spans=True)
    specs["adamw_replicated"] = dict(adamw, spans=True)
    specs["three"] = _fsdp(dict(adamw, overrides=[
        o for o in adamw["overrides"] if "disable_augmentations" not in o]),
        steps=3, augment=True, weights=None)
    return run_ranks(steps_worker, world, tmp, specs), specs


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_steps")
    return lambda world: _port_steps(world, str(tmp))


def _jax_state(name, world, optimizer_overrides=()):
    """(JAX config, task, spec, the TrainState placed on the fsdp mesh,
    its shardings, the mesh)."""
    jcfg, jtask, variables, spec, _ = _jax_case(name)
    if optimizer_overrides:
        from vlp_tpu.config import apply_overrides as japply

        jcfg = japply(jcfg, list(optimizer_overrides))
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    tx = jmake_optimizer(jcfg, params, spec["spe"])
    mesh = create_mesh(data_parallel=world)
    state, shardings = shard_train_state(
        JState.create(params, extra, tx, jax.random.key(1)), mesh, "fsdp")
    return jtask, tx, spec, state, shardings, mesh


@functools.lru_cache(maxsize=None)
def _jax_fsdp_step(name, world):
    jtask, tx, spec, state, shardings, mesh = _jax_state(name, world)
    s, aux = jmake_train_step(jtask, tx, mesh=mesh,
                              state_shardings=shardings)(
        state, shard_batch(jax.tree.map(jnp.asarray, spec["batch"]), mesh))
    model = _jax_case(name)[4]
    want = convert.state_dict_from_flax(
        {"params": jax.device_get(s.params),
         **jax.device_get(s.extra_vars)}, model)
    return float(aux["loss"]), {k: v.numpy() for k, v in want.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", SGD_CASES)
def test_one_sgd_step_matches_the_jax_fsdp_step(step_ranks, world, name):
    ranks, _ = step_ranks(world)
    want_loss, want = _jax_fsdp_step(name, world)
    for out in ranks:
        got = out[name]
        assert abs(got["losses"][0] - want_loss) < STEP_ABS
        assert set(got["state"]) == set(want)
        for k, w in want.items():
            diff = float(np.abs(got["state"][k] - w).max())
            assert diff < STEP_ABS, (k, diff)


@pytest.mark.parametrize("world", WORLDS)
def test_adamw_step_matches_the_replicated_dp_step(step_ranks, world):
    ranks, _ = step_ranks(world)
    got, one = ranks[0]["adamw"], ranks[0]["adamw_replicated"]
    assert got["losses"][0] == pytest.approx(one["losses"][0], abs=1e-6)
    assert set(got["grads"]) == set(one["grads"])
    for k, g in one["grads"].items():
        scale = max(float(np.abs(g).max()), 1e-12)
        assert float(np.abs(got["grads"][k] - g).max()) <= 1e-4 * scale, k
    for k, want in one["state"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][k], want, atol=1e-5,
                                       rtol=0, err_msg=k)
            continue
        _check_adamw(k, got["state"][k], want, one["grads"][k], 1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_three_steps_leave_every_rank_bit_equal(step_ranks, world):
    ranks, _ = step_ranks(world)
    first = ranks[0]["three"]
    assert len(first["losses"]) == 3 and np.isfinite(first["losses"]).all()
    for out in ranks[1:]:
        assert out["three"]["losses"] == first["losses"]
        for k, v in first["state"].items():
            np.testing.assert_array_equal(out["three"]["state"][k], v,
                                          err_msg=k)


def _packed(flax_key):
    """The port's name of a flax leaf (q, k and v map to the packed
    qkv)."""
    return convert.torch_key(re.sub(r"/attn/(query|key|value)/",
                                    "/attn/qkv/", flax_key))


@functools.lru_cache(maxsize=None)
def _jax_placement(world):
    """(elements a device holds of the parameters plus the Adam moments,
    the port names of the leaves ``_fsdp_spec`` shards, of the replicated
    ones) of the VLP case's AdamW state on the fsdp mesh."""
    _, _, _, state, _, _ = _jax_state("vlp_gspmd", world, ADAMW)
    params = convert.flatten({"params": jax.device_get(state.params)})
    sharded = {_packed(k) for k, v in params.items()
               if _fsdp_spec(v.shape, world, "data") != jax.sharding
               .PartitionSpec()}
    kept = {_packed(k) for k in params} - sharded

    def local(leaves):
        return sum(leaf.addressable_shards[0].data.size for leaf in leaves)

    moments = [leaf for path, leaf in jax.tree_util.tree_flatten_with_path(
        state.opt_state)[0] if any(getattr(k, "name", None) in ("mu", "nu")
                                   for k in path)]
    return (local(jax.tree.leaves(state.params)) + local(moments), sharded,
            kept)


@pytest.mark.parametrize("world", WORLDS)
def test_per_rank_elements_and_split_match_the_jax_placement(step_ranks,
                                                             world):
    ranks, _ = step_ranks(world)
    elements, sharded, kept = _jax_placement(world)
    assert sharded and kept
    for out in ranks:
        params, moments = out["adamw"]["elements"]
        assert params + moments == elements
        assert set(out["adamw"]["sharded"]) == sharded
        assert not set(out["adamw"]["sharded"]) & kept


@pytest.mark.parametrize("world", WORLDS)
def test_reduction_spans_count_the_reduce_scatters(step_ranks, world):
    """Under fsdp a step's reduction spans are one a unit's reduce-scatter,
    recorded inside the backward, then the replicated leaves' all-reduce;
    the replicated step has the all-reduce alone."""
    for out in step_ranks(world)[0]:
        assert [len(s) for s in out["adamw_replicated"]["spans"]] == [1]
        (spans,) = out["adamw"]["spans"]
        assert out["adamw"]["scatter_units"] >= 2
        assert len(spans) == out["adamw"]["scatter_units"] + 1
        order = [t for span in spans for t in span]
        assert order == sorted(order) and len(set(order)) == len(order)


def test_shard_dim_is_the_jax_rule():
    for shape in [(), (7,), (256, 256), (3, 3, 64, 128), (30522, 64),
                  (65536,), (65535,), (2, 32768), (96, 384, 3, 3),
                  (1, 4, 196, 96), (33, 3, 661)]:
        for world in (1, 2, 3, 4, 8):
            spec = _fsdp_spec(shape, world, "data")
            dim = shard_dim(shape, world)
            assert (dim is None) == (spec == jax.sharding.PartitionSpec())
            if dim is not None:
                assert spec[dim] == "data"
    assert MIN_SIZE == 2 ** 16


# --------------------------------------------------------------------------
# the trainer, its checkpoints, serving them and the driver
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _trainer_ranks(world, tmp):
    return run_ranks(fsdp_trainer_worker, world, tmp, tmp, timeout=300.0)


@pytest.fixture(scope="module")
def trainer_ranks(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _trainer_ranks(
                world, str(tmp_path_factory.mktemp(f"fsdp_trainer{world}")))
        return cache[world]

    return get


@pytest.mark.parametrize("world", WORLDS)
def test_resume_under_fsdp_reproduces_the_straight_run(trainer_ranks, world):
    ranks = trainer_ranks(world)
    for out in ranks:
        res = out["resume"]
        assert res["sharded"] > 0
        assert res["history_first"] + res["history_resumed"] == \
            res["history_straight"]
        assert res["start_epoch"] == 1
    first = ranks[0]["resume"]
    for k, v in first["straight_state"].items():
        np.testing.assert_array_equal(first["resumed_state"][k], v,
                                      err_msg=k)
    for out in ranks[1:]:  # every rank's gathered weights
        for k, v in first["straight_state"].items():
            np.testing.assert_array_equal(out["resume"]["straight_state"][k],
                                          v, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_fsdp_checkpoint_serves_on_one_process(trainer_ranks, world):
    res = trainer_ranks(world)[0]["serve"]
    assert res["format"] == "replicated"
    np.testing.assert_allclose(res["predictor"], res["sharded"], atol=1e-6,
                               rtol=0)
    assert np.isfinite(res["predictor"]).all()


@pytest.mark.parametrize("world", WORLDS)
def test_kfold_driver_runs_under_fsdp(trainer_ranks, world):
    ranks = trainer_ranks(world)
    agg = ranks[0]["driver"]
    assert agg["num_folds"] == 2
    assert "val/combined/accuracy_best_val/combined/accuracy_mean" in agg
    untimed = {k: v for k, v in agg.items() if not k.startswith("time/")}
    for out in ranks[1:]:  # the same metrics on every rank
        assert {k: v for k, v in out["driver"].items()
                if not k.startswith("time/")} == untimed
    assert ranks[0]["driver_files"] == ["cv_summary.json", "fold0.done.json",
                                        "fold1.done.json"]


@pytest.mark.parametrize("world", WORLDS)
def test_a_replicated_checkpoint_resumes_under_fsdp(trainer_ranks, world):
    """The state each run holds after loading a replicated run's ``last``
    is the file's, bit for bit; then both train on. The sharded gradients'
    reduce-scatter sums the ranks in another order than the all-reduce,
    so at 4 ranks the losses may part by rounding: within 1e-4."""
    res = trainer_ranks(world)[0]["cross"]
    assert res["loaded_replicated"] and res["loaded_fsdp"]
    rep, fsdp = res["history_replicated"], res["history_fsdp"]
    assert [r["epoch"] for r in rep] == [r["epoch"] for r in fsdp]
    for a, b in zip(rep, fsdp):
        assert set(a) == set(b)
        for k in ("train/loss", "val/combined/loss"):
            assert b[k] == pytest.approx(a[k], rel=1e-4), k


@pytest.mark.parametrize("world", WORLDS)
def test_vlp_probe_and_precision_at_k_under_fsdp_match_replicated(
        trainer_ranks, world):
    """The VLP trainer's every-epoch linear probe and the driver's
    precision@k over the reloaded best run every forward on every rank;
    their metrics, and the losses, against the replicated run's."""
    ranks = trainer_ranks(world)
    rep, fsdp = ranks[0]["vlp"]["replicated"], ranks[0]["vlp"]["fsdp"]
    assert set(rep) == set(fsdp)
    probe = [k for k in rep if "linear_probe" in k or "precision_at" in k]
    assert any(k.startswith("downstream_entire/label_precision_at")
               for k in probe)
    assert any("linear_probe_auroc" in k for k in probe)
    for k in rep:
        if k in probe:
            assert fsdp[k] == pytest.approx(rep[k], abs=1e-6), k
        else:
            assert fsdp[k] == pytest.approx(rep[k], rel=1e-4), k
    for out in ranks[1:]:  # every rank reports the same
        assert out["vlp"] == ranks[0]["vlp"]


@pytest.mark.parametrize("world", WORLDS)
def test_warm_start_from_a_vlp_checkpoint_under_fsdp(trainer_ranks, world):
    for out in trainer_ranks(world):
        warm = out["warm"]
        assert warm["sharded"]
        assert set(warm["backbone"]) == set(warm["encoder"])
        for k, v in warm["encoder"].items():
            np.testing.assert_array_equal(warm["backbone"][k], v, err_msg=k)
