"""The port's data parallelism (``vlp_tpu_torch/parallel/``) at 2 and 4 gloo
ranks on the CPU, against the JAX package on the same global batch.

Each world size spawns its ranks once per case group
(``torch_parallel_workers.run_ranks``: the ``spawn`` context, a
``FileStore`` rendezvous under ``tmp_path``, a join with a timeout); the
ranks return their values as numpy and the comparisons run here, the JAX
side on a ``create_mesh(data_parallel=N)`` mesh of ``tests/conftest.py``'s
8 CPU devices.

What is held, and to what:
- the collectives' forward values and adjoints (all-gather <->
  reduce-scatter, all-reduce <-> all-reduce) exactly; the convention of
  ``parallel/collectives.py`` that a rank's input gradient of the
  replicated global loss is N times its share;
- the CLIP losses (both ``infonce_impl`` forms, the masked and non-square
  variants, unpadded and with a padded tail on the last ranks), the masked
  BCE with class weights and CORAL: loss within 1e-4 of the JAX value (as
  ``tests/test_parallel.py:21-48``), gradients within 1e-5 of each
  gradient's largest |g| (the same fp32 arithmetic in other orders);
- BatchNorm's output, gradients and running statistics against flax's on
  the global batch within 1e-5 of each one's largest value; the running
  statistics bit-equal across ranks;
- one SGD step of the VLP task (``resnet_micro`` + ``microbert``, both
  ``infonce_impl``s), of the classifier with CORAL and of the fusion task
  against the JAX step on the mesh: loss and parameters within 1e-4 (as
  ``tests/test_parallel.py:51-130``), BatchNorm statistics within 1e-4;
- one AdamW step against the port's own one-process step on the global
  batch: where |g| is significant, within two fp32 ulps plus 1e-5 * lr;
  elsewhere within 2 * lr (Adam's m / sqrt(v) turns rounding noise on
  near-zero gradients into +-lr, ``test_torch_port_train_step.py``);
- three AdamW steps of the pretrain task with augmentation: every
  parameter and buffer bit-equal across ranks;
- the augmented global batch bit-equal to one process's at the global
  batch (the plain #11/#12, an even and an odd width).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import linen as fnn

from torch_parallel_workers import (augment_rows, augment_worker, build,
                                    losses_worker, run_ranks, run_steps,
                                    steps_worker)
from vlp_tpu.config import apply_overrides as japply
from vlp_tpu.config import get_experiment as jget
from vlp_tpu.models.tasks import TaskStatics as JStatics
from vlp_tpu.models.tasks import build_task as jbuild_task
from vlp_tpu.ops import losses as jlosses
from vlp_tpu.ops.augment import AugmentConfig as JAugment
from vlp_tpu.parallel.infonce import global_infonce_shard_map
from vlp_tpu.parallel.mesh import (batch_sharding, create_mesh, replicated,
                                   shard_batch)
from vlp_tpu.train.optim import make_optimizer as jmake_optimizer
from vlp_tpu.train.state import TrainState as JState
from vlp_tpu.train.step import make_train_step as jmake_train_step
from vlp_tpu_torch import convert

WORLDS = (2, 4)
B, E, SIZE, L = 16, 8, 32, 12
TAIL = 3  # padded rows at the end of the global batch
LOSS_ABS = 1e-4
GRAD_REL = 1e-5
STEP_ABS = 1e-4
MEAN, STD, CW = 128.0, 30.0, (0.7, 1.6)


# --------------------------------------------------------------------------
# the collectives, the losses and BatchNorm
# --------------------------------------------------------------------------

def _loss_data():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mask_tail = np.ones(B, np.float32)
    mask_tail[-TAIL:] = 0.0
    return {
        "x": f32(B, 3), "w": f32(B, 3),
        "img": f32(B, E), "txt": f32(B, E), "logit_scale": 2.3,
        "cid": (np.arange(B) % 11).astype(np.int32),
        "ones": np.ones(B, np.float32), "mask_tail": mask_tail,
        "logits": f32(B) * 2, "labels": rng.integers(0, 2, B).astype(
            np.int32), "class_weights": np.asarray(CW, np.float32),
        "feats": f32(B, 6), "domain": (np.arange(B) % 2).astype(np.int32),
        "bn4": f32(B, 5, 3, 2) * 2 + 1, "bn4_scale": f32(5),
        "bn4_bias": f32(5), "bn4_cot": f32(B, 5, 3, 2),
        "bn2": f32(B, 7) * 3 - 1, "bn2_scale": f32(7), "bn2_bias": f32(7),
        "bn2_cot": f32(B, 7),
    }


@functools.lru_cache(maxsize=None)
def _loss_ranks(world, tmp):
    return run_ranks(losses_worker, world, tmp, _loss_data())


@pytest.fixture(scope="module")
def loss_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("losses")
    return lambda world: _loss_ranks(world, str(tmp))


def _rows(world, r):
    b = B // world
    return slice(r * b, (r + 1) * b)


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got) - want).max()) <= rel * scale


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_and_their_adjoints(loss_ranks, world):
    d, ranks = _loss_data(), loss_ranks(world)
    tri = world * (world + 1) / 2
    reduced = sum(d["x"][_rows(world, r)] for r in range(world))
    w_sum = sum(d["w"][_rows(world, r)] for r in range(world))
    for r, out in enumerate(ranks):
        rows = _rows(world, r)
        np.testing.assert_array_equal(out["gather"], d["x"])
        # every rank's loss is the same sum: the adjoint sums N copies
        np.testing.assert_allclose(out["gather_grad"], world * d["w"][rows],
                                   rtol=1e-6)
        np.testing.assert_allclose(out["reduce"], reduced, rtol=1e-6)
        np.testing.assert_allclose(out["reduce_grad"], w_sum, rtol=1e-6)
        np.testing.assert_allclose(out["scatter"], tri * d["x"][rows],
                                   rtol=1e-6)
        np.testing.assert_allclose(out["scatter_grad"], (r + 1) * d["w"],
                                   rtol=1e-6)
        np.testing.assert_array_equal(out["broadcast"], 0.0)


def _jax_clip(variant, mask, d):
    fns = {"symmetric_infonce": lambda lg, c, m: jlosses.symmetric_infonce(
        lg, m), "masked": jlosses.masked_infonce,
        "non_square": jlosses.non_square_infonce}

    def loss(img, txt, ls):
        return fns[variant](jlosses.clip_logits(img, txt, ls, 100.0),
                            jnp.asarray(d["cid"]), jnp.asarray(mask))

    return jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(d["img"]), jnp.asarray(d["txt"]),
        jnp.float32(d["logit_scale"]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", ["symmetric_infonce", "masked",
                                     "non_square"])
@pytest.mark.parametrize("impl", ["gspmd", "shard_map"])
@pytest.mark.parametrize("tail", [False, True], ids=["full", "padded"])
def test_clip_losses_match_jax_on_the_global_batch(loss_ranks, world,
                                                   variant, impl, tail):
    d, ranks = _loss_data(), loss_ranks(world)
    mask = d["mask_tail"] if tail else d["ones"]
    want, (g_img, g_txt, g_scale) = _jax_clip(variant, mask, d)
    if variant == "symmetric_infonce" and impl == "shard_map":
        mesh = create_mesh(data_parallel=world)
        sh = batch_sharding(mesh)
        sm = global_infonce_shard_map(mesh)(
            jax.device_put(jnp.asarray(d["img"]), sh),
            jax.device_put(jnp.asarray(d["txt"]), sh),
            jax.device_put(jnp.float32(np.exp(d["logit_scale"])),
                           replicated(mesh)),
            jax.device_put(jnp.asarray(mask), sh))
        assert abs(float(sm) - float(want)) < LOSS_ABS
    results = [out[("clip", variant, impl, tail)] for out in ranks]
    for r, (loss, gi, gt, _) in enumerate(results):
        assert abs(loss - float(want)) < LOSS_ABS
        assert loss == results[0][0]  # one value on every rank
        rows = _rows(world, r)
        _close(gi / world, np.asarray(g_img)[rows], GRAD_REL)
        _close(gt / world, np.asarray(g_txt)[rows], GRAD_REL)
    scale_grad = sum(res[3] for res in results) / world
    assert scale_grad == pytest.approx(float(g_scale), rel=1e-4, abs=1e-7)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tail", [False, True], ids=["full", "padded"])
def test_masked_bce_with_class_weights_matches_jax(loss_ranks, world, tail):
    d, ranks = _loss_data(), loss_ranks(world)
    labels = jnp.asarray(d["labels"])
    w = jlosses.per_sample_class_weights(labels, CW)
    mask = jnp.asarray(d["mask_tail"]) if tail else None
    want, grad = jax.value_and_grad(
        lambda lg: jlosses.bce_with_logits(lg, labels, w, mask))(
            jnp.asarray(d["logits"]))
    for r, out in enumerate(ranks):
        loss, g = out[("bce", tail)]
        assert abs(loss - float(want)) < LOSS_ABS
        _close(g / world, np.asarray(grad)[_rows(world, r)], GRAD_REL)


@pytest.mark.parametrize("world", WORLDS)
def test_coral_matches_jax_with_global_covariances(loss_ranks, world):
    d, ranks = _loss_data(), loss_ranks(world)
    m, dom = jnp.asarray(d["mask_tail"]), jnp.asarray(d["domain"])
    want, grad = jax.value_and_grad(lambda f: jlosses.coral_loss(
        f, f, m * (dom == 0), m * (dom == 1)))(jnp.asarray(d["feats"]))
    assert float(want) > 0
    for r, out in enumerate(ranks):
        loss, g = out["coral"]
        assert loss == pytest.approx(float(want), rel=1e-5)
        _close(g / world, np.asarray(grad)[_rows(world, r)], GRAD_REL)


def _flax_bn(d, key):
    """flax's train-mode BatchNorm on the global batch (channels last):
    y, (dx, dscale, dbias) of sum(y * cot), and the updated statistics."""
    x = d[key]
    perm = (0, *range(2, x.ndim), 1)
    inv = tuple(np.argsort(perm))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    c = x.shape[1]
    variables = {"params": {"scale": jnp.asarray(d[key + "_scale"]),
                            "bias": jnp.asarray(d[key + "_bias"])},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}

    def f(xx, params):
        y, upd = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          jnp.transpose(xx, perm), mutable=["batch_stats"])
        return jnp.transpose(y, inv), upd

    y, upd = f(jnp.asarray(x), variables["params"])
    _, pull = jax.vjp(lambda xx, p: f(xx, p)[0], jnp.asarray(x),
                      variables["params"])
    dx, dp = pull(jnp.asarray(d[key + "_cot"]))
    return (np.asarray(y), np.asarray(dx), np.asarray(dp["scale"]),
            np.asarray(dp["bias"]), np.asarray(upd["batch_stats"]["mean"]),
            np.asarray(upd["batch_stats"]["var"]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ["bn4", "bn2"], ids=["nchw", "rows"])
def test_batchnorm_global_statistics_match_flax(loss_ranks, world, key):
    d, ranks = _loss_data(), loss_ranks(world)
    y, dx, dscale, dbias, mean, var = _flax_bn(d, key)
    for r, out in enumerate(ranks):
        got = out[key]
        rows = _rows(world, r)
        _close(got["y"], y[rows], 1e-5)
        _close(got["dx"], dx[rows], 1e-5)
        _close(got["mean"], mean, 1e-5)
        _close(got["var"], var, 1e-5)
        np.testing.assert_array_equal(got["mean"], ranks[0][key]["mean"])
        np.testing.assert_array_equal(got["var"], ranks[0][key]["var"])
    # each rank's parameter gradient is its share of the global one
    _close(sum(o[key]["dscale"] for o in ranks), dscale, 1e-5)
    _close(sum(o[key]["dbias"] for o in ranks), dbias, 1e-5)


# --------------------------------------------------------------------------
# train steps against the JAX step on the mesh
# --------------------------------------------------------------------------

MICRO = ["model.model=resnet_micro", "trainer.precision=fp32",
         f"data.image_size={SIZE}", "data.disable_augmentations=true",
         "optimizer.name=sgd", "scheduler.name=none", "optimizer.lr=0.01"]
CASES = {
    "vlp_gspmd": ("pretrain_resnet34_tinybert",
                  MICRO + ["model.text_model=microbert",
                           f"data.max_token_length={L}",
                           "mesh.infonce_impl=gspmd"]),
    "vlp_shard_map": ("pretrain_resnet34_tinybert",
                      MICRO + ["model.text_model=microbert",
                               f"data.max_token_length={L}",
                               "mesh.infonce_impl=shard_map"]),
    "coral": ("baseline_only_imaging_resnet34", MICRO),
    "fusion": ("baseline_fusion_resnet34", MICRO),
}


def _batch(kind, seed=1):
    rng = np.random.default_rng(seed)
    mask = np.ones(B, np.float32)
    mask[-TAIL:] = 0.0
    out = {"image_u8": rng.integers(0, 256, (B, SIZE, SIZE), dtype=np.uint8),
           "label": rng.integers(0, 2, B).astype(np.int32), "mask": mask,
           "dataset_id": (np.arange(B) % 2).astype(np.int32)}
    if kind.startswith("vlp"):
        out.update(input_ids=rng.integers(5, 100, (B, L)).astype(np.int32),
                   attention_mask=(np.arange(L)[None, :] < rng.integers(
                       4, L + 1, (B, 1))).astype(np.int32),
                   caption_id=np.arange(B, dtype=np.int32))
    if kind == "fusion":
        out["clinical"] = rng.standard_normal((B, 15)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """(JAX config, task, variables, the port's spec with those weights)."""
    exp, overrides = CASES[name]
    jcfg = japply(jget(exp), overrides)
    jtask = jbuild_task(jcfg, JStatics(mean=MEAN, std=STD, class_weights=CW,
                                       augment=JAugment(enabled=False)))
    batch = _batch(name)
    variables = jax.device_get(jtask.init_variables(
        jax.random.key(0), jax.tree.map(jnp.asarray, batch)))
    spec = {"experiment": exp, "overrides": overrides, "mean": MEAN,
            "std": STD, "class_weights": CW, "spe": 10, "batch": batch,
            "weights": None}
    task, _, _ = build(spec, None)
    convert.load_weights(task.model, variables)
    spec["weights"] = {k: v.numpy().copy()
                       for k, v in task.model.state_dict().items()}
    return jcfg, jtask, variables, spec, task.model


@functools.lru_cache(maxsize=None)
def _jax_step(name, world):
    jcfg, jtask, variables, spec, model = _jax_case(name)
    params = variables["params"]
    extra = {k: v for k, v in variables.items() if k != "params"}
    tx = jmake_optimizer(jcfg, params, spec["spe"])
    mesh = create_mesh(data_parallel=world)
    state = JState.create(params, extra, tx, jax.random.key(1))
    s, aux = jmake_train_step(jtask, tx, mesh=mesh)(
        jax.device_put(state, replicated(mesh)),
        shard_batch(jax.tree.map(jnp.asarray, spec["batch"]), mesh))
    want = convert.state_dict_from_flax(
        {"params": jax.device_get(s.params), **jax.device_get(
            s.extra_vars)}, model)
    return float(aux["loss"]), {k: v.numpy() for k, v in want.items()}


@functools.lru_cache(maxsize=None)
def _port_steps(world, tmp):
    specs = {name: _jax_case(name)[3] for name in CASES}
    adamw = dict(specs["vlp_gspmd"], overrides=[
        o for o in CASES["vlp_gspmd"][1] if not o.startswith(
            ("optimizer", "scheduler"))] + ["optimizer.lr=0.001"])
    specs["adamw"] = adamw
    specs["three"] = dict(adamw, steps=3, augment=True, weights=None,
                          overrides=[o for o in adamw["overrides"]
                                     if "disable_augmentations" not in o])
    return run_ranks(steps_worker, world, tmp, specs), specs


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("steps")
    return lambda world: _port_steps(world, str(tmp))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_one_step_matches_the_jax_step_on_the_mesh(step_ranks, world, name):
    ranks, _ = step_ranks(world)
    want_loss, want = _jax_step(name, world)
    for out in ranks:
        got = out[name]
        assert abs(got["losses"][0] - want_loss) < STEP_ABS
        assert set(got["state"]) == set(want)
        for k, w in want.items():
            diff = float(np.abs(got["state"][k] - w).max())
            assert diff < STEP_ABS, (k, diff)
    if name == "coral":
        assert ranks[0][name]["aux"]["coral"] > 0


def _check_adamw(name, got, want, grad, lr):
    diff = np.abs(got - want)
    tight = 2 * 2.0 ** -23 * np.abs(want) + 1e-5 * lr
    big = np.abs(grad) > 1e-2 * np.abs(grad).max()
    assert (diff <= tight)[big].all(), name
    assert (diff <= 2 * lr + tight).all(), name


@pytest.mark.parametrize("world", WORLDS)
def test_adamw_step_matches_one_process_on_the_global_batch(step_ranks,
                                                            world):
    ranks, specs = step_ranks(world)
    spec = specs["adamw"]
    one = run_steps(spec, None)
    assert ranks[0]["adamw"]["losses"][0] == pytest.approx(one["losses"][0],
                                                           abs=1e-6)
    lr = 1e-3
    # the reduced gradient is the one-process gradient of the global batch
    assert set(ranks[0]["adamw"]["grads"]) == set(one["grads"])
    for k, g in one["grads"].items():
        _close(ranks[0]["adamw"]["grads"][k], g, 1e-4)
    for k, want in one["state"].items():
        got = ranks[0]["adamw"]["state"][k]
        if k.endswith(("running_mean", "running_var")):
            _close(got, want, 1e-5)
            continue
        _check_adamw(k, got, want, one["grads"][k], lr)


@pytest.mark.parametrize("world", WORLDS)
def test_three_steps_leave_every_rank_bit_equal(step_ranks, world):
    ranks, _ = step_ranks(world)
    first = ranks[0]["three"]
    assert len(first["losses"]) == 3
    assert np.isfinite(first["losses"]).all()
    for out in ranks[1:]:
        assert out["three"]["losses"] == first["losses"]
        for k, v in first["state"].items():
            np.testing.assert_array_equal(out["three"]["state"][k], v,
                                          err_msg=k)


# --------------------------------------------------------------------------
# augmentation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_augmented_global_batch_equals_one_process(world, tmp_path):
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 256, (8, 32, 32), dtype=np.uint8),
               rng.integers(0, 256, (8, 33, 33), dtype=np.uint8)]
    ranks = run_ranks(augment_worker, world, tmp_path, batches, 11)
    for i, images in enumerate(batches):
        want = augment_rows(images, 11, None)
        got = np.concatenate([out[i] for out in ranks])
        np.testing.assert_array_equal(got, want)
        # the draws differ across rows: no two ranks repeat an augmentation
        assert not np.array_equal(ranks[0][i], ranks[1][i])
