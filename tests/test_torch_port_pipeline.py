"""The GPipe schedule of the port (``vlp_tpu_torch/parallel/pipeline.py``)
on gloo ranks on the CPU at (D, n) = (1, 4) and (2, 2), against the JAX
package's ``make_pipeline_fn`` on ``create_pipeline_mesh(n, D)`` and against
the sequential stack, at ``tests/test_pipeline.py``'s sizes (8 real
``EncoderBlock``s, 2 heads, D 16, 6 tokens) in both attention layouts
(flax's, and the fused one with ``attend_qkv``'s plain version), the JAX
blocks' weights carried across by ``convert.load_weights``. One spawn of
the ranks per mesh runs every case. Held: values within 1e-5; each
block's gradients (after ``reduce_gradients`` over the data ranks) within
1e-5 of its largest |g|, so not n times the sequential ones; one SGD
step's loss within 1e-6 of the port's sequential stack's (as
``test_pipeline.py:112-141`` holds JAX's pipeline to JAX's stack; the
losses summed in fp64) and within 1e-6 relative of the JAX pipeline's (the
JAX loss is an fp32 mean, 4.1e-6 from its own fp64 value at this size), and
the parameters within 1e-5; a rank holds its own blocks alone; the stage
hop both ways and along the schedule's chain; the JAX refusals.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_workers import run_ranks
from torch_pp_workers import LR, pipeline_worker
from vlp_tpu.models.vit import EncoderBlock as JBlock
from vlp_tpu.parallel.pipeline import (create_pipeline_mesh as jmesh,
                                       make_pipeline_fn as jpipe,
                                       scan_blocks_stage_fn as jscan,
                                       stack_stage_params,
                                       stage_params_sharding)
from vlp_tpu_torch import convert
from vlp_tpu_torch.models.vit import EncoderBlock
from vlp_tpu_torch.parallel import mesh as tmesh
from vlp_tpu_torch.parallel.pipeline import (make_pipeline_fn,
                                             scan_blocks_stage_fn,
                                             stage_range)

DEPTH, HEADS, DIM, TOK = 8, 2, 16, 6
MESHES = ((1, 4), (2, 2))
LAYOUTS = ("flax", "fused")
# (kind, batch, microbatches, seed): test_pipeline.py's inputs
CASES = {"values": ("values", 8, 4, 0), "grads": ("sum", 4, 2, 1),
         "sgd": ("mse", 4, 2, 3)}


@functools.lru_cache(maxsize=None)
def _jax_blocks(layout):
    block = JBlock(HEADS, 4.0, jnp.float32,
                   fused_attention=layout == "fused", megakernel=False)
    keys = jax.random.split(jax.random.key(0), DEPTH)
    x1 = jnp.zeros((2, TOK, DIM), jnp.float32)
    params = [block.init(k, x1)["params"] for k in keys]
    return params, (lambda p, h: block.apply({"params": p}, h))


def _state(layout, tree):
    """A JAX block's params (or gradients) as the port block's state."""
    block = EncoderBlock(DIM, HEADS, 4.0, fused_attention=layout == "fused",
                         megakernel=False)
    return {k: v.numpy() for k, v in
            convert.state_dict_from_flax({"params": tree}, block).items()}


def _inputs(name):
    kind, batch, m, seed = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, TOK, DIM)).astype(np.float32)
    target = rng.standard_normal((batch, TOK, DIM)).astype(np.float32)
    mb = lambda a: a.reshape((m, batch // m) + a.shape[1:])
    return kind, m, mb(x), mb(target)


@functools.lru_cache(maxsize=None)
def _jax_case(layout, name, d, n):
    """The JAX pipeline's y, loss, gradients and SGD step on its (D, n)
    mesh, and the sequential stack's y."""
    params, apply_fn = _jax_blocks(layout)
    kind, m, x, target = _inputs(name)
    mesh = jmesh(n, data_parallel=d)
    stacked = stack_stage_params(params, n)
    stacked = jax.tree.map(jax.device_put, stacked,
                           stage_params_sharding(stacked, mesh))
    pipe = jpipe(jscan(apply_fn), mesh, n, n_microbatches=m)

    def loss(sp, xx):
        y = pipe(sp, xx)
        if kind == "sum":
            return jnp.sum(y * target), y
        return jnp.mean((y - target) ** 2), y

    (value, y), (grads, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, jnp.asarray(x))
    seq = jnp.asarray(x.reshape((-1,) + x.shape[2:]))
    for p in params:
        seq = apply_fn(p, seq)
    per = lambda tree, i: jax.tree.map(lambda a: np.asarray(a)[
        i // (DEPTH // n), i % (DEPTH // n)], tree)
    new = jax.tree.map(lambda p, g: p - LR * g, stacked, grads)
    return {"y": np.asarray(y), "seq": np.asarray(seq).reshape(y.shape),
            "loss": float(value), "dx": np.asarray(dx),
            "grads": [_state(layout, per(grads, i)) for i in range(DEPTH)],
            "params": [_state(layout, per(new, i)) for i in range(DEPTH)]}


@functools.lru_cache(maxsize=None)
def _port(d, n, tmp):
    cases = {}
    for layout in LAYOUTS:
        params, _ = _jax_blocks(layout)
        blocks = [_state(layout, p) for p in params]
        for name in CASES:
            kind, m, x, target = _inputs(name)
            cases[f"{layout}-{name}"] = dict(
                layout=layout, dim=DIM, heads=HEADS, blocks=blocks, kind=kind,
                m=m, x=x, target=target)
    return run_ranks(pipeline_worker, d * n, tmp, cases, model_parallel=n,
                     axis="stage")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    return lambda mesh: _port(*mesh, str(tmp))


def _rel(got, want, rel):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


def _rows(d, rank, batch):
    b = batch // d
    return slice(rank * b, (rank + 1) * b)


def _stage_ranks(ranks, d, n):
    """(data rank, stage rank, result) of every rank."""
    return [(g // n, g % n, r) for g, r in enumerate(ranks)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pipeline_matches_jax_and_sequential(port, mesh, layout):
    d, n = mesh
    ranks = port(mesh)
    want = _jax_case(layout, "values", d, n)
    np.testing.assert_allclose(want["y"], want["seq"], atol=1e-5)
    for dr, _, res in _stage_ranks(ranks, d, n):
        rows = _rows(d, dr, want["y"].shape[1])
        got = res[f"{layout}-values"]["y"]
        np.testing.assert_allclose(got, want["y"][:, rows], atol=1e-5)
        np.testing.assert_allclose(got, want["seq"][:, rows], atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pipeline_grads_match_jax(port, mesh, layout):
    """Each block's gradient once, from the rank that holds it, equal on
    every data rank; the input's on every stage rank."""
    d, n = mesh
    ranks = port(mesh)
    want = _jax_case(layout, "grads", d, n)
    seen = set()
    for dr, s, res in _stage_ranks(ranks, d, n):
        r = res[f"{layout}-grads"]
        assert r["index"] == list(stage_range(DEPTH, n, s))
        assert r["loss"] == pytest.approx(want["loss"], rel=1e-5)
        for key, g in r["grads"].items():
            i, leaf = key.split(".", 1)
            _rel(g, want["grads"][int(i)][leaf], 1e-5)
            seen.add(key)
        rows = _rows(d, dr, want["dx"].shape[1])
        # the data ranks' losses are one all-reduced sum: x's gradient on
        # a rank is D times its rows' share
        _rel(r["dx"] / d, want["dx"][:, rows], 1e-5)
    assert len(seen) == sum(len(g) for g in want["grads"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pipeline_one_sgd_step_matches(port, mesh, layout):
    d, n = mesh
    ranks = port(mesh)
    want = _jax_case(layout, "sgd", d, n)
    worst = 0.0
    for _, _, res in _stage_ranks(ranks, d, n):
        r = res[f"{layout}-sgd"]
        assert abs(r["loss"] - r["seq_loss"]) < 1e-6
        assert abs(r["loss"] - want["loss"]) < 1e-6 * abs(want["loss"])
        for key, p in r["params"].items():
            i, leaf = key.split(".", 1)
            worst = max(worst, float(np.abs(
                p - want["params"][int(i)][leaf]).max()))
    assert worst < 1e-5, f"post-step divergence {worst}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_a_stage_rank_holds_its_blocks_alone(port, mesh):
    d, n = mesh
    ranks = port(mesh)
    whole = sum(v.size for v in _state("flax", _jax_blocks("flax")[0][0])
                .values()) * DEPTH
    for _, _, res in _stage_ranks(ranks, d, n):
        assert res["flax-values"]["held"] * n == whole


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_hop_forward_and_back(port, mesh):
    d, n = mesh
    for _, s, res in _stage_ranks(port(mesh), d, n):
        hop = res["hops"]
        assert hop["fwd"] == [float((s - 1) % n + 1)] * 3
        assert hop["back"] == [float((s + 1) % n + 10)] * 3
        assert hop["chain"] == (None if s == 0 else [float(s)] * 3)


def test_pipeline_validation_errors():
    with pytest.raises(ValueError, match="devices"):
        tmesh.create_pipeline_mesh(4, data_parallel=4, device="cpu",
                                   init_method="file:///nonexistent",
                                   rank=0, world_size=8)
    with pytest.raises(ValueError, match=r"needs 1x2=2 devices, have 1"):
        tmesh.create_pipeline_mesh(2, device="cpu")
    fake = tmesh.Mesh(rank=0, world=1, device=torch.device("cpu"),
                      model_world=4, second_axis="stage")
    with pytest.raises(ValueError, match="n_stages"):
        make_pipeline_fn(lambda p, h: h, fake, 2, 2)
    with pytest.raises(ValueError, match="n_microbatches"):
        make_pipeline_fn(lambda p, h: h, fake, 4, 0)
    with pytest.raises(ValueError, match="divisible"):
        stage_range(6, 4, 0)
    one = make_pipeline_fn(scan_blocks_stage_fn(), None, 1, 2)
    with pytest.raises(ValueError, match="microbatches"):
        one(torch.nn.ModuleList(), torch.zeros(3, 2, TOK, DIM))
    seq = tmesh.Mesh(rank=0, world=1, device=torch.device("cpu"),
                     model_world=4, second_axis="seq")
    with pytest.raises(ValueError, match="'stage'"):
        make_pipeline_fn(lambda p, h: h, seq, 4, 2)
