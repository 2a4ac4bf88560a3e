"""Sequence parallelism in the port (``vlp_tpu_torch/parallel/sequence.py``
and the blocks' token-parallel route, ``models/vit.py``) on gloo ranks on
the CPU at (D, n) = (1, 4) and (2, 2), against the JAX package's
``make_seq_parallel_fn`` on ``create_seq_mesh(n, D)`` and against the
sequential stack, at ``tests/test_sequence_parallel.py``'s sizes (2 real
``EncoderBlock``s, 2 heads, D 16, 8 tokens) in both attention layouts, the
JAX blocks' weights carried across by ``convert.load_weights``. One spawn
of the ranks per mesh runs every case. Held: the ranks' token rows of y
within 1e-5 of the JAX result and of the sequential stack's; x's
gradient within 1e-5 and each block's gradient (``reduce_seq_gradients``)
within 1e-5 of its largest |g|; one SGD step's loss within 1e-6 of the
port's sequential stack's and 1e-6 relative of JAX's, the parameters
within 1e-5; one all-gather a block forward and one reduce-scatter a
block backward (``test_seq_parallel_inserts_collectives``); the route
lasts one call (the blocks called plainly afterwards run the whole
sequence, with no collective); the refusals.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_workers import run_ranks
from torch_pp_workers import LR, sequence_worker
from vlp_tpu.models.vit import EncoderBlock as JBlock
from vlp_tpu.parallel.sequence import (create_seq_mesh as jmesh,
                                       make_seq_parallel_fn as jsp,
                                       token_sharding as jsharding)
from vlp_tpu_torch import convert
from vlp_tpu_torch.models.vit import EncoderBlock
from vlp_tpu_torch.parallel import mesh as tmesh
from vlp_tpu_torch.parallel.sequence import (make_seq_parallel_fn,
                                             token_sharding)

DEPTH, HEADS, DIM, TOK = 2, 2, 16, 8
MESHES = ((1, 4), (2, 2))
LAYOUTS = ("flax", "fused")
# (kind, batch, seed)
CASES = {"values": ("values", 4, 0), "grads": ("sum", 4, 1),
         "sgd": ("mse", 4, 3)}


@functools.lru_cache(maxsize=None)
def _jax_blocks(layout):
    block = JBlock(HEADS, 4.0, jnp.float32,
                   fused_attention=layout == "fused", megakernel=False)
    keys = jax.random.split(jax.random.key(0), DEPTH)
    x1 = jnp.zeros((2, TOK, DIM), jnp.float32)
    params = [block.init(k, x1)["params"] for k in keys]
    return params, (lambda p, h: block.apply({"params": p}, h))


def _state(layout, tree):
    block = EncoderBlock(DIM, HEADS, 4.0, fused_attention=layout == "fused",
                         megakernel=False)
    return {k: v.numpy() for k, v in
            convert.state_dict_from_flax({"params": tree}, block).items()}


def _inputs(name):
    kind, batch, seed = CASES[name]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, TOK, DIM)).astype(np.float32)
    target = rng.standard_normal((batch, TOK, DIM)).astype(np.float32)
    return kind, x, target


@functools.lru_cache(maxsize=None)
def _jax_case(layout, name, d, n):
    params, apply_fn = _jax_blocks(layout)
    kind, x, target = _inputs(name)
    mesh = jmesh(n, data_parallel=d)
    sp = jsp(apply_fn, mesh)

    def loss(plist, xx):
        y = sp(plist, xx)
        if kind == "sum":
            return jnp.sum(y * target), y
        return jnp.mean((y - target) ** 2), y

    xs = jax.device_put(jnp.asarray(x), jsharding(mesh))
    (value, y), (grads, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, xs)
    seq = jnp.asarray(x)
    for p in params:
        seq = apply_fn(p, seq)
    new = jax.tree.map(lambda p, g: p - LR * g, params, grads)
    return {"y": np.asarray(y), "seq": np.asarray(seq), "loss": float(value),
            "dx": np.asarray(dx),
            "grads": [_state(layout, g) for g in grads],
            "params": [_state(layout, p) for p in new]}


@functools.lru_cache(maxsize=None)
def _port(d, n, tmp):
    cases = {}
    for layout in LAYOUTS:
        blocks = [_state(layout, p) for p in _jax_blocks(layout)[0]]
        for name in CASES:
            kind, x, target = _inputs(name)
            cases[f"{layout}-{name}"] = dict(
                layout=layout, dim=DIM, heads=HEADS, blocks=blocks, kind=kind,
                x=x, target=target)
    return run_ranks(sequence_worker, d * n, tmp, cases, model_parallel=n,
                     axis="seq")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sequence")
    return lambda mesh: _port(*mesh, str(tmp))


def _rel(got, want, rel):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"{err} > {rel} x {scale}"


def _block_of(d, n, g, batch):
    """(rows, tokens) of global rank g's token block."""
    dr, sr = g // n, g % n
    b, t = batch // d, TOK // n
    return slice(dr * b, (dr + 1) * b), slice(sr * t, (sr + 1) * t)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_seq_parallel_matches_jax_and_sequential(port, mesh, layout):
    d, n = mesh
    want = _jax_case(layout, "values", d, n)
    np.testing.assert_allclose(want["y"], want["seq"], atol=1e-5)
    for g, res in enumerate(port(mesh)):
        rows, toks = _block_of(d, n, g, want["y"].shape[0])
        got = res[f"{layout}-values"]["y"]
        np.testing.assert_allclose(got, want["y"][rows, toks], atol=1e-5)
        np.testing.assert_allclose(got, want["seq"][rows, toks], atol=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_seq_parallel_grads_match_jax(port, mesh, layout):
    d, n = mesh
    want = _jax_case(layout, "grads", d, n)
    losses = {}
    for g, res in enumerate(port(mesh)):
        r = res[f"{layout}-grads"]
        losses.setdefault(g // n, []).append(r["loss"])
        for key, grad in r["grads"].items():
            i, leaf = key.split(".", 1)
            _rel(grad, want["grads"][int(i)][leaf], 1e-5)
        rows, toks = _block_of(d, n, g, want["dx"].shape[0])
        # the rank's own tokens in full; the data ranks' losses are one
        # all-reduced sum, so D times
        _rel(r["dx"][rows, toks] / d, want["dx"][rows, toks], 1e-5)
        others = np.ones(r["dx"].shape, bool)
        others[rows, toks] = False
        assert not r["dx"][others].any()
    # each seq rank's loss is its tokens' share
    for shares in losses.values():
        assert sum(shares) == pytest.approx(want["loss"], rel=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_seq_parallel_one_sgd_step_matches(port, mesh, layout):
    d, n = mesh
    want = _jax_case(layout, "sgd", d, n)
    shares, seq, worst = {}, {}, 0.0
    for g, res in enumerate(port(mesh)):
        r = res[f"{layout}-sgd"]
        shares.setdefault(g // n, []).append(r["loss"])
        seq.setdefault(g // n, []).append(r["seq_loss"])
        for key, p in r["params"].items():
            i, leaf = key.split(".", 1)
            worst = max(worst, float(np.abs(
                p - want["params"][int(i)][leaf]).max()))
    for dr, parts in shares.items():
        assert abs(sum(parts) - sum(seq[dr])) < 1e-6
        assert abs(sum(parts) - want["loss"]) < 1e-6 * abs(want["loss"])
    assert worst < 1e-5, f"post-step divergence {worst}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_seq_parallel_runs_one_gather_and_one_scatter_a_block(port, mesh,
                                                              layout):
    for res in port(mesh):
        assert res[f"{layout}-grads"]["counts"] == {
            "all_gather": DEPTH, "reduce_scatter": DEPTH}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_token_parallel_route_lasts_one_call(port, mesh, layout):
    """The blocks called plainly after ``fn`` run the whole sequence on
    the rank, with no sequence collective."""
    want = _jax_case(layout, "values", *mesh)
    for res in port(mesh):
        r = res[f"{layout}-values"]
        assert r["plain_collectives"] == {"all_gather": 0,
                                          "reduce_scatter": 0}
        np.testing.assert_allclose(r["plain"], want["seq"], atol=1e-5)


def test_seq_parallel_validation_errors():
    with pytest.raises(ValueError, match="devices"):
        tmesh.create_seq_mesh(4, data_parallel=4, device="cpu",
                              init_method="file:///nonexistent", rank=0,
                              world_size=8)
    fake = tmesh.Mesh(rank=0, world=1, device=torch.device("cpu"),
                      model_world=4, second_axis="seq")
    with pytest.raises(ValueError, match="seq"):
        make_seq_parallel_fn(tmesh.Mesh(rank=0, world=1,
                                        device=torch.device("cpu"),
                                        model_world=2))
    fn = make_seq_parallel_fn(fake)
    with pytest.raises(ValueError, match="divisible"):
        fn([], torch.zeros(2, 6, 8))  # T=6 % 4 != 0
    with pytest.raises(ValueError, match="B, T, D"):
        fn([], torch.zeros(2, 8))
    with pytest.raises(ValueError, match="divisible"):
        token_sharding(torch.zeros(2, 6, 8), fake)
