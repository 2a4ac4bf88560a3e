"""The collectives that GSPMD inserts on the JAX package's ``('data',)``
mesh and on the model axis of its ``('data', 'model')`` mesh, as autograd
functions over ``torch.distributed`` (no JAX counterpart: there they are
implicit).

The data axis's convention (``mesh.group``, N = ``mesh.world`` data
ranks), held by ``tests/test_torch_port_parallel.py``:

- Every rank computes the global-batch loss L: the same value on every
  rank, from its own rows and what the collectives bring it.
- Each collective's backward is its adjoint: an all-gather's is a
  reduce-scatter sum, an all-reduce's an all-reduce sum, a reduce-scatter's
  an all-gather. Autograd then differentiates sum_r L_r = N L, and rank r's
  parameter gradient is its part of N dL/dtheta.
- ``reduce_gradients`` all-reduces the parameter gradients and divides by
  N. **The gradient that the optimizer applies on every rank is then the
  single-process gradient of the global-batch loss**, the same on every
  rank (an all-reduce gives every rank one result).

So a loss may mix the forms freely: a replicated computation on gathered
values, a row block reduced by an all-reduce, BatchNorm's all-reduced
statistics. ``torch.distributed.nn.functional`` is not used.

The model axis (``mesh.model_group``, the M ranks that hold the same rows
and one shard each of the tensor-parallel weights, ``parallel/tp.py``)
takes Megatron's convention instead: every model rank computes the same
replicated activations and the same loss, and a replicated tensor's
gradient is the whole one on every model rank. ``copy_to_model`` (the
identity; backward: the sum over the model ranks) stands before a layer
whose weight is split by columns, since each rank's columns give only a
part of its input's gradient; ``reduce_from_model`` (the sum; backward:
the identity) after a layer split by rows; ``gather_from_model`` (the
model ranks' blocks in order; backward: this rank's block) after a layer
whose output is split.

The pipeline's stage axis and the sequence's token axis (the second axis
of ``create_pipeline_mesh`` / ``create_seq_mesh``, ``mesh.model_group``
there too) have their own: ``hop`` sends a tensor to the next (or the
previous) stage rank and receives the one from the other side, without a
gradient (the pipeline's autograd Function runs the hops of its backward
the other way, the adjoint of ``lax.ppermute``: ``parallel/pipeline.py``),
and ``seq_gather`` assembles every seq rank's token block along dim 1
(backward: the reduce-scatter sum over the seq ranks). On NCCL a hop is one
``batch_isend_irecv``; gloo takes no point-to-point operation on a CUDA
tensor (its send fails on the device pointer), so there the hop goes
through a host copy of each tensor, while gloo's collectives take CUDA
tensors as they are.

The functions without a gradient (``gather_rows``, ``all_reduce_``,
``broadcast_module``) serve the metrics, the evaluation and the setup; the
broadcasts run over the whole world, from global rank 0. On one rank of no
mesh (``mesh`` None) every function is the identity.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

from vlp_tpu_torch.parallel.mesh import Mesh

# torch 2.13 renames the tensor forms; older releases have only these
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((x.shape[0] * mesh.world, *x.shape[1:]))
    _all_gather(out, x, group=mesh.group)
    return out


def _scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // mesh.world, *x.shape[1:]))
    _reduce_scatter(out, x, group=mesh.group)
    return out


def _reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=mesh.group)
    return x


class AllGather(torch.autograd.Function):
    """[b, ...] on each rank -> [N b, ...] in rank order; backward:
    reduce-scatter sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh), None


class AllReduce(torch.autograd.Function):
    """The sum over ranks; backward: the sum over ranks."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh), None


class ReduceScatter(torch.autograd.Function):
    """[N b, ...] on each rank -> this rank's [b, ...] of the sum over
    ranks; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _scatter(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh), None


# while a list, each model-axis collective appends to it the (start, end)
# CUDA events recorded around it (the step's model-axis time is the sum of
# their spans); so each stage hop and each sequence gather or reduce-scatter
# to its own list
model_axis_events: Optional[list] = None
stage_axis_events: Optional[list] = None
seq_axis_events: Optional[list] = None
# the sequence axis's collectives since the last reset_seq_counts()
seq_counts = {"all_gather": 0, "reduce_scatter": 0}


def _timed(fn, axis: str = "model"):
    events = globals()[f"{axis}_axis_events"]
    if events is None:
        return fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    events.append((start, end))
    return out


def _model_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    _timed(lambda: dist.all_reduce(x, group=mesh.model_group))
    return x


def model_slice(x: torch.Tensor, dim: int, groups: int, rank: int,
                world: int) -> torch.Tensor:
    """Model rank ``rank``'s share of ``x`` along ``dim``: the dim viewed
    as ``[groups, world, n / (groups world)]``, block ``[:, rank]`` (a
    packed q|k|v has 3 groups, so a rank holds its heads' q, k and v)."""
    dim %= x.dim()
    return x.unflatten(dim, (groups, world, -1)).select(
        dim + 1, rank).flatten(dim, dim + 1)


def model_gather(x: torch.Tensor, mesh: Mesh, dim: int, groups: int = 1
                 ) -> torch.Tensor:
    """Every model rank's share ``x`` assembled in order along ``dim``
    (``model_slice``'s inverse), without a gradient."""
    dim %= x.dim()
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(mesh.model_world)]
    _timed(lambda: dist.all_gather(parts, x.detach().contiguous(),
                                   group=mesh.model_group))
    blocks = [p.unflatten(dim, (groups, -1)) for p in parts]
    return torch.stack(blocks, dim + 1).flatten(dim, dim + 2)


class CopyToModel(torch.autograd.Function):
    """The identity; backward: the sum over the model ranks."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_reduce(g, ctx.mesh), None


class ReduceFromModel(torch.autograd.Function):
    """The sum over the model ranks; backward: the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _model_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherFromModel(torch.autograd.Function):
    """``model_gather``; backward: this rank's share (``model_slice``)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, groups):
        ctx.mesh, ctx.dim, ctx.groups = mesh, dim, groups
        return model_gather(x, mesh, dim, groups)

    @staticmethod
    def backward(ctx, g):
        m = ctx.mesh
        return (model_slice(g, ctx.dim, ctx.groups, m.model_rank,
                            m.model_world).contiguous(), None, None, None)


def hop(x: Optional[torch.Tensor], mesh: Mesh, shift: int,
        like: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """One hop on the second axis, without a gradient: ``x`` (None: send
    nothing) goes to second-axis rank ``r + shift``; returns what rank
    ``r - shift`` sent, shaped as ``like`` (None: receive nothing). Both
    sides of a pair must agree on whether it carries a tensor. Through the
    host on gloo with a CUDA tensor (``host_hop``)."""
    r = mesh.model_rank
    ref = x if x is not None else like
    if ref is None:
        return None
    staged = host_hop(mesh, ref)
    out = None if like is None else torch.empty(
        like.shape, dtype=like.dtype, device="cpu" if staged else like.device)

    def run():
        ops = []
        if x is not None:
            sent = x.detach().contiguous()
            ops.append(dist.P2POp(dist.isend, sent.cpu() if staged else sent,
                                  mesh.peer(r + shift), mesh.model_group))
        if out is not None:
            ops.append(dist.P2POp(dist.irecv, out, mesh.peer(r - shift),
                                  mesh.model_group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out if out is None or not staged else out.to(ref.device)

    return _timed(run, "stage")


def host_hop(mesh: Mesh, x: torch.Tensor) -> bool:
    """Whether a hop of ``x`` goes through host copies: gloo with a CUDA
    tensor."""
    return x.is_cuda and dist.get_backend(mesh.model_group) == "gloo"


def _tokens_major(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, 0).contiguous()


class SeqGather(torch.autograd.Function):
    """[b, t, ...] on each seq rank -> [b, n t, ...], the ranks' token
    blocks in order; backward: the reduce-scatter sum back to this rank's
    block."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        xt = _tokens_major(x)
        out = xt.new_empty((xt.shape[0] * mesh.model_world, *xt.shape[1:]))
        _timed(lambda: _all_gather(out, xt, group=mesh.model_group), "seq")
        seq_counts["all_gather"] += 1
        return out.movedim(0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        gt = _tokens_major(g)
        out = gt.new_empty((gt.shape[0] // mesh.model_world, *gt.shape[1:]))
        _timed(lambda: _reduce_scatter(out, gt, group=mesh.model_group),
               "seq")
        seq_counts["reduce_scatter"] += 1
        return out.movedim(0, 1).contiguous(), None


def seq_gather(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return x if mesh is None or mesh.model_world == 1 \
        else SeqGather.apply(x, mesh)


def reset_seq_counts() -> None:
    for k in seq_counts:
        seq_counts[k] = 0


def copy_to_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return x if mesh is None else CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[Mesh]
                      ) -> torch.Tensor:
    return x if mesh is None else ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Optional[Mesh], dim: int,
                      groups: int = 1) -> torch.Tensor:
    return x if mesh is None else GatherFromModel.apply(x, mesh, dim, groups)


def all_gather(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return x if mesh is None else AllGather.apply(x, mesh)


def all_reduce(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return x if mesh is None else AllReduce.apply(x, mesh)


def reduce_scatter(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    return x if mesh is None else ReduceScatter.apply(x, mesh)


@torch.no_grad()
def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's rows in rank order, without a gradient."""
    return x if mesh is None else _gather(x.detach(), mesh)


@torch.no_grad()
def all_reduce_(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """In-place sum over ranks, without a gradient."""
    if mesh is not None:
        dist.all_reduce(x, group=mesh.group)
    return x


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Every parameter and buffer from global rank 0, so that every rank
    starts from its weights and running statistics."""
    if mesh is None:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, 0)


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Global rank 0's ``obj`` on every rank (a picklable host
    object)."""
    if mesh is None:
        return obj
    box: List = [obj]
    dist.broadcast_object_list(box, 0, device=mesh.device)
    return box[0]


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.nn.Parameter],
                     mesh: Optional[Mesh]) -> None:
    """The mean over the data ranks of every parameter gradient (a
    tensor-parallel shard's over the data ranks that hold the same shard),
    in one bucket per
    dtype: one all-reduce each, then a division by N (the convention of
    the module docstring). A parameter without a gradient (unused in the
    loss) keeps None, as in one process: every rank runs the same graph,
    so the set of such parameters is the same on every rank. A frozen
    group at lr 0 still has gradients and is reduced with the rest."""
    if mesh is not None:
        all_reduce_gradients(params, mesh.group, mesh.world)


@torch.no_grad()
def all_reduce_gradients(params: Iterable[torch.nn.Parameter], group,
                      divisor: int) -> None:
    """Each gradient summed over ``group`` and divided by ``divisor``: one
    all-reduce a dtype."""
    buckets = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault(p.grad.dtype, []).append(p)
    for plist in buckets.values():
        flat = torch.cat([p.grad.reshape(-1) for p in plist])
        dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat.div_(divisor)
        offset = 0
        for p in plist:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n
