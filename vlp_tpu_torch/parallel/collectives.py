"""The collectives that GSPMD inserts on the JAX package's ``('data',)``
mesh, as autograd functions over ``torch.distributed`` (no JAX
counterpart: there they are implicit).

The convention, held by ``tests/test_torch_port_parallel.py``:

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

The functions without a gradient (``gather_rows``, ``all_reduce_``,
``broadcast_module``) serve the metrics, the evaluation and the setup. On
one rank of no mesh (``mesh`` None) every function is the identity.
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
    """Every parameter and buffer from rank 0, so that every rank starts
    from rank 0's weights and running statistics."""
    if mesh is None:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, 0, group=mesh.group)


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's ``obj`` on every rank (a picklable host object)."""
    if mesh is None:
        return obj
    box: List = [obj]
    dist.broadcast_object_list(box, 0, group=mesh.group,
                               device=mesh.device)
    return box[0]


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.nn.Parameter],
                     mesh: Optional[Mesh]) -> None:
    """The mean over ranks of every parameter gradient, in one bucket per
    dtype: one all-reduce each, then a division by N (the convention of
    the module docstring). A parameter without a gradient (unused in the
    loss) keeps None, as in one process: every rank runs the same graph,
    so the set of such parameters is the same on every rank. A frozen
    group at lr 0 still has gradients and is reduced with the rest."""
    if mesh is None:
        return
    buckets = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault(p.grad.dtype, []).append(p)
    for plist in buckets.values():
        flat = torch.cat([p.grad.reshape(-1) for p in plist])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world)
        offset = 0
        for p in plist:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n
