"""Pipeline parallelism, the GPipe fill-drain schedule over the stage axis
(counterpart of ``vlp_tpu/parallel/pipeline.py:65-149``).

The mesh is ``create_pipeline_mesh(n, D)``, whose second axis
(``model_rank``, ``model_world``, ``model_group``) is the stages: n stage
ranks a data rank, each holding ``depth / n`` consecutive blocks of a
homogeneous stack (``stage_blocks``; a stage rank builds only its own).
``make_pipeline_fn`` returns ``fn(stage, x)`` for ``x`` ``[M, mb, ...]``,
M microbatches (the batch dim sharded over the data ranks when D > 1):

- The schedule takes M + n - 1 ticks. At tick t stage 0 ingests microbatch
  t, and stage s runs microbatch t - s through its blocks, then hops the
  result to stage s + 1 (``collectives.hop``). The JAX scan runs every
  stage at every tick and lets stage 0 ignore the ring's wraparound; here
  a stage runs only the ticks that hold a microbatch, and the hops that
  carry nothing (the wraparound among them) are not sent. The bubble is
  (n - 1) / (M + n - 1) of the ticks.
- The last stage's finished microbatches are broadcast to every stage rank
  of its data rank, so every stage rank holds the same ``[M, mb, ...]``
  output, as the JAX masked ``psum`` replicates it.
- Backward (``loss.backward()`` on every rank): the stages run their
  microbatches' backwards in reverse order, each hopping its input's
  gradient back to the stage before. Every stage rank computes the same
  loss from the replicated output, and only the last stage's cotangent
  enters the schedule: the others' are the same one, so summing them (the
  adjoint of a broadcast on n independent losses) would hand the stack n
  times its gradient. A stage's parameter gradients are then the
  sequential stack's, summed over the microbatches in place; the input's
  gradient is stage 0's, broadcast to the stage ranks as the replicated
  input's cotangent is in JAX. The hops of the backward run the forward's
  the other way, the adjoint of ``lax.ppermute``. With D > 1,
  ``collectives.reduce_gradients`` averages each stage's gradients over its
  data group, as in data parallelism.

``stage_fn(stage, h)`` (``scan_blocks_stage_fn``: the stage's blocks in
order through ``vit.run_block``, so ``remat`` composes as in the ViT) must
keep h's shape and dtype. A stage's blocks run the port's kernels on its
rank's device as a whole model's do (``attend_qkv`` and its backward in
the fused layout; ``fused_mlp`` where ``fused_mlp.supports`` holds).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from vlp_tpu_torch.models.vit import run_block
from vlp_tpu_torch.parallel.collectives import hop
from vlp_tpu_torch.parallel.mesh import Mesh


def stage_range(depth: int, n_stages: int, stage: int) -> range:
    """The blocks of stage ``stage``: ``depth // n_stages`` consecutive
    ones."""
    if depth % n_stages:
        raise ValueError(f"depth={depth} not divisible by "
                         f"n_stages={n_stages}")
    per = depth // n_stages
    return range(stage * per, (stage + 1) * per)


def stage_blocks(make_block: Callable[[int], nn.Module], depth: int,
                 mesh: Optional[Mesh]) -> nn.ModuleList:
    """This stage rank's blocks of a ``depth``-block stack,
    ``make_block(i)`` building block i with its weights (the JAX per-block
    params go through ``convert.load_weights``): the counterpart of
    ``stack_stage_params`` placed ``P('stage')``. No mesh: every block."""
    n, s = (1, 0) if mesh is None else (mesh.model_world, mesh.model_rank)
    return nn.ModuleList(make_block(i) for i in stage_range(depth, n, s))


def scan_blocks_stage_fn(remat: bool = False) -> Callable:
    """``stage_fn(stage, h)``: the stage's blocks applied in order."""
    def stage_fn(stage: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
        for block in stage:
            h = run_block(block, h, remat)
        return h

    return stage_fn


class _Schedule:
    """One call's GPipe schedule on this rank; keeps each microbatch's
    graph from the forward for the backward."""

    def __init__(self, stage_fn, stage, mesh: Mesh, n_microbatches: int,
                 params: List[nn.Parameter],
                 compute_events: Optional[list]) -> None:
        self.stage_fn, self.stage, self.mesh = stage_fn, stage, mesh
        self.m, self.params = n_microbatches, params
        self.s, self.n = mesh.model_rank, mesh.model_world
        self.kept: List = []
        self.compute_events = compute_events

    def _compute(self, fn):
        if self.compute_events is None:
            return fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        self.compute_events.append((start, end))
        return out

    def forward(self, x: torch.Tensor, x_grad: bool) -> torch.Tensor:
        s, n, mesh = self.s, self.n, self.mesh
        outs = []
        for mb in range(self.m):  # stage s: tick mb + s
            h = x[mb] if s == 0 else hop(None, mesh, 1, like=x[mb])
            h = h.detach().requires_grad_(s > 0 or x_grad)
            with torch.enable_grad():
                y = self._compute(lambda: self.stage_fn(self.stage, h))
            if y.shape != h.shape or y.dtype != h.dtype:
                raise ValueError(f"stage_fn maps {tuple(h.shape)} "
                                 f"{h.dtype} to {tuple(y.shape)} {y.dtype}: "
                                 "a stage must keep both")
            self.kept.append((h, y))
            if s < n - 1:
                hop(y, mesh, 1)
            else:
                outs.append(y.detach())
        out = torch.stack(outs) if s == n - 1 else torch.empty_like(x)
        if n > 1:  # the last stage's outputs on every stage rank
            dist.broadcast(out, mesh.peer(n - 1), group=mesh.model_group)
        return out

    def backward(self, gy: torch.Tensor, x_grad: bool) -> tuple:
        s, n, mesh = self.s, self.n, self.mesh
        grads = [None] * len(self.params)
        dx = torch.zeros_like(gy) if x_grad else None
        for mb in reversed(range(self.m)):
            h, y = self.kept[mb]
            g = gy[mb] if s == n - 1 else hop(None, mesh, -1, like=y)
            wrt = ([h] if h.requires_grad else []) + self.params
            got = self._compute(lambda: torch.autograd.grad(
                y, wrt, g, allow_unused=True))
            self.kept[mb] = None
            dh, dp = (got[0], got[1:]) if h.requires_grad else (None, got)
            for i, d in enumerate(dp):
                if d is None:
                    continue
                if grads[i] is None:
                    grads[i] = d
                else:
                    grads[i].add_(d)
            if s > 0:
                hop(dh, mesh, -1)
            elif x_grad:
                dx[mb] = dh
        if x_grad and n > 1:  # the replicated input's cotangent
            dist.broadcast(dx, mesh.peer(0), group=mesh.model_group)
        return (dx, *grads)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x, *params):
        ctx.sched, ctx.x_grad = sched, x.requires_grad
        return sched.forward(x, x.requires_grad)

    @staticmethod
    def backward(ctx, gy):
        return (None, *ctx.sched.backward(gy.contiguous(), ctx.x_grad))


class Pipeline:
    """``make_pipeline_fn``'s function. While ``compute_events`` is a list,
    each rank appends the (start, end) CUDA events around every
    microbatch's stage_fn, forward and backward, to it (the measure of its
    busy time, and so of the bubble)."""

    def __init__(self, stage_fn: Callable, mesh: Optional[Mesh],
                 n_stages: int, n_microbatches: int) -> None:
        if n_microbatches < 1:
            raise ValueError(f"n_microbatches={n_microbatches} < 1")
        if mesh is not None and mesh.second_axis != "stage":
            raise ValueError(f"mesh has no 'stage' axis: its second axis "
                             f"is {mesh.second_axis!r}")
        axis = 1 if mesh is None else mesh.model_world
        if axis != n_stages:
            raise ValueError(f"mesh 'stage' axis is {axis}, expected "
                             f"n_stages={n_stages}")
        self.stage_fn, self.mesh, self.m = stage_fn, mesh, n_microbatches
        self.compute_events: Optional[list] = None

    def __call__(self, stage: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != self.m:
            raise ValueError(f"x {tuple(x.shape)}: expected {self.m} "
                             "microbatches on dim 0")
        if self.mesh is None:  # one stage
            return torch.stack([self.stage_fn(stage, x[i])
                                for i in range(self.m)])
        params = [p for p in stage.parameters() if p.requires_grad]
        sched = _Schedule(self.stage_fn, stage, self.mesh, self.m, params,
                          self.compute_events)
        return _GPipe.apply(sched, x, *params)


def make_pipeline_fn(stage_fn: Callable, mesh: Optional[Mesh],
                     n_stages: int, n_microbatches: int) -> Pipeline:
    """``fn(stage, x) -> y``: the GPipe schedule of ``stage_fn`` over the
    stage axis of ``mesh``, ``x`` and ``y`` ``[M, mb, ...]`` (the rank's
    rows of each microbatch where D > 1), ``stage`` this rank's module
    (``stage_blocks``). The JAX refusals: fewer than one microbatch, a
    stage axis of another size than ``n_stages``; and a mesh whose second
    axis is not the stages."""
    return Pipeline(stage_fn, mesh, n_stages, n_microbatches)
