"""Sequence parallelism over the token axis (counterpart of
``vlp_tpu/parallel/sequence.py:59-98``).

The mesh is ``create_seq_mesh(n, D)``: each rank holds the token rows
``[B / D, T / n, D]`` of a ``[B, T, D]`` activation (``token_sharding``:
its data rank's rows, its seq rank's T / n consecutive tokens) and the
whole weights. ``make_seq_parallel_fn(mesh)`` returns ``fn(blocks, x)``,
which applies a list of ``EncoderBlock``s to the rank's token rows of x and
returns the rank's rows of the result. The JAX function constrains the
activation's sharding between blocks and GSPMD places the collectives
around the attention products; here the blocks take the route GSPMD
computes (``models/vit.py``'s module docstring): everything on the rank's
own tokens but attention, whose k and v (flax's layout) or packed qkv (the
fused layout) are gathered over the seq ranks. ``fn`` hands each block the
mesh as an argument (``EncoderBlock.forward(x, seq_mesh)``), so the route
lasts one call, as the JAX function is pure: the same blocks called
without it run the whole sequence. A block's forward runs one all-gather on
the seq group and its backward one reduce-scatter (``collectives.
seq_counts``), which keeps the mesh in its autograd context. The seq axis
is the mesh's second axis (``model_rank``, ``model_world``,
``model_group``).

Gradients: each rank's loss is its tokens' share of the global loss, so
the seq ranks' parameter gradients are parts of one sum;
``reduce_seq_gradients`` adds them over the seq group and then averages
over the data group as ``reduce_gradients`` does (its convention: each
data rank's loss is the global batch's). x's gradient on a rank is its own
tokens' in full.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import torch
from torch import nn

from vlp_tpu_torch.parallel.collectives import (all_reduce_gradients,
                                                reduce_gradients)
from vlp_tpu_torch.parallel.mesh import Mesh


def token_sharding(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's token rows ``[B / D, T / n, D]`` of ``x`` [B, T, D]."""
    if x.dim() != 3:
        raise ValueError(f"expected [B, T, D], got shape {tuple(x.shape)}")
    n = 1 if mesh is None else mesh.model_world
    if x.shape[1] % n:
        raise ValueError(f"T={x.shape[1]} not divisible by seq axis size "
                         f"{n}")
    if mesh is None:
        return x
    t = x.shape[1] // n
    r = mesh.model_rank
    return x[mesh.rows(x.shape[0]), r * t:(r + 1) * t]


def make_seq_parallel_fn(mesh: Optional[Mesh]) -> Callable:
    """``fn(blocks, x) -> y``: the blocks applied to this rank's token rows
    of ``x`` [B, T, D] (the same x on every rank), y this rank's rows of
    the result. Refuses a mesh without a seq axis, an x that is not
    [B, T, D] and a T the seq axis does not divide."""
    if mesh is not None and mesh.second_axis != "seq":
        raise ValueError(f"mesh has no 'seq' axis: its second axis is "
                         f"{mesh.second_axis!r}")

    def fn(blocks: Sequence[nn.Module], x: torch.Tensor) -> torch.Tensor:
        h = token_sharding(x, mesh)
        for block in blocks:
            h = block(h, seq_mesh=mesh)
        return h

    return fn


@torch.no_grad()
def reduce_seq_gradients(params: Iterable[nn.Parameter],
                         mesh: Optional[Mesh]) -> None:
    """Every parameter gradient summed over the seq ranks, then averaged
    over the data ranks (``reduce_gradients``)."""
    if mesh is None:
        return
    params = list(params)
    if mesh.model_world > 1:
        all_reduce_gradients(params, mesh.model_group, 1)
    if mesh.world > 1:
        reduce_gradients(params, mesh)
