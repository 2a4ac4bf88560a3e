"""FSDP: parameters and AdamW moments sharded over the data ranks
(counterpart of ``mesh.param_sharding=fsdp``,
``vlp_tpu/parallel/mesh.py:95-139``).

``shard_model(model, mesh)`` applies FSDP2 (``torch.distributed.fsdp.
fully_shard``) with the JAX package's placement rule (``shard_dim``): a
parameter of at least 2^16 elements that has a dim divisible by the world
is sharded over the data ranks on its largest such dim (ties go to the
last); every other parameter stays replicated, as an ``ignored_params``
entry that FSDP never touches, and its gradient goes through
``collectives.reduce_gradients`` as on the replicated DP step. The units
are one per transformer block, ResNet stage and BERT layer, plus the root,
whose own parameters (the ViT's embeddings, the dual tower's projections)
it all-gathers around its ``forward`` and the dual tower's
``encode_image``, ``image_features`` and ``encode_text``.

The parameters stay fp32 (no ``MixedPrecisionPolicy``): the blocks cast to
the compute dtype inside, so a step does the replicated DP step's math.
FSDP2's reduce-scatter averages over the world, the ``/ N`` of
``collectives.py``'s convention; every unit runs it through one
``TimedReduceScatter``, which records its CUDA events while the train
step asks for them (``reduce_scatter_timer``). An optimizer built after
``shard_model`` holds the DTensor shards, so its moments are sharded with
them; ``train/optim.py``'s ``make_optimizer`` splits each group into its
sharded and replicated halves, and its ``merged_state`` /
``split_state`` turn that optimizer's state into the replicated run's
and back for ``utils/checkpoint.py``, which gathers and scatters the
model through ``model_state`` / ``load_model_state``.

The process group is the mesh's (``parallel/mesh.py``); this module forms
none of its own. A torch without ``shard_placement_fn`` or
``ignored_params`` raises: a run asked to shard never trains replicated,
nor on another placement.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence

import torch
from torch import nn

from vlp_tpu_torch.parallel.mesh import Mesh

# leaves smaller than this stay replicated (vlp_tpu/parallel/mesh.py:103)
MIN_SIZE = 2 ** 16
# the dual tower's methods that read the root's own parameters
_FORWARD_METHODS = ("encode_image", "image_features", "encode_text")


def shard_dim(shape: Sequence[int], world: int) -> Optional[int]:
    """The dim the JAX rule (``_fsdp_spec``) shards a leaf of ``shape`` on
    over ``world`` ranks: the largest dim divisible by ``world``, the last
    of equal ones; None (replicated) below ``MIN_SIZE`` elements or with no
    such dim."""
    if not shape or math.prod(shape) < MIN_SIZE:
        return None
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if s % world == 0 and s >= best_size:
            best, best_size = i, s
    return best


def _units(model: nn.Module) -> List:
    """The FSDP units below the root, innermost first: each transformer
    block, each ResNet stage (a list of blocks) and each BERT layer."""
    from vlp_tpu_torch.models.bert import BertLayer
    from vlp_tpu_torch.models.resnet import ResNet
    from vlp_tpu_torch.models.vit import EncoderBlock

    units: List = []
    for m in model.modules():
        if isinstance(m, (EncoderBlock, BertLayer)):
            units.append(m)
        elif isinstance(m, ResNet):
            units.extend(list(stage) for stage in m.stages)
    return units


def is_sharded(model: nn.Module) -> bool:
    """True for a model that ``shard_model`` sharded."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def replicated(params: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """The parameters of ``params`` that FSDP does not manage (all of them
    on a model that is not sharded): those whose gradients
    ``reduce_gradients`` averages."""
    from torch.distributed.tensor import DTensor

    return [p for p in params if not isinstance(p, DTensor)]


class TimedReduceScatter:
    """FSDP2's reduce-scatter (``fully_shard``'s ``ReduceScatter``
    interface): ``dist.reduce_scatter_tensor`` on buffers from the caching
    allocator, as FSDP2's own. While ``events`` is a list, each call
    appends to it the (start, end) CUDA events recorded around it on the
    stream FSDP2 launches it on."""

    def __init__(self) -> None:
        self.events: Optional[list] = None

    def allocate(self, size, *, dtype, device) -> torch.Tensor:
        return torch.empty(*size, dtype=dtype, device=device)

    def __call__(self, output_tensor, input_tensor, group, op,
                 async_op=False):
        import torch.distributed as dist

        events = self.events
        if events is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        work = dist.reduce_scatter_tensor(output_tensor, input_tensor, op=op,
                                          group=group, async_op=async_op)
        if events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events.append((start, end))
        return work


def reduce_scatter_timer(model: nn.Module) -> Optional[TimedReduceScatter]:
    """The reduce-scatter of a model that ``shard_model`` sharded; None
    for any other."""
    return getattr(model, "fsdp_reduce_scatter", None)


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Shards ``model`` in place over ``mesh``'s ranks (module docstring)
    and returns it. Call it after every rank holds the same weights and
    before the optimizer is built."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard

    world = mesh.world
    ignored = {p for p in model.parameters()
               if shard_dim(p.shape, world) is None}
    device_mesh = DeviceMesh.from_group(mesh.group or dist.group.WORLD,
                                        mesh.device.type)

    def placement(p: nn.Parameter):
        return Shard(shard_dim(p.shape, world))

    kw = dict(mesh=device_mesh, shard_placement_fn=placement,
              ignored_params=ignored)
    units = _units(model) + [model]
    try:
        for unit in units:
            fully_shard(unit, **kw)
    except TypeError as e:  # a torch before these keywords
        raise RuntimeError(
            f"mesh.param_sharding='fsdp' needs FSDP2's shard_placement_fn "
            f"and ignored_params (torch {torch.__version__}: {e}); the run "
            "stops rather than train replicated or shard on dim 0") from e
    model.fsdp_reduce_scatter = TimedReduceScatter()
    for unit in units:  # a ResNet stage's blocks share one FSDP state
        for m in unit if isinstance(unit, list) else [unit]:
            m.set_custom_reduce_scatter(model.fsdp_reduce_scatter)
    for name in _FORWARD_METHODS:
        if hasattr(model, name):
            register_fsdp_forward_method(model, name)
    return model

