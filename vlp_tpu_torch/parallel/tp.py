"""Tensor parallelism on the 2-D data x model mesh (counterpart of
``mesh.param_sharding=tp``: ``tp_state_sharding`` and
``shard_train_state(..., "tp")``, ``vlp_tpu/parallel/mesh.py:141-175``).

The JAX package annotates every parameter and AdamW moment of at least
2^16 elements with the model axis on its largest dim divisible by M (ties
to the last, ``_fsdp_spec``) and lets GSPMD partition the products and
insert the all-reduces. The port has no GSPMD: ``shard_model_tp(model,
mesh)`` splits a built model in place over the M model ranks, Megatron's
way, with the model-axis operators of ``parallel/collectives.py``. Every
layer decides by one rule, ``splits``: where the JAX rule shards its
largest weight (``fsdp.shard_dim`` over M, the same ``MIN_SIZE``) and its
heads, hidden columns or channels divide by M, the layer is split, else
every model rank holds it whole. A model declares how each of its layers
splits (a ``tp_split_`` method, which calls the functions here); the
splits:

- a transformer block's attention (``models/vit.py``: the fused layout's
  ``FusedSelfAttention``, flax's ``MultiHeadAttention``, which BERT's
  layers share): qkv by heads (a rank holds ``[q_r | k_r | v_r]`` of its
  H / M heads), the out-projection by rows, all-reduced before its bias
  and the residual; the MLP (``MlpBlock``, BERT's ``ffn_in``/``ffn_out``):
  fc1 by columns, fc2 by rows in the same way;
- a ResNet ``BasicBlock``: conv1 by output channels with BN1 on them,
  conv2 by input channels; a ``Bottleneck``: conv2 by output channels
  with BN2 on them, conv3 by input channels (conv1 stays whole). The
  shortcut's 1x1 conv, where the JAX rule shards it, by input channels;
  its partial sums and the last conv's are all-reduced together before
  BN and the residual;
- ``Embed`` tables on the JAX dim: by rows (the vocabulary; out-of-range
  ids give zeros, then an all-reduce) or by columns (then an all-gather);
- the patch embeddings and NesT's ConvPool convs by output channels, then
  an all-gather of the channels;
- raw parameters that no product splits (position embeddings, the dual
  tower's projections) on the JAX dim, all-gathered where they are used
  (``full_param``).

A split leaf's bias and a channel split's BatchNorm (its running
statistics too) go with it, although the JAX rule keeps them replicated
(under 2^16 elements), and a row-split out-projection goes with its qkv
(NesT-Small level 1: out [192, 192] is under 2^16); ``report`` lists those
and the leaves the JAX rule shards that stay whole (a Bottleneck's conv1,
a layer whose heads do not divide M). A split keeps the parameter names
and the state dict's keys; ``gather_state`` / ``scatter_state`` (and
``gather_optimizer_state`` / ``scatter_optimizer_state`` for AdamW's
moments) turn a rank's shards into the replicated run's format and back,
so a checkpoint written under TP serves on one process and resumes under
TP or replicated. A TP run in which no leaf ends up split raises: a run
asked for TP never trains replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from vlp_tpu_torch.parallel import fsdp
from vlp_tpu_torch.parallel.collectives import (gather_from_model,
                                                model_gather, model_slice)
from vlp_tpu_torch.parallel.mesh import Mesh
from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf split over the model ranks along ``dim``; with ``groups`` g
    the dim is g blocks each split in M (``collectives.model_slice``)."""

    dim: int
    groups: int = 1


def jax_dim(shape: Sequence[int], mesh: Mesh) -> Optional[int]:
    """The dim the JAX rule shards a leaf of ``shape`` (its flax layout)
    on over the model axis, None where it keeps the leaf whole."""
    return fsdp.shard_dim(tuple(shape), mesh.model_world)


def jax_shards(shape: Sequence[int], mesh: Mesh) -> bool:
    return jax_dim(shape, mesh) is not None


def conv_flax_shape(shape: Sequence[int]) -> tuple:
    """A torch conv weight's shape [O, I, kh, kw] in flax's layout [kh, kw,
    I, O]."""
    o, i, kh, kw = shape
    return (kh, kw, i, o)


def splits(flax_shape: Sequence[int], units: int, mesh: Mesh) -> bool:
    """Whether a layer splits over the model ranks: the JAX rule shards its
    largest leaf (``flax_shape``, flax's layout) and its ``units`` (heads,
    hidden columns, channels) divide by M."""
    return jax_shards(flax_shape, mesh) and units % mesh.model_world == 0


def conv_splits(conv: nn.Conv2d, channels: int, mesh: Mesh) -> bool:
    """``splits`` for a conv of ``channels`` output or input channels."""
    return splits(conv_flax_shape(conv.weight.shape), channels, mesh)


def prefixed(prefix: str, out: Dict[str, Split]) -> Dict[str, Split]:
    """A submodule's splits under its name in the parent's state dict."""
    return {f"{prefix}.{k}": v for k, v in out.items()}


def split_(module: nn.Module, name: str, mesh: Mesh, dim: int,
           groups: int = 1) -> Split:
    """Replaces ``module``'s parameter or buffer ``name`` by this model
    rank's share of it along ``dim``."""
    t = getattr(module, name)
    if t.shape[dim] % (groups * mesh.model_world):
        raise ValueError(f"tensor parallelism: {name} {tuple(t.shape)} does "
                         f"not split in {groups} x {mesh.model_world} "
                         f"along dim {dim}")
    local = model_slice(t.detach(), dim, groups, mesh.model_rank,
                        mesh.model_world).clone()
    if name in module._parameters:
        module._parameters[name] = nn.Parameter(
            local, requires_grad=t.requires_grad)
    else:
        module._buffers[name] = local
    return Split(dim, groups)


def full_param(p: torch.Tensor) -> torch.Tensor:
    """A parameter whole: gathered over the model ranks where
    ``gather_params_`` split it (backward: this rank's share), else
    itself."""
    g = getattr(p, "tp_gather", None)
    return p if g is None else gather_from_model(p, g[0], g[1])


def split_columns_(dense: nn.Module, mesh: Mesh, groups: int = 1
                   ) -> Dict[str, Split]:
    """A ``Dense``'s output columns on this model rank (``groups`` blocks,
    each split: 3 for a packed q|k|v) and their biases; its input then
    passes ``copy_to_model``."""
    dense.col_mesh = mesh
    return {"weight": split_(dense, "weight", mesh, 1, groups),
            "bias": split_(dense, "bias", mesh, 0, groups)}


def split_rows_(dense: nn.Module, mesh: Mesh) -> Dict[str, Split]:
    """A ``Dense``'s input rows on this model rank; its partial products
    are summed over the model ranks before the bias, which stays whole."""
    dense.row_mesh = mesh
    return {"weight": split_(dense, "weight", mesh, 0)}


def split_attention_(attn: nn.Module, mesh: Mesh) -> Dict[str, Split]:
    """An attention's H / M heads on this model rank where it splits
    (``splits`` of its query kernel in flax's layout): qkv by columns in
    its q, k and v blocks, out by rows; else nothing."""
    if not splits(attn.flax_qkv_shape(), attn.num_heads, mesh):
        return {}
    attn.num_heads //= mesh.model_world
    return {**prefixed("qkv", split_columns_(attn.qkv, mesh, 3)),
            **prefixed("out", split_rows_(attn.out, mesh))}


def split_mlp_(module: nn.Module, fc1: str, fc2: str, mesh: Mesh
               ) -> Dict[str, Split]:
    """``module``'s MLP (``Dense`` layers named ``fc1`` and ``fc2``) on
    this rank's F / M hidden columns where it splits (``splits`` of fc1):
    fc1 by columns, fc2 by rows; else nothing."""
    first, second = getattr(module, fc1), getattr(module, fc2)
    if not splits(first.weight.shape, first.weight.shape[1], mesh):
        return {}
    return {**prefixed(fc1, split_columns_(first, mesh)),
            **prefixed(fc2, split_rows_(second, mesh))}


def split_conv_out_(conv: nn.Conv2d, mesh: Mesh) -> Dict[str, Split]:
    """This model rank's output channels of ``conv`` (and its bias) where
    it splits, else nothing; ``models.vit.conv_nhwc`` gathers them."""
    if not conv_splits(conv, conv.weight.shape[0], mesh):
        return {}
    conv.tp_mesh = mesh
    out = {"weight": split_(conv, "weight", mesh, 0)}
    if conv.bias is not None:
        out["bias"] = split_(conv, "bias", mesh, 0)
    return out


def gather_params_(module: nn.Module, names: Sequence[str],
                   mesh: Mesh) -> Dict[str, Split]:
    """``module``'s raw parameters ``names`` split on the JAX rule's dim
    where it shards them, gathered where they are used (``full_param``).
    """
    out = {}
    for name in names:
        dim = jax_dim(getattr(module, name).shape, mesh)
        if dim is not None:
            out[name] = split_(module, name, mesh, dim)
            getattr(module, name).tp_gather = (mesh, dim)
    return out


def shard_model_tp(model: nn.Module, mesh: Mesh) -> Dict[str, Split]:
    """Splits ``model`` in place over ``mesh``'s model ranks (module
    docstring); returns the splits by state-dict key. Call it after every
    rank holds the same weights and before the optimizer is built. Raises
    where nothing splits."""
    if mesh is None or mesh.model_world < 2:
        raise ValueError("tensor parallelism needs mesh.model_parallel > 1")
    if is_split(model):
        raise ValueError("the model is split already")
    splits: Dict[str, Split] = {}
    for prefix, module in model.named_modules():
        fn = getattr(module, "tp_split_", None)
        if fn is None:
            continue
        for name, split in fn(mesh).items():
            splits[f"{prefix}.{name}" if prefix else name] = split
    if not splits:
        raise ValueError(
            f"mesh.param_sharding='tp': no layer of the model splits over "
            f"{mesh.model_world} model ranks (the JAX rule shards no leaf "
            f"of its largest weights, or their heads, columns or channels "
            "do not divide by model_parallel); the run stops rather than "
            "train replicated")
    model.tp_splits = splits
    model.tp_mesh = mesh
    logger.info("tensor parallelism: %d state entries split over %d model "
                "ranks", len(splits), mesh.model_world)
    return splits


def is_split(model: nn.Module) -> bool:
    """True for a model that ``shard_model_tp`` split."""
    return bool(getattr(model, "tp_splits", None))


def report(model: nn.Module) -> Dict[str, List[str]]:
    """The leaves of a split model by how a rank holds them, against the
    JAX rule: ``split`` (a share; the rule shards them too), ``split_extra``
    (a share where the rule replicates: biases, BatchNorm, an out-
    projection under 2^16), ``whole_sharded_by_jax`` (whole where the rule
    shards) and ``whole``, by state-dict key (BatchNorm's running
    statistics among them)."""
    mesh, splits = model.tp_mesh, model.tp_splits
    out: Dict[str, List[str]] = {"split": [], "split_extra": [],
                                 "whole_sharded_by_jax": [], "whole": []}
    for name, shape in full_shapes(model).items():
        flax = conv_flax_shape(shape) \
            if len(shape) == 4 and name.endswith("weight") else shape
        jax = jax_shards(flax, mesh)
        if name in splits:
            out["split" if jax else "split_extra"].append(name)
        else:
            out["whole_sharded_by_jax" if jax else "whole"].append(name)
    return out


def full_shapes(model: nn.Module) -> Dict[str, tuple]:
    """Each state-dict entry's shape in the replicated model."""
    splits = getattr(model, "tp_splits", None) or {}
    world = model.tp_mesh.model_world if splits else 1
    out = {}
    for name, t in model.state_dict().items():
        shape = list(t.shape)
        if name in splits:
            shape[splits[name].dim] *= world
        out[name] = tuple(shape)
    return out


def gather_state(model: nn.Module, state: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, torch.Tensor]:
    """The replicated model's state dict from a split model's (``state``,
    default its ``state_dict()``), on every rank (a collective over the
    model ranks: every rank calls it)."""
    state = model.state_dict() if state is None else state
    splits, mesh = model.tp_splits, model.tp_mesh
    return {k: model_gather(v, mesh, splits[k].dim, splits[k].groups)
            if k in splits else v for k, v in state.items()}


def scatter_state(model: nn.Module, full: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """This rank's shares of a replicated state dict (or of a part of
    one)."""
    splits, mesh = model.tp_splits, model.tp_mesh
    return {k: model_slice(v, splits[k].dim, splits[k].groups,
                           mesh.model_rank, mesh.model_world).clone()
            if k in splits else v for k, v in full.items()}


def _param_names(model: nn.Module, optimizer) -> List[str]:
    """The names of the optimizer's parameters in its state dict's
    numbering (group by group)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups
            for p in g["params"]]


def _map_moments(model, optimizer, state, fn) -> Dict[str, Any]:
    """``state`` (an optimizer state dict) with ``fn(tensor, split)``
    applied to every per-element moment of a split parameter."""
    splits = model.tp_splits
    names = _param_names(model, optimizer)
    out = {}
    for idx, st in state["state"].items():
        split = splits.get(names[idx])
        out[idx] = st if split is None else {
            k: fn(v, split) if isinstance(v, torch.Tensor) and v.dim() > 0
            else v for k, v in st.items()}
    return {"state": out, "param_groups": state["param_groups"]}


def gather_optimizer_state(model: nn.Module, optimizer) -> Dict[str, Any]:
    """The replicated run's ``optimizer.state_dict()`` from a split
    model's optimizer (a collective: every rank calls it). The groups and
    the numbering are the replicated run's already: the split keeps every
    parameter, in order."""
    mesh = model.tp_mesh
    return _map_moments(model, optimizer, optimizer.state_dict(),
                        lambda v, s: model_gather(v, mesh, s.dim, s.groups))


def scatter_optimizer_state(model: nn.Module, optimizer,
                            full: Dict[str, Any]) -> Dict[str, Any]:
    """``gather_optimizer_state``'s inverse: this rank's shares of the
    moments of a replicated run's optimizer state."""
    mesh = model.tp_mesh
    return _map_moments(model, optimizer, full, lambda v, s: model_slice(
        v, s.dim, s.groups, mesh.model_rank, mesh.model_world).clone())
