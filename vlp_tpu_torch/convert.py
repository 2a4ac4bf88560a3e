"""JAX package variables -> the port's ``state_dict``.

Takes the flax variables of ``OnlyImagingModel`` (``vlp_tpu.serve.Predictor
.variables``) as a nested dict of numpy arrays, or as the flat ``'/'``-keyed
``.npz`` that ``scripts/export_flax_params.py`` writes, and maps each leaf
onto the port's module tree:

  params/backbone/patch_embed/kernel  -> backbone.patch_embed.weight (OIHW)
  params/backbone/pos_embed_{li}      -> backbone.pos_embed_{li}
  params/backbone/l{li}_block{d}/...  -> backbone.levels.{li}.{d}...
  params/backbone/pool{li}/...        -> backbone.pools.{li}...
  params/backbone/cls_token, pos_embed -> backbone.cls_token, pos_embed (ViT)
  params/backbone/block{i}/...        -> backbone.blocks.{i}... (ViT)
  params/backbone/final_ln/...        -> backbone.final_ln... (ViT)
  params/backbone/stage{i}_block{j}/... -> backbone.stages.{i}.{j}... (ResNet)
  params/backbone/stem_conv_s2d/...   -> backbone.stem_conv... (ResNet s2d)
  .../kernel (Dense, [in, out]), .../scale -> ....weight
  batch_stats/.../mean, .../var       -> ....running_mean, ....running_var
  params/head/...                     -> head...

and those of the dual tower (``VisionLanguageModel``):

  params/image_encoder/..., batch_stats/image_encoder/... -> image_encoder...
  params/text_encoder/layer{i}/...    -> text_encoder.layers.{i}...
  .../embedding (Embed)               -> ....weight
  .../attn/{query,key,value}/kernel [D, H, hd], bias [H, hd]
                                      -> .../attn.qkv.weight [D, 3 H hd],
                                         bias [3 H hd] (q | k | v)
  .../attn/out/kernel [H, hd, D]      -> [H * hd, D]
  params/image_projection, text_projection, logit_scale -> the same names

A key the model lacks, a key the tree lacks, or a shape that differs
raises, naming the key (the attention's DenseGeneral leaves are flattened
in C order, which keeps their element count; ``pack_qkv`` concatenates q,
k and v). ``load_optimizer_state`` maps an optax ``adamw`` state (``mu``,
``nu``, ``count``) onto ``torch.optim.AdamW``'s per-parameter state the
same way (parameters only), so weights and moments carry over together.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

_COMPONENT_RULES = (
    (re.compile(r"^l(\d+)_block(\d+)$"), r"levels.\1.\2"),
    (re.compile(r"^pool(\d+)$"), r"pools.\1"),
    (re.compile(r"^block(\d+)$"), r"blocks.\1"),
    (re.compile(r"^stage(\d+)_block(\d+)$"), r"stages.\1.\2"),
    (re.compile(r"^stem_conv_s2d$"), "stem_conv"),
    (re.compile(r"^layer(\d+)$"), r"layers.\1"),
)
# the last component of each collection's leaves
_LEAF_NAMES = {"params": {"kernel": "weight", "scale": "weight",
                          "embedding": "weight"},
               "batch_stats": {"mean": "running_mean", "var": "running_var"}}


# flax MultiHeadDotProductAttention's DenseGeneral leaves
_MHA_OUT = re.compile(r"/attn/out/kernel$")
_MHA_QKV = re.compile(r"^(.*/attn)/(query|key|value)/(kernel|bias)$")


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {'a/b/c': leaf}."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten(v, key))
        else:
            flat[key] = v
    return flat


def pack_qkv(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat variables -> the same with each attention's query, key and
    value kernels ``[D, H, hd]`` and biases ``[H, hd]`` replaced by one
    ``.../attn/qkv/kernel`` ``[D, 3 H hd]`` and ``.../attn/qkv/bias``
    (q | k | v, each flattened in C order); raises, naming the key, where a
    part is missing or the parts' shapes differ."""
    out, parts = {}, {}
    for fkey, value in flat.items():
        m = _MHA_QKV.match(fkey)
        if m is None:
            out[fkey] = value
        else:
            parts.setdefault((m[1], m[3]), {})[m[2]] = np.asarray(value)
    for (prefix, leaf), got in parts.items():
        for part in ("query", "key", "value"):
            if part not in got:
                raise KeyError(f"variables lack '{prefix}/{part}/{leaf}'")
        shapes = [got[p].shape for p in ("query", "key", "value")]
        if len(set(shapes)) > 1:
            raise ValueError(f"'{prefix}/{{query,key,value}}/{leaf}': "
                             f"shapes {shapes} differ")
        out[f"{prefix}/qkv/{leaf}"] = np.concatenate(
            [a.reshape(a.shape[0], -1) if leaf == "kernel" else
             a.reshape(-1) for a in (got["query"], got["key"],
                                     got["value"])], -1)
    return out


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def torch_key(flax_key: str) -> str:
    """'params/backbone/l0_block1/attn/qkv/kernel' ->
    'backbone.levels.0.1.attn.qkv.weight';
    'batch_stats/backbone/stage0_block1/bn1/var' ->
    'backbone.stages.0.1.bn1.running_var'."""
    parts = flax_key.split("/")
    if parts[0] not in _LEAF_NAMES or len(parts) < 2:
        raise KeyError(f"{flax_key!r}: only 'params/...' and "
                       "'batch_stats/...' variables map onto the port")
    out = []
    for i, part in enumerate(parts[1:]):
        for pattern, repl in _COMPONENT_RULES:
            part = pattern.sub(repl, part)
        if i == len(parts) - 2:
            part = _LEAF_NAMES[parts[0]].get(part, part)
        out.append(part)
    return ".".join(out)


def state_dict_from_flax(variables: Mapping[str, Any], model: nn.Module,
                         params_only: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """Maps JAX variables onto ``model``'s state_dict keys and shapes (its
    parameters alone with ``params_only``)."""
    flat = pack_qkv(flatten(variables))
    expected = dict(model.named_parameters()) if params_only \
        else model.state_dict()
    out = {}
    for fkey, value in flat.items():
        arr = np.asarray(value)
        tkey = torch_key(fkey)
        if tkey not in expected:
            raise KeyError(f"{fkey!r} (-> {tkey!r}) has no counterpart in "
                           f"{type(model).__name__}")
        if fkey.endswith("/kernel") and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        if _MHA_OUT.search(fkey) and arr.ndim > expected[tkey].dim() \
                and arr.size == expected[tkey].numel():
            arr = arr.reshape(tuple(expected[tkey].shape))
        if tuple(arr.shape) != tuple(expected[tkey].shape):
            raise ValueError(
                f"{fkey!r}: shape {tuple(arr.shape)} does not match "
                f"{tkey!r} {tuple(expected[tkey].shape)}")
        out[tkey] = torch.from_numpy(np.ascontiguousarray(arr))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"variables lack {missing[0]!r}"
                       + (f" and {len(missing) - 1} more" if missing[1:]
                          else ""))
    return out


def load_weights(model: nn.Module,
                 source: Union[str, Mapping[str, Any]]) -> None:
    """Loads an ``.npz`` path or a variables tree into ``model``."""
    variables = load_npz(source) if isinstance(source, str) else source
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)


def load_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module,
                         mu: Mapping[str, Any], nu: Mapping[str, Any],
                         count: int) -> None:
    """optax ``ScaleByAdamState`` (``mu`` and ``nu`` as param-shaped trees
    of numpy arrays, without the ``params`` level; ``count`` the updates
    taken) -> ``exp_avg``, ``exp_avg_sq`` and ``step`` of every parameter of
    ``model`` in ``optimizer`` (``torch.optim.AdamW``/``Adam``)."""
    moments = [state_dict_from_flax({"params": tree}, model,
                                    params_only=True) for tree in (mu, nu)]
    owned = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        if id(p) not in owned:
            raise KeyError(f"{name!r} is not in the optimizer")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": moments[0][name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": moments[1][name].to(p.device, p.dtype).clone()}
