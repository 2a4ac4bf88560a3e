"""Text towers: the DistilBERT and TinyBERT architectures (counterpart of
``vlp_tpu/models/bert.py``), from random weights.

A post-LN transformer encoder over token ids and a 0/1 padding mask whose
output is the CLS row, in fp32. Embeddings (word + position, + token type
0 for TinyBERT's BERT layout) are summed in fp32 and normalised by the
embedding LayerNorm, then cast to the compute dtype. Each layer, as flax
computes it: ``y = attn(x)``; ``x = LN(x + y)`` (the sum in the compute
dtype, the LayerNorm in fp32 with eps 1e-12, cast back); ``y =
ffn_out(gelu(ffn_in(x)))`` with the exact erf GELU; ``x = LN(x + y)``.

Attention is flax's ``MultiHeadDotProductAttention`` (``vit.
MultiHeadAttention``, which the ViT/NesT blocks share under
``fused_attention=False``): separate q, k, v
kernels ``[D, H, hd]`` with biases ``[H, hd]`` and an out kernel ``[H, hd,
D]``, held here as one packed ``Dense`` ``qkv`` ``[D, 3 * H * hd]`` (q | k
| v, which ``convert`` concatenates) and ``out`` ``[H * hd, D]``. q is
divided by ``sqrt(hd)`` rounded to the compute dtype before the product,
as flax divides it, and a masked key's score becomes
``finfo(dtype).min``, an additive mask of that value. A sample whose mask
is all zeros gets flax's finite uniform average over every key (flax
fills all its scores; a boolean SDPA mask would give NaN or 0, depending
on the backend): its bias row is 0 and its q zero, so its scores are 0,
and the average sends no gradient into q and k, as flax's ``where`` sends
none (a fill of finfo.min on every key would be absorbed in the forward
and still pass a gradient back, and a backward that recomputes the
softmax from its log-sum-exp, as SDPA's flash form does, would lose the
log L that the fill absorbs). The scores, softmax and weighted sum are one
``F.scaled_dot_product_attention`` call: the JAX package computes them with
XLA (flax never reaches a Pallas kernel under a mask,
``vlp_tpu/ops/block_attention.py:287-294``), so a library call is their
counterpart here, as for the ResNet's convolutions. There is no dropout:
flax's attention has rate 0 and the encoder none of its own.

Under tensor parallelism (``parallel/tp.py``) a layer's attention splits
by heads (``vit.MultiHeadAttention``) where the JAX rule shards flax's
query kernel and the heads divide by M, and its FFN (``ffn_in`` by
columns, ``ffn_out`` by rows) where the rule shards ``ffn_in``; the
embedding tables split on the rule's dim (``vit.Embed``).

``load_hf_weights`` imports a pretrained HF checkpoint from the local hub
cache (``utils/hf_files.py``, never the network), the counterpart of
``vlp_tpu/models/bert.py:126-248``: DistilBERT's layout for ``distilbert``,
BERT's (TinyBERT's) for the other towers. Each HF ``Linear`` ``[out, in]``
becomes a ``Dense`` ``[in, out]``; q, k and v are transposed and
concatenated into the packed ``qkv`` (q | k | v, ``convert.pack_qkv``'s
order), the out-projection (``out_lin``, ``attention.output.dense``) goes to
``out``, the LayerNorms and embeddings map directly; the result is held in
fp32, as ``from_pretrained`` loads it. Files that are absent or cannot be
read give None and a warning naming the repo id (the caller keeps random
init, as the JAX package does); a key the layout needs that the checkpoint
lacks, a shape that differs, or a ``config.json`` whose layer or head count
is not the tower's raises, as the JAX converters, which run outside their
``try``, raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from vlp_tpu_torch.convert import check_state
from vlp_tpu_torch.models.vit import (Dense, Embed, LayerNorm,
                                      MultiHeadAttention, gelu_exact)
from vlp_tpu_torch.parallel import tp
from vlp_tpu_torch.utils import hf_files
from vlp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    use_token_type: bool = False
    layer_norm_eps: float = 1e-12
    hf_name: str = ""


DISTILBERT = BertConfig(hidden_size=768, num_layers=6, num_heads=12,
                        intermediate_size=3072, use_token_type=False,
                        hf_name="distilbert-base-uncased")
TINYBERT = BertConfig(hidden_size=312, num_layers=4, num_heads=12,
                      intermediate_size=1200, use_token_type=True,
                      hf_name="huawei-noah/TinyBERT_General_4L_312D")
# not a reference tower: the JAX package's 2-layer encoder for tests
MICROBERT = BertConfig(hidden_size=64, num_layers=2, num_heads=2,
                       intermediate_size=128, max_position=64)

TEXT_CONFIGS = {"distilbert": DISTILBERT, "tinybert": TINYBERT,
                "microbert": MICROBERT}


def padding_bias(attention_mask: torch.Tensor, dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L] 0/1 mask -> ([B, 1, 1, L] additive scores in ``dtype``: 0 for
    a valid key, ``finfo(dtype).min`` for a padded one (flax's fill), 0 on
    every key of a sample with no valid key; [B, 1, 1, 1] in ``dtype``: 1
    where the sample has a valid key, else 0, the factor of its q)."""
    pad = attention_mask == 0
    live = (~pad).any(-1)
    bias = torch.zeros(attention_mask.shape, dtype=dtype,
                       device=attention_mask.device)
    bias = bias.masked_fill(pad & live[:, None], torch.finfo(dtype).min)
    return bias[:, None, None, :], live.to(dtype)[:, None, None, None]


class BertLayer(nn.Module):
    """Post-LN encoder layer (flax ``layer{i}``)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.dtype = dtype
        self.attn = MultiHeadAttention(d, cfg.num_heads, device)
        self.attn_ln = LayerNorm(d, device, eps)
        self.ffn_in = Dense(d, cfg.intermediate_size, device)
        self.ffn_out = Dense(cfg.intermediate_size, d, device)
        self.ffn_ln = LayerNorm(d, device, eps)

    def tp_split_(self, mesh) -> Dict:
        return {**tp.prefixed("attn", tp.split_attention_(self.attn, mesh)),
                **tp.split_mlp_(self, "ffn_in", "ffn_out", mesh)}

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
        y = self.attn(x.to(self.dtype), bias, live)
        x = self.attn_ln((x + y).float()).to(self.dtype)
        y = self.ffn_out(gelu_exact(self.ffn_in(x)))
        return self.ffn_ln((x + y).float()).to(self.dtype)


class BertEncoder(nn.Module):
    """[B, L] int ids + [B, L] 0/1 mask -> [B, D] fp32 CLS embedding."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.hidden_size
        self.word_embeddings = Embed(cfg.vocab_size, d, device)
        self.position_embeddings = Embed(cfg.max_position, d, device)
        if cfg.use_token_type:
            self.token_type_embeddings = Embed(2, d, device)
        self.embed_ln = LayerNorm(d, device, cfg.layer_norm_eps)
        self.layers = nn.ModuleList(BertLayer(cfg, dtype, device)
                                    for _ in range(cfg.num_layers))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        length = input_ids.shape[1]
        pos = torch.arange(length, device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if self.cfg.use_token_type:  # every token is of type 0
            x = x + self.token_type_embeddings.weight[0]
        x = self.embed_ln(x).to(self.dtype)
        bias, live = padding_bias(attention_mask, self.dtype)
        for layer in self.layers:
            x = layer(x, bias, live)
        return x[:, 0].float()


# --------------------------------------------------------------------------
# HF checkpoint import
# --------------------------------------------------------------------------

# each HF layout's layer stack and, per port module of a layer, the HF
# module it comes from (q, k, v: the parts of the packed qkv)
HF_LAYOUTS = {
    "distilbert": ("transformer.layer", {
        "q": "attention.q_lin", "k": "attention.k_lin",
        "v": "attention.v_lin", "attn.out": "attention.out_lin",
        "attn_ln": "sa_layer_norm", "ffn_in": "ffn.lin1",
        "ffn_out": "ffn.lin2", "ffn_ln": "output_layer_norm"}),
    "bert": ("encoder.layer", {
        "q": "attention.self.query", "k": "attention.self.key",
        "v": "attention.self.value", "attn.out": "attention.output.dense",
        "attn_ln": "attention.output.LayerNorm",
        "ffn_in": "intermediate.dense", "ffn_out": "output.dense",
        "ffn_ln": "output.LayerNorm"}),
}
# config.json's layer and head counts under each layout's names
_HF_COUNTS = {"distilbert": ("n_layers", "n_heads"),
              "bert": ("num_hidden_layers", "num_attention_heads")}


def convert_hf_state(state: Mapping[str, torch.Tensor], cfg: BertConfig,
                     layout: str,
                     target: Any = None) -> Dict[str, torch.Tensor]:
    """A base model's HF state (``hf_files.base_model_state``) -> a
    ``BertEncoder``'s state dict in fp32 (``cfg``'s layer count and token
    types; the widths are the checkpoint's). With ``target`` (the encoder,
    or its keys mapped to tensors or shapes) the result must have exactly
    its keys and shapes (``convert.check_state``)."""
    def get(key: str) -> torch.Tensor:
        if key not in state:
            raise KeyError(f"the HF checkpoint lacks {key!r}")
        return state[key].float()

    out = {"word_embeddings.weight": get("embeddings.word_embeddings.weight"),
           "position_embeddings.weight":
               get("embeddings.position_embeddings.weight"),
           "embed_ln.weight": get("embeddings.LayerNorm.weight"),
           "embed_ln.bias": get("embeddings.LayerNorm.bias")}
    if cfg.use_token_type:
        out["token_type_embeddings.weight"] = get(
            "embeddings.token_type_embeddings.weight")
    stack, names = HF_LAYOUTS[layout]
    for i in range(cfg.num_layers):
        def hf(part: str, leaf: str) -> torch.Tensor:
            return get(f"{stack}.{i}.{names[part]}.{leaf}")

        pre = f"layers.{i}"
        out[f"{pre}.attn.qkv.weight"] = torch.cat(
            [hf(p, "weight").t() for p in "qkv"], 1)
        out[f"{pre}.attn.qkv.bias"] = torch.cat([hf(p, "bias")
                                                 for p in "qkv"])
        for part in ("attn.out", "ffn_in", "ffn_out"):
            out[f"{pre}.{part}.weight"] = hf(part, "weight").t()
            out[f"{pre}.{part}.bias"] = hf(part, "bias")
        for part in ("attn_ln", "ffn_ln"):
            for leaf in ("weight", "bias"):
                out[f"{pre}.{part}.{leaf}"] = hf(part, leaf)
    out = {k: v.contiguous() for k, v in out.items()}
    if target is not None:
        check_state(out, target, "the HF checkpoint")
    return out


def load_hf_weights(target: Any, model_key: str
                    ) -> Optional[Dict[str, torch.Tensor]]:
    """The pretrained HF weights of ``TEXT_CONFIGS[model_key]`` from the
    local hub cache as ``target``'s state dict (``target``: the encoder, or
    its keys mapped to tensors or shapes; a split or sharded model's full
    shapes), or None, with a warning, where they are not there."""
    cfg = TEXT_CONFIGS[model_key]
    try:
        found = hf_files.load_pretrained(cfg.hf_name) if cfg.hf_name \
            else None
        reason = "not in the hub cache " + hf_files.hub_cache_dir()
    except Exception as e:  # a file there that cannot be read
        found, reason = None, f"{type(e).__name__}: {e}"
    if found is None:
        logger.warning("Pretrained %s weights unavailable locally (%s); "
                       "text tower uses random init.",
                       cfg.hf_name or model_key, reason)
        return None
    config, state, path = found
    # the JAX package's choice: DistilBERT's converter for distilbert,
    # BERT's for every other tower
    layout = "distilbert" if model_key == "distilbert" else "bert"
    counts = tuple(config.get(k) for k in _HF_COUNTS[layout])
    if counts != (cfg.num_layers, cfg.num_heads):
        raise ValueError(
            f"{path}: config.json gives {counts} layers and heads, the "
            f"{model_key} tower has {(cfg.num_layers, cfg.num_heads)}")
    out = convert_hf_state(state, cfg, layout, target)
    logger.info("Read pretrained %s weights from %s", cfg.hf_name, path)
    return out
