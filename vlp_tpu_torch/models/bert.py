"""Text towers: the DistilBERT and TinyBERT architectures (counterpart of
``vlp_tpu/models/bert.py``), from random weights.

A post-LN transformer encoder over token ids and a 0/1 padding mask whose
output is the CLS row, in fp32. Embeddings (word + position, + token type
0 for TinyBERT's BERT layout) are summed in fp32 and normalised by the
embedding LayerNorm, then cast to the compute dtype. Each layer, as flax
computes it: ``y = attn(x)``; ``x = LN(x + y)`` (the sum in the compute
dtype, the LayerNorm in fp32 with eps 1e-12, cast back); ``y =
ffn_out(gelu(ffn_in(x)))`` with the exact erf GELU; ``x = LN(x + y)``.

Attention is flax's ``MultiHeadDotProductAttention``: separate q, k, v
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

``load_hf_weights`` (HF checkpoints from a local cache) is not ported: no
HF files are in the repository or on the machine with the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vlp_tpu_torch.models.vit import Dense, Embed, LayerNorm, gelu_exact


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


class MultiHeadAttention(nn.Module):
    """Self-attention of flax ``nn.MultiHeadDotProductAttention(num_heads,
    dtype, param_dtype=float32)`` under a padding mask."""

    def __init__(self, dim: int, heads: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.heads = heads
        self.qkv = Dense(dim, 3 * dim, device)
        self.out = Dense(dim, dim, device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
        """x [B, L, D] in the compute dtype; bias and live from
        ``padding_bias``."""
        b, length, d = x.shape
        hd = d // self.heads
        qkv = self.qkv(x).view(b, length, 3, self.heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        # flax: query / jnp.sqrt(depth).astype(dtype)
        q = q / torch.tensor(math.sqrt(hd), dtype=x.dtype).item() * live
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                           scale=1.0)
        return self.out(o.transpose(1, 2).reshape(b, length, d))


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
