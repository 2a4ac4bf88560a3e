"""Transformer building blocks (counterpart of ``vlp_tpu/models/vit.py``).

Holds the pre-LN ``EncoderBlock`` on its half-block kernel path (3-D
``[N, S, D]`` input), the ``Dense`` and ``LayerNorm`` layers whose
parameters mirror flax's, and the flax-scaled random init. The ViT class
waits for its own kernel (``block_attention``, ROADMAP.md). The TPU's VMEM
gates (``supports_attn``/``supports_mlp``) are not carried over: on an H100
the kernels take every NesT-Small shape.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vlp_tpu_torch.ops.fused_block import ln_attention, ln_mlp

_LN_EPS = 1e-6
# flax lecun_normal: a normal truncated at two standard deviations, rescaled
# so that the truncated distribution's std is sqrt(1 / fan_in)
_TRUNC_STD_CORRECTION = 0.87962566103423978


class Dense(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` stored ``[in, out]``, the
    layout of a flax ``Dense`` kernel."""

    def __init__(self, in_features: int, out_features: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(in_features, out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.to(x.dtype) + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: fp32, eps 1e-6, variance as
    ``E[x^2] - E[x]^2`` clipped at 0 (flax's ``use_fast_variance``)."""

    def __init__(self, dim: int, device: Optional[torch.device] = None
                 ) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
        return (x - mu) * (torch.rsqrt(var + _LN_EPS) * self.weight) \
            + self.bias


class EncoderBlock(nn.Module):
    """Pre-LN transformer block on ``[N, S, D]`` tokens through the two
    half-block kernels: ``x = ln_attention(x)``, then ``ln_mlp`` over the
    ``[N*S, D]`` rows. Parameter names follow the JAX block's tree
    (``ln1``, ``attn/{qkv,out}``, ``ln2``, ``mlp/{fc1,fc2}``)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.num_heads = num_heads
        self.ln1 = LayerNorm(dim, device)
        self.attn = nn.ModuleDict({"qkv": Dense(dim, 3 * dim, device),
                                   "out": Dense(dim, dim, device)})
        self.ln2 = LayerNorm(dim, device)
        self.mlp = nn.ModuleDict({"fc1": Dense(dim, hidden, device),
                                  "fc2": Dense(hidden, dim, device)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, d = x.shape
        x = ln_attention(x, self.ln1.weight, self.ln1.bias,
                         self.attn.qkv.weight, self.attn.qkv.bias,
                         self.attn.out.weight, self.attn.out.bias,
                         self.num_heads)
        y = ln_mlp(x.reshape(n * s, d), self.ln2.weight, self.ln2.bias,
                   self.mlp.fc1.weight, self.mlp.fc1.bias,
                   self.mlp.fc2.weight, self.mlp.fc2.bias)
        return y.view(n, s, d)


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights at the scales of the JAX package's flax initializers:
    Dense and Conv kernels lecun-normal with zero biases, LayerNorm ones
    and zeros, position embeddings N(0, 0.02)."""
    for module in model.modules():
        if isinstance(module, Dense):
            _lecun_normal_(module.weight, module.weight.shape[0], generator)
            module.bias.zero_()
        elif isinstance(module, nn.Conv2d):
            w = module.weight
            _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3],
                           generator)
            module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        for name, p in module.named_parameters(recurse=False):
            if name.startswith("pos_embed"):
                nn.init.normal_(p, 0.0, 0.02, generator=generator)
