"""Vision Transformer and the pre-LN transformer block (counterpart of
``vlp_tpu/models/vit.py``).

``EncoderBlock`` on ``[N, S, D]`` tokens takes one of the reference's two
compositions per half block, by the same per-shape choice:

- the half-block kernels (``ln_attention``, ``ln_mlp``) when ``megakernel``
  and ``fused_attention`` are set and ``supports_attn`` / ``supports_mlp``
  hold (NesT-Small by default);
- otherwise the unfused path: ``LayerNorm`` -> ``FusedSelfAttention``
  (``Dense`` qkv -> the ``attend_qkv`` kernel -> ``Dense`` out) -> residual,
  then ``LayerNorm`` -> ``MlpBlock`` (the ``fused_mlp`` kernel where
  ``fused_mlp.supports`` holds, else ``Dense`` -> GELU -> ``Dense``) ->
  residual. ViT-B/16 and ViT-L/16 take it at full width, NesT with
  ``megakernel=False``.

On a NesT token map ``[B, H, W, D]`` (``window`` set, NesT with
``nhwc_windows``) the attention half is ``ln_attention_windows`` straight
on the map, and the MLP half ``ln_mlp`` on its rows where ``supports_mlp``
holds, else ``LayerNorm`` -> ``MlpBlock`` -> residual (the reference's
``_window_call``).

The predicates are copies of the TPU kernels' VMEM arithmetic
(``ops/fused_block.py``, ``ops/fused_mlp.py``): they say which composition
the reference computes at a shape, and the port computes the same one.
``Dense`` and ``LayerNorm`` mirror flax's parameters and rounding;
``flax_init_`` gives the flax initializers' scales. The flax
``MultiHeadDotProductAttention`` path (``fused_attention=False``, separate
query/key/value parameters) is not ported (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vlp_tpu_torch.ops import fused_mlp as FM
from vlp_tpu_torch.ops.block_attention import attend_qkv
from vlp_tpu_torch.ops.fused_block import (ln_attention,
                                           ln_attention_windows, ln_mlp,
                                           supports_attn, supports_mlp)

_LN_EPS = 1e-6
_BN_EPS = 1e-5
# flax lecun_normal: a normal truncated at two standard deviations, rescaled
# so that the truncated distribution's std is sqrt(1 / fan_in)
_TRUNC_STD_CORRECTION = 0.87962566103423978
# sqrt(0.5) as jax.nn.gelu casts it to a bf16 input's dtype
_SQRT_HALF_BF16 = 0.70703125


class Dense(nn.Module):
    """``y = x @ weight + bias`` with ``weight`` stored ``[in, out]``, the
    layout of a flax ``Dense`` kernel; in the input's dtype, the product
    rounded before the bias is added, as flax's ``Dense(dtype=...)``."""

    def __init__(self, in_features: int, out_features: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(in_features, out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.to(x.dtype) + self.bias.to(x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32, epsilon=eps)``: fp32, eps 1e-6
    unless given (BERT's is 1e-12), variance as ``E[x^2] - E[x]^2`` clipped
    at 0 (flax's ``use_fast_variance``)."""

    def __init__(self, dim: int, device: Optional[torch.device] = None,
                 eps: float = _LN_EPS) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp(min=0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class Embed(nn.Module):
    """flax ``nn.Embed(param_dtype=float32)``: a ``[num, features]`` fp32
    table whose rows the ids pick, in fp32."""

    def __init__(self, num: int, features: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, features, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype,
    param_dtype=float32)`` over axis 1 of an NCHW tensor. Statistics in
    fp32 with the fast variance ``E[x^2] - E[x]^2`` clipped at 0; in
    training mode (``self.training``) it normalises with the batch
    statistics and updates ``running = 0.9 running + 0.1 batch`` with the
    biased batch variance (no ``num_batches_tracked``), in eval mode it
    normalises with the running statistics; the result is cast to
    ``dtype``. ``torch.nn.BatchNorm2d`` differs: it keeps the unbiased
    variance as its running one."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = (0, *range(2, x.dim()))
            mean = x.mean(axes)
            var = ((x * x).mean(axes) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + _BN_EPS) * self.weight
        y = (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(self.dtype)


def gelu_exact(h: torch.Tensor) -> torch.Tensor:
    """``nn.gelu(h, approximate=False)`` as ``jax.nn.gelu`` writes it,
    ``0.5 * h * erfc(-h * sqrt(0.5))``, each operation in h's dtype: for
    bf16 the product with bf16(sqrt(0.5)), erfc and the final product each
    round to bf16 (torch computes each in fp32 and rounds once, as XLA does
    op by op). Under jit XLA may keep fp32 between the three operations;
    that moves a result by at most one bf16 ulp."""
    c = _SQRT_HALF_BF16 if h.dtype == torch.bfloat16 else math.sqrt(0.5)
    return (0.5 * h) * torch.special.erfc(-h * c)


class FusedSelfAttention(nn.Module):
    """One packed QKV projection to ``[N, S, 3D]``, the ``attend_qkv``
    kernel on it (heads stay packed), and the output projection: the
    reference's ``FusedSelfAttention``, parameters ``qkv`` and ``out``."""

    def __init__(self, dim: int, num_heads: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, device)
        self.out = Dense(dim, dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(attend_qkv(self.qkv(x), self.num_heads))


class MlpBlock(nn.Module):
    """fc1 -> exact GELU -> fc2 (the reference's ``MlpBlock``): the
    ``fused_mlp`` kernel where ``fused_mlp.supports`` holds for the rows,
    else two ``Dense`` layers around ``gelu_exact``; one parameter tree."""

    def __init__(self, dim: int, hidden: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.fc1 = Dense(dim, hidden, device)
        self.fc2 = Dense(hidden, dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, d = x.shape[:-1], x.shape[-1]
        m = math.prod(lead)
        if FM.supports(m, d, self.fc1.weight.shape[1], x.element_size()):
            return FM.fused_mlp(x.reshape(m, d), self.fc1.weight,
                                self.fc1.bias, self.fc2.weight,
                                self.fc2.bias).view(*lead, d)
        return self.fc2(gelu_exact(self.fc1(x)))


class EncoderBlock(nn.Module):
    """Pre-LN transformer block on ``[N, S, D]`` tokens, or on a
    ``[B, H, W, D]`` token map with attention inside ``window`` x
    ``window`` tiles, in the compute dtype; parameter names follow the JAX
    block's tree (``ln1``, ``attn/{qkv,out}``, ``ln2``, ``mlp/{fc1,fc2}``),
    the same on every path (module docstring)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 device: Optional[torch.device] = None, *,
                 fused_attention: bool = True,
                 megakernel: bool = True,
                 window: Optional[int] = None) -> None:
        super().__init__()
        if not fused_attention:
            raise NotImplementedError(
                "fused_attention=False (flax MultiHeadDotProductAttention, "
                "separate query/key/value parameters) is not ported to "
                "vlp_tpu_torch yet; see ROADMAP.md")
        self.num_heads = num_heads
        self.megakernel = megakernel
        self.window = window
        self.ln1 = LayerNorm(dim, device)
        self.attn = FusedSelfAttention(dim, num_heads, device)
        self.ln2 = LayerNorm(dim, device)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:
            return self._window_forward(x)
        n, s, d = x.shape
        if self.megakernel and supports_attn(n, s, d, self.num_heads,
                                             x.element_size()):
            x = ln_attention(x, *self._attn_params(), self.num_heads)
        else:
            x = x + self.attn(self.ln1(x).to(x.dtype))
        return self._mlp_half(x, self.megakernel)

    def _window_forward(self, x: torch.Tensor) -> torch.Tensor:
        """NesT's blockify-free path on the map [B, H, W, D]
        (``vlp_tpu/models/vit.py:218-245``); the caller (NesT) checks
        ``supports_window``."""
        if not self.window:
            raise ValueError("EncoderBlock: a [B, H, W, D] input needs "
                             "window=")
        x = ln_attention_windows(x, self.window, *self._attn_params(),
                                 self.num_heads)
        return self._mlp_half(x, True)

    def _attn_params(self):
        return (self.ln1.weight, self.ln1.bias, self.attn.qkv.weight,
                self.attn.qkv.bias, self.attn.out.weight, self.attn.out.bias)

    def _mlp_half(self, x: torch.Tensor, fused: bool) -> torch.Tensor:
        """``ln_mlp`` on x's rows where ``fused`` and ``supports_mlp`` hold,
        else LayerNorm -> MlpBlock -> residual."""
        d = x.shape[-1]
        m = x.numel() // d
        mlp = self.mlp
        if fused and supports_mlp(m, d, mlp.fc1.weight.shape[1],
                                  x.element_size()):
            y = ln_mlp(x.reshape(m, d), self.ln2.weight, self.ln2.bias,
                       mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight,
                       mlp.fc2.bias)
            return y.view(x.shape)
        return x + mlp(self.ln2(x).to(x.dtype))


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, stride: int,
              padding: int) -> torch.Tensor:
    """flax ``nn.Conv`` in the activation dtype on NHWC: the convolution
    without bias, then the bias, where the conv has one, added in that
    dtype."""
    dt = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dt), None,
                 stride=stride, padding=padding).permute(0, 2, 3, 1)
    return y if conv.bias is None else y + conv.bias.to(dt)


class ViT(nn.Module):
    """Pre-LN ViT with a class token (the reference's ``ViT``): patch conv,
    CLS token, position embedding, ``depth`` encoder blocks (``blocks.i``,
    flax ``block{i}``), a final fp32 LayerNorm; returns the CLS feature."""

    def __init__(self, img_size: int = 224, in_chans: int = 3,
                 patch_size: int = 16, hidden_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.bfloat16,
                 fused_attention: bool = True, megakernel: bool = True,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.num_features = hidden_dim
        self.patch_embed = nn.Conv2d(in_chans, hidden_dim, patch_size,
                                     stride=patch_size, device=device)
        self.cls_token = nn.Parameter(
            torch.zeros(1, 1, hidden_dim, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(
            1, (img_size // patch_size) ** 2 + 1, hidden_dim, device=device))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, mlp_ratio, device,
                         fused_attention=fused_attention,
                         megakernel=megakernel)
            for _ in range(depth))
        self.final_ln = LayerNorm(hidden_dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> the fp32 CLS feature [B, D]."""
        b, dt = x.shape[0], self.dtype
        x = conv_nhwc(x.to(dt), self.patch_embed, self.patch_size, 0)
        x = x.reshape(b, -1, self.num_features)
        cls = self.cls_token.to(dt).expand(b, 1, self.num_features)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for blk in self.blocks:
            x = blk(x)
        return self.final_ln(x)[:, 0]


def vit_base_patch16_224(**kw) -> ViT:
    return ViT(patch_size=16, hidden_dim=768, depth=12, num_heads=12, **kw)


def vit_large_patch16_224(**kw) -> ViT:
    return ViT(patch_size=16, hidden_dim=1024, depth=24, num_heads=16, **kw)


FEATURE_DIMS = {"vit_base_patch16_224": 768, "vit_large_patch16_224": 1024}


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD_CORRECTION
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights at the scales of the JAX package's flax initializers:
    Dense and Conv kernels lecun-normal with zero biases (a conv may have
    none; the text tower's packed q|k|v and out kernels are Dense, fan-in
    D and H * hd), LayerNorm and BatchNorm ones and zeros, BatchNorm's
    running mean 0 and variance 1, position embeddings N(0, 0.02), the
    class token zeros; ``Embed`` tables N(0, 1 / features) (flax's
    ``default_embed_init``, a plain normal). A module with raw parameters
    of another kind initialises them in its ``flax_init_own_(generator)``,
    which is called first."""
    for module in model.modules():
        if hasattr(module, "flax_init_own_"):
            module.flax_init_own_(generator)
        if isinstance(module, Dense):
            _lecun_normal_(module.weight, module.weight.shape[0], generator)
            module.bias.zero_()
        elif isinstance(module, Embed):
            nn.init.normal_(module.weight, 0.0,
                            module.weight.shape[1] ** -0.5,
                            generator=generator)
        elif isinstance(module, nn.Conv2d):
            w = module.weight
            _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3],
                           generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (LayerNorm, BatchNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            if isinstance(module, BatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        for name, p in module.named_parameters(recurse=False):
            if name.startswith("pos_embed"):
                nn.init.normal_(p, 0.0, 0.02, generator=generator)
            elif name == "cls_token":
                p.zero_()
