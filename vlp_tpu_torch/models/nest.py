"""NesT (Nested Hierarchical Transformer) — counterpart of
``vlp_tpu/models/nest.py``.

4x4 conv patch embed; per level the NHWC token map is cut into 14x14
blocks that fold into the batch, the level's encoder blocks attend within
each block (``ln_attention`` / ``ln_mlp`` kernels), and a ConvPool (3x3
conv, LayerNorm, 3x3/2 max pool) joins the levels. Head: fp32 LayerNorm
and a global mean over H and W. Activations are NHWC, as in the JAX
package; the convolutions (outside Pallas there too) go to ``F.conv2d``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vlp_tpu_torch.models.vit import EncoderBlock, LayerNorm


def blockify(x: torch.Tensor, block: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, nb, block*block, C] with nb = (H/b)*(W/b)."""
    b, h, w, c = x.shape
    gh, gw = h // block, w // block
    x = x.reshape(b, gh, block, gw, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, block * block, c)


def unblockify(x: torch.Tensor, block: int, h: int, w: int) -> torch.Tensor:
    """Inverse of blockify."""
    b, _, _, c = x.shape
    gh, gw = h // block, w // block
    x = x.reshape(b, gh, gw, block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, stride: int,
              padding: int) -> torch.Tensor:
    """flax ``nn.Conv`` in the activation dtype on NHWC: the convolution
    without bias, then the bias added in that dtype."""
    dt = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dt), None,
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1) + conv.bias.to(dt)


class ConvPool(nn.Module):
    """Level aggregation: 3x3 conv (pad 1) -> fp32 LayerNorm over channels
    -> 3x3/2 max pool (pad 1 with -inf)."""

    def __init__(self, in_dim: int, out_dim: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_dim, out_dim, 3, padding=1, device=device)
        self.norm = LayerNorm(out_dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = self.norm(conv_nhwc(x, self.conv, 1, 1)).to(dt)
        y = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1)
        return y.permute(0, 2, 3, 1)


class NesT(nn.Module):
    def __init__(self, img_size: int = 224, in_chans: int = 3,
                 patch_size: int = 4,
                 embed_dims: Sequence[int] = (96, 192, 384),
                 num_heads: Sequence[int] = (3, 6, 12),
                 depths: Sequence[int] = (2, 2, 20), block_size: int = 14,
                 dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.patch_size = patch_size
        self.block_size = block_size
        self.num_features = embed_dims[-1]
        self.patch_embed = nn.Conv2d(in_chans, embed_dims[0], patch_size,
                                     stride=patch_size, device=device)
        size = img_size // patch_size
        levels, pools = [], []
        for li, (dim, heads, depth) in enumerate(
                zip(embed_dims, num_heads, depths)):
            nb = (size // block_size) ** 2
            # stored blockified, [1, nb, S, D]: the JAX checkpoint layout
            self.register_parameter(f"pos_embed_{li}", nn.Parameter(
                torch.zeros(1, nb, block_size ** 2, dim, device=device)))
            levels.append(nn.ModuleList(
                EncoderBlock(dim, heads, device=device)
                for _ in range(depth)))
            if li < len(embed_dims) - 1:
                pools.append(ConvPool(dim, embed_dims[li + 1], device))
            size //= 2
        self.levels = nn.ModuleList(levels)
        self.pools = nn.ModuleList(pools)
        self.final_norm = LayerNorm(embed_dims[-1], device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images in the compute dtype -> pooled fp32 features."""
        x = conv_nhwc(x.to(self.dtype), self.patch_embed, self.patch_size, 0)
        size = x.shape[1]
        for li, blocks in enumerate(self.levels):
            pos = getattr(self, f"pos_embed_{li}")
            t = blockify(x, self.block_size) + pos.to(self.dtype)
            b, nb, s, d = t.shape
            t = t.reshape(b * nb, s, d)
            for blk in blocks:
                t = blk(t)
            x = unblockify(t.reshape(b, nb, s, d), self.block_size, size,
                           size)
            if li < len(self.pools):
                x = self.pools[li](x)
                size //= 2
        return self.final_norm(x).mean(dim=(1, 2))


def nest_small(**kw) -> NesT:
    return NesT(embed_dims=(96, 192, 384), num_heads=(3, 6, 12),
                depths=(2, 2, 20), **kw)
