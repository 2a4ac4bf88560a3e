"""NesT (Nested Hierarchical Transformer) — counterpart of
``vlp_tpu/models/nest.py``.

4x4 conv patch embed; per level the NHWC token map is cut into 14x14
blocks that fold into the batch, the level's encoder blocks attend within
each block (``ln_attention`` / ``ln_mlp`` kernels by default; with
``megakernel=False`` the unfused block, ``attend_qkv`` and ``fused_mlp``),
and a ConvPool (3x3 conv, LayerNorm, 3x3/2 max pool) joins the levels. Head: fp32 LayerNorm
and a global mean over H and W. With ``fused_attention=False`` the blocks
take flax's attention layout (``vit.EncoderBlock``) and the windowed route
is off; with ``remat`` each block of either route is rematerialised
(``vit.run_block``). Activations are NHWC, as in the JAX
package; the convolutions (outside Pallas there too) go to ``F.conv2d``.

With ``nhwc_windows`` (a plain attribute that ``forward`` reads, so a built
model can be switched without touching its parameters) a level whose shape
passes ``supports_window`` skips blockify and unblockify: the blocks run on
the map itself, through ``ln_attention_windows`` (the reference's
``_level_uses_nhwc`` branch). The JAX package's config has no key for it,
and neither has the port's.

Under tensor parallelism (``parallel/tp.py``) each block splits as
``vit.EncoderBlock`` does (NesT-Small's level 0 stays whole: all its
weights are under 2^16), a ConvPool's conv by output channels, and the
position embeddings are gathered where they are added; a level with a
split attention takes the blockified route.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vlp_tpu_torch.models.vit import (EncoderBlock, LayerNorm, conv_nhwc,
                                      run_block)
from vlp_tpu_torch.ops.fused_block import (blockify, supports_window,
                                           unblockify)
from vlp_tpu_torch.parallel import tp


class ConvPool(nn.Module):
    """Level aggregation: 3x3 conv (pad 1) -> fp32 LayerNorm over channels
    -> 3x3/2 max pool (pad 1 with -inf)."""

    def __init__(self, in_dim: int, out_dim: int,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.conv = nn.Conv2d(in_dim, out_dim, 3, padding=1, device=device)
        self.norm = LayerNorm(out_dim, device)

    def tp_split_(self, mesh) -> Dict:
        return tp.prefixed("conv", tp.split_conv_out_(self.conv, mesh))

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
                 fused_attention: bool = True, megakernel: bool = True,
                 nhwc_windows: bool = False, remat: bool = False,
                 device: Optional[torch.device] = None) -> None:
        super().__init__()
        self.dtype = dtype
        # the windowed kernels need the packed layout, as in the reference
        self.megakernel = megakernel and fused_attention
        self.remat = remat
        self.nhwc_windows = nhwc_windows
        self.embed_dims = tuple(embed_dims)
        self.num_heads = tuple(num_heads)
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
                EncoderBlock(dim, heads, device=device,
                             fused_attention=fused_attention,
                             megakernel=megakernel, window=block_size)
                for _ in range(depth)))
            if li < len(embed_dims) - 1:
                pools.append(ConvPool(dim, embed_dims[li + 1], device))
            size //= 2
        self.levels = nn.ModuleList(levels)
        self.pools = nn.ModuleList(pools)
        self.final_norm = LayerNorm(embed_dims[-1], device)

    def tp_split_(self, mesh) -> Dict:
        return {**tp.prefixed("patch_embed",
                              tp.split_conv_out_(self.patch_embed, mesh)),
                **tp.gather_params_(self, [f"pos_embed_{li}" for li in
                                           range(len(self.levels))], mesh)}

    def _level_uses_nhwc(self, x: torch.Tensor, li: int) -> bool:
        """The reference's choice (``vlp_tpu/models/nest.py:127-148``) on
        one device: the windowed kernels for level ``li`` of map x."""
        if not (self.megakernel and self.nhwc_windows) or any(
                blk.attn_split for blk in self.levels[li]):
            return False
        b, h, w, d = x.shape
        # by level, not by width: embed_dims may repeat
        heads = self.num_heads[li] if d == self.embed_dims[li] else 0
        return heads > 0 and supports_window(b, h, w, d, heads,
                                             self.block_size,
                                             x.element_size())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images in the compute dtype -> pooled fp32 features."""
        x = conv_nhwc(x.to(self.dtype), self.patch_embed, self.patch_size, 0)
        size = x.shape[1]
        for li, blocks in enumerate(self.levels):
            # stored blockified, [1, nb, S, D]
            pos = tp.full_param(getattr(self, f"pos_embed_{li}")).to(
                self.dtype)
            if self._level_uses_nhwc(x, li):
                # the kernels take a contiguous map: a copy only where the
                # convolution or the pool left another layout
                x = (x + unblockify(pos, self.block_size, size, size)
                     ).contiguous()
                for blk in blocks:
                    x = run_block(blk, x, self.remat)
            else:
                t = blockify(x, self.block_size) + pos
                b, nb, s, d = t.shape
                t = t.reshape(b * nb, s, d)
                for blk in blocks:
                    t = run_block(blk, t, self.remat)
                x = unblockify(t.reshape(b, nb, s, d), self.block_size, size,
                               size)
            if li < len(self.pools):
                x = self.pools[li](x)
                size //= 2
        return self.final_norm(x).mean(dim=(1, 2))


def nest_small(**kw) -> NesT:
    return NesT(embed_dims=(96, 192, 384), num_heads=(3, 6, 12),
                depths=(2, 2, 20), **kw)
