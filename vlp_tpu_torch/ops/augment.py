"""Deterministic eval-time image preparation (counterpart of
``vlp_tpu/ops/augment.py:normalize_only``). The training augmentations
(shear warp, Gaussian noise) belong to the training slice and are not
ported yet (ROADMAP.md)."""
from __future__ import annotations

import torch


def normalize_only(images_u8: torch.Tensor, mean: float, std: float,
                   out_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                   scale_intensity: bool = False) -> torch.Tensor:
    """[B, H, W] uint8 -> [B, H, W, out_channels] in ``dtype`` (NHWC):
    ``(x - mean) / std``, or the torchxrayvision scaling to [-1024, 1024]
    when ``scale_intensity``; computed in fp32, cast once."""
    x = images_u8.float()
    if scale_intensity:
        x = x * (2048.0 / 255.0) - 1024.0
    else:
        x = (x - mean) / std
    x = x[..., None]
    if out_channels > 1:
        x = x.expand(*x.shape[:-1], out_channels)
    return x.to(dtype).contiguous()
