"""Affine warp by three shears and a zoom (counterpart of
``vlp_tpu/ops/warp.py``).

Rotation and translation by the 3-shear decomposition (Paeth 1986): an
x-shear, a y-shear and an x-shear, each one launch of ``shear_rows`` (the
y-shear along columns, with no transpose); then the zoom about the centre as
``Wz @ img @ Wz^T`` per sample with ``[S, S]`` bilinear weights, a plain
fp32 matmul as it was XLA outside Pallas on the TPU. TF32 is switched off
around that matmul: it would round the intensities (up to 255) to 10-bit
mantissas, an error of up to 0.12.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from vlp_tpu_torch.ops.shear import shear_rows


def _zoom_matrix(size: int, zoom: torch.Tensor) -> torch.Tensor:
    """[B, S, S] bilinear resampling weights for ``src = (x - c)/zoom + c``
    with edge clamping; two nonzero entries per row."""
    c = (size - 1) / 2.0
    dst = torch.arange(size, dtype=torch.float32, device=zoom.device)
    src = ((dst[None, :] - c) / zoom[:, None] + c).clamp(0.0, size - 1.0)
    k = torch.floor(src)
    f = src - k
    cols = torch.arange(size, dtype=torch.float32, device=zoom.device)
    lo = (cols == k[..., None]).float() * (1.0 - f[..., None])
    hi = (cols == torch.clamp(k + 1, max=size - 1)[..., None]).float() \
        * f[..., None]
    return lo + hi


@contextlib.contextmanager
def _fp32_matmul():
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def default_max_shift(h: int, w: int) -> int:
    """tan(15 deg) * 112 + 20 px translate + shear slack, as the JAX warp."""
    return int(0.27 * max(h, w) + 24 + 0.1 * max(h, w))


def shear_shifts(theta: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
                 shear: torch.Tensor, h: int, w: int):
    """The per-line shifts of the three shears, [B, H], [B, W] and [B, H]
    fp32: an x-shear of the rows, a y-shear of the columns, an x-shear of
    the rows, each a linear ramp along the other axis."""
    half = torch.tan(theta / 2.0)
    a1, a2, a3 = -half, torch.sin(theta), -half
    b2 = -ty
    b1 = -tx - a1 * b2
    v = torch.arange(h, dtype=torch.float32, device=theta.device) \
        - (h - 1) / 2.0
    u = torch.arange(w, dtype=torch.float32, device=theta.device) \
        - (w - 1) / 2.0
    slope1 = a1 - torch.tan(shear)
    return ((slope1[:, None] * v + b1[:, None]).contiguous(),
            (a2[:, None] * u + b2[:, None]).contiguous(),
            (a3[:, None] * v).contiguous())


def affine_warp_shear(images: torch.Tensor, theta: torch.Tensor,
                      zoom: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
                      shear: Optional[torch.Tensor] = None,
                      max_shift: Optional[int] = None) -> torch.Tensor:
    """images [B, H, W] (square) -> warped fp32 [B, H, W]; per-sample
    rotation ``theta``, ``zoom``, translation ``tx``/``ty`` and x-shear
    ``shear`` (radians), the inverse map of ``vlp_tpu.ops.augment``."""
    b, h, w = images.shape
    if shear is None:
        shear = torch.zeros_like(theta)
    if max_shift is None:
        max_shift = default_max_shift(h, w)
    images = images.float().contiguous()
    s1, s2, s3 = shear_shifts(theta, tx, ty, shear, h, w)
    x1 = shear_rows(images, s1, max_shift, axis=1)
    x2 = shear_rows(x1, s2, max_shift, axis=0)
    x3 = shear_rows(x2, s3, max_shift, axis=1)
    wz = _zoom_matrix(h, zoom)
    with _fp32_matmul():
        return wz @ x3 @ wz.transpose(1, 2)
