"""On-device batch augmentation and normalisation (counterpart of
``vlp_tpu/ops/augment.py``).

Training path, ``augment_and_normalize``: per-sample parameters from a
``torch.Generator``; translate, rotate, zoom (and the pretrain x-shear)
composed into one inverse affine map and applied by the 3-shear warp
(``ops/warp.py``, three ``shear_rows`` launches; the gather warp
``_warp_one`` is its plain numerical reference, for the tests); a vertical
flip; Gaussian noise (one ``add_gaussian_noise``
launch per batch, sigma 0 for samples that draw none, as on the TPU; at an
odd width, which the kernel's column pairs do not take, one dense normal
draw, the reference's branch ``vlp_tpu/ops/augment.py:209-211``); then
``(x - mean) / std`` or the torchxrayvision scaling, the channel repeat and
one cast. Eval path: ``normalize_only``. The generator streams differ from
``jax.random``'s, so the same seed gives other draws (ROADMAP.md Queue 3).

On a data mesh every draw with a batch dimension (the eleven parameter
vectors, the noise seeds, the odd width's dense draw) is made at the global
batch size from a generator in the same state on every rank, and each rank
takes its rows: a sample's warp and noise are the ones it gets in one
process at the global batch, and no two ranks repeat an augmentation.
``shear_rows`` and ``add_gaussian_noise`` then run on this rank's rows.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vlp_tpu_torch.ops.noise import add_gaussian_noise
from vlp_tpu_torch.ops.warp import affine_warp_shear
from vlp_tpu_torch.parallel.mesh import axis_size


class AugmentConfig(NamedTuple):
    translate_px: float = 20.0
    translate_prob: float = 0.3
    rotate_rad: float = math.pi / 6
    rotate_prob: float = 0.3
    zoom_min: float = 1.1
    zoom_max: float = 1.3
    zoom_prob: float = 0.3
    flip_prob: float = 0.3
    noise_std: float = 0.01
    noise_prob: float = 0.5
    shear_deg: float = 0.0  # pretrain uses 5 (PretrainDataModule.py:186-198)
    enabled: bool = True


def _sample_params(gen: torch.Generator, cfg: AugmentConfig, batch: int,
                   device) -> tuple:
    """Eleven independent draws of [batch] uniforms, one per (gate,
    magnitude): a magnitude never conditions on its gate. Shear fires on the
    translate Bernoulli (one RandAffined draw in the reference). Returns
    (tx, ty, theta, zoom, shear, flip, noise_std)."""
    u = [torch.rand(batch, generator=gen, device=device) for _ in range(11)]
    rng = lambda i, lo, hi: lo + (hi - lo) * u[i]  # noqa: E731
    zero = torch.zeros(batch, device=device)
    apply_affine = u[0] < cfg.translate_prob
    tx = torch.where(apply_affine,
                     rng(1, -cfg.translate_px, cfg.translate_px), zero)
    ty = torch.where(apply_affine,
                     rng(2, -cfg.translate_px, cfg.translate_px), zero)
    shear = torch.where(apply_affine & (cfg.shear_deg > 0),
                        rng(3, -cfg.shear_deg, cfg.shear_deg) * math.pi
                        / 180.0, zero)
    theta = torch.where(u[4] < cfg.rotate_prob,
                        rng(5, -cfg.rotate_rad, cfg.rotate_rad), zero)
    zoom = torch.where(u[6] < cfg.zoom_prob,
                       rng(7, cfg.zoom_min, cfg.zoom_max), zero + 1.0)
    flip = u[8] < cfg.flip_prob
    noise_std = torch.where(u[9] < cfg.noise_prob,
                            rng(10, 0.0, cfg.noise_std), zero)
    return tx, ty, theta, zoom, shear, flip, noise_std


def _bilinear_warp(img: torch.Tensor, src_y: torch.Tensor,
                   src_x: torch.Tensor) -> torch.Tensor:
    """Samples img [B, H, W] at float coordinates [B, H, W] (border
    clamping)."""
    b, h, w = img.shape
    sy = src_y.clamp(0.0, h - 1.0)
    sx = src_x.clamp(0.0, w - 1.0)
    y0 = torch.floor(sy).long()
    x0 = torch.floor(sx).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = sy - y0
    wx = sx - x0
    flat = img.reshape(b, h * w)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx).reshape(b, -1)
                            ).reshape(b, h, w)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _warp_one(img: torch.Tensor, tx, ty, theta, zoom,
              shear) -> torch.Tensor:
    """The gather warp over a batch: img [B, H, W], parameters [B]. Inverse
    map of output pixel p (centred): ``src = R(-theta) Sh(-s) p / z + c -
    t``, one 2-D bilinear resampling."""
    b, h, w = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    col = lambda t: t.float().reshape(b, 1, 1)  # noqa: E731
    dev = img.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx
    ys, xs = yy / col(zoom), xx / col(zoom)
    xs = xs - torch.tan(col(shear)) * ys
    cos_t, sin_t = torch.cos(col(theta)), torch.sin(col(theta))
    yr = cos_t * ys + sin_t * xs
    xr = -sin_t * ys + cos_t * xs
    return _bilinear_warp(img.float(), yr + cy - col(ty), xr + cx - col(tx))


def _normalize(x: torch.Tensor, mean: float, std: float, out_channels: int,
               dtype: torch.dtype, scale_intensity: bool) -> torch.Tensor:
    if scale_intensity:
        x = x * (2048.0 / 255.0) - 1024.0
    else:
        x = (x - mean) / std
    x = x[..., None]
    if out_channels > 1:
        x = x.expand(*x.shape[:-1], out_channels)
    return x.to(dtype).contiguous()


def augment_and_normalize(images_u8: torch.Tensor, gen: torch.Generator,
                          mean: float, std: float,
                          cfg: AugmentConfig = AugmentConfig(),
                          out_channels: int = 3,
                          dtype: torch.dtype = torch.bfloat16,
                          scale_intensity: bool = False,
                          mesh=None) -> torch.Tensor:
    """[B, H, W] uint8 -> augmented, normalised [B, H, W, C] in ``dtype``.
    ``gen`` lives on the images' device; each call advances it by eleven
    parameter draws and one pair of noise seeds per sample (at an odd
    width: one normal draw per pixel in place of the seeds), per sample of
    the global batch on a mesh (``images_u8`` then holds this rank's
    rows)."""
    x = images_u8.float()
    if cfg.enabled:
        b = x.shape[0]
        world = axis_size(mesh)
        rows = slice(0, b) if mesh is None else mesh.rows(b * world)
        tx, ty, theta, zoom, shear, flip, noise_std = (
            p[rows] for p in _sample_params(gen, cfg, b * world, x.device))
        x = affine_warp_shear(x, theta, zoom, tx, ty, shear)
        x = torch.where(flip[:, None, None], x.flip(1), x)
        # sigma in raw intensity units, as MONAI RandGaussianNoised adds
        # N(0, sigma <= 0.01) to the unnormalised 0..255 image
        if x.shape[-1] % 2 == 0:
            seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (b * world, 2),
                                  generator=gen, device=x.device,
                                  dtype=torch.int32)[rows].contiguous()
            x = add_gaussian_noise(x.contiguous(), seeds, noise_std)
        else:  # the kernel pairs columns: a dense draw, as the reference
            x = x + torch.randn((b * world, *x.shape[1:]), generator=gen,
                                device=x.device)[rows] \
                * noise_std[:, None, None]
    return _normalize(x, mean, std, out_channels, dtype, scale_intensity)


def normalize_only(images_u8: torch.Tensor, mean: float, std: float,
                   out_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                   scale_intensity: bool = False) -> torch.Tensor:
    """[B, H, W] uint8 -> [B, H, W, out_channels] in ``dtype`` (NHWC):
    ``(x - mean) / std``, or the torchxrayvision scaling to [-1024, 1024]
    when ``scale_intensity``; computed in fp32, cast once."""
    return _normalize(images_u8.float(), mean, std, out_channels, dtype,
                      scale_intensity)
