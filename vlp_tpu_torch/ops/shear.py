"""Per-line fractional shift with edge clamping, the shear primitive
(counterpart of ``vlp_tpu/ops/pallas_shear.py``).

  out[b, y, x] = lerp(img[b, y, c(k - pad + x)], img[b, y, c(k - pad + x + 1)],
                      frac)

with ``s = clip(shift[b, y], -max_shift, max_shift) + pad``, ``k = floor(s)``,
``frac = s - k`` (all fp32), ``pad = max_shift + 1`` and ``c`` clamping to
``[0, W - 1]``. The clamp is the TPU kernel's edge padding: every index the
TPU kernel reads lies inside its padded row, and a padded element is the
clamped image element, so no padded copy is made. ``axis=0`` shifts columns
instead (``shift`` [B, W], lines run along y), the y-shear of the warp
without a transpose.

A CUDA tensor runs ``csrc/shear.cu`` or raises; a CPU tensor runs
``shear_rows_plain``. The kernel rounds each of ``a * (1 - f)``, ``b * f``
and their sum separately (no FMA contraction), as the plain version does,
so the two agree exactly. The kernel's index arithmetic is 32-bit, so any
device refuses ``B * H * W >= 2^31``; it stages whole lines in shared
memory, so it takes rows of at most ``MAX_ROW`` pixels (axis 1) and
columns of at most ``MAX_COLUMN`` (axis 0).
"""
from __future__ import annotations

import torch

from vlp_tpu_torch.ops import _build

# the longest lines whose blocks fit the card's 227 KB of shared memory a
# block (csrc/shear.cu): 8 rows of round_up(W, 4) words, a strip of H x 33
MAX_ROW = 7264
MAX_COLUMN = 1760


def _shift_parts(shift: torch.Tensor, max_shift: int):
    s = shift.float().clamp(-float(max_shift), float(max_shift)) \
        + float(max_shift + 1)
    k = torch.floor(s)
    return k.long() - (max_shift + 1), s - k


def shear_rows_plain(img: torch.Tensor, shift: torch.Tensor, max_shift: int,
                     axis: int = 1) -> torch.Tensor:
    """Plain PyTorch ``shear_rows``: img [B, H, W] fp32; shift [B, H]
    (``axis=1``) or [B, W] (``axis=0``)."""
    if axis == 0:
        return shear_rows_plain(img.transpose(1, 2), shift, max_shift,
                                1).transpose(1, 2).contiguous()
    b, h, w = img.shape
    start, frac = _shift_parts(shift, max_shift)               # [B, H]
    idx = start[:, :, None] + torch.arange(w, device=img.device)
    lo = torch.gather(img, 2, idx.clamp(0, w - 1))
    hi = torch.gather(img, 2, (idx + 1).clamp(0, w - 1))
    f = frac[:, :, None]
    return lo * (1.0 - f) + hi * f


def shear_rows(img: torch.Tensor, shift: torch.Tensor, max_shift: int,
               axis: int = 1) -> torch.Tensor:
    """Shifts each row (``axis=1``) or column (``axis=0``) of img [B, H, W]
    fp32 by its own fractional ``shift``, edge-clamped and bilinear."""
    b, h, w = img.shape
    if axis not in (0, 1) or shift.shape != (b, h if axis == 1 else w):
        raise ValueError(f"shear_rows: shift {tuple(shift.shape)} does not "
                         f"fit img {tuple(img.shape)} along axis {axis}")
    if b * h * w >= 2 ** 31:
        raise ValueError(f"shear_rows: img {tuple(img.shape)} has 2^31 or "
                         "more elements; the kernel indexes in 32 bits")
    if img.device.type == "cpu":
        return shear_rows_plain(img, shift, max_shift, axis)
    if img.device.type != "cuda":
        raise ValueError(f"shear_rows: no kernel or plain version for device "
                         f"{img.device}")
    if img.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError("shear_rows: the CUDA kernel takes fp32 img and "
                        "shift")
    if shift.device != img.device or not (img.is_contiguous()
                                          and shift.is_contiguous()):
        raise ValueError("shear_rows: operands must be contiguous and on "
                         "one device")
    if (w if axis == 1 else h) > (MAX_ROW if axis == 1 else MAX_COLUMN):
        raise ValueError(f"shear_rows: the kernel stages lines of at most "
                         f"{MAX_ROW} pixels along rows and {MAX_COLUMN} "
                         f"along columns, got img {tuple(img.shape)} along "
                         f"axis {axis}")
    if b > 65535:
        raise ValueError(f"shear_rows: the kernel takes at most 65535 "
                         f"images, got {b}")
    lib = _build.load_library()
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        err = lib.vlp_shear_rows(img.data_ptr(), shift.data_ptr(),
                                 out.data_ptr(), b, h, w, max_shift, axis,
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "shear_rows")
    shear_rows.launches += 1
    return out


shear_rows.launches = 0
