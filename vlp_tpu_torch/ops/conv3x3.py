"""A 3x3 convolution, stride 1, SAME, as an implicit GEMM, for Hopper
(counterpart of the probe kernel ``benchmarks/conv_probe.py:pallas_conv3x3``).

  conv3x3: x [B, H, W, C], w [3, 3, C, K] -> y [B*H*W, K], the sum over the
           nine taps of the shifted map's rows [B*H*W, C] @ w[dy, dx],
           zero outside the map, fp32 accumulation cast once

It lies on no model path: the ResNets convolve through ``F.conv2d``, as the
JAX package left its convolutions to XLA; ``vlp_tpu_torch.probes
.conv_probe`` times it at ResNet34's stage-2/3 shapes beside cuDNN. A CUDA
tensor runs ``csrc/conv3x3.cu`` (on the wgmma + TMA mainloop
``csrc/wgmma_gemm.cuh``) or raises; a CPU tensor runs ``conv3x3_plain``. The wrapper counts its launches in
``conv3x3.launches``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops._common import _acc, _check_cuda, _route, _stream


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Nine shifted matmuls in fp32 (fp64 for fp64 inputs), summed in tap
    order, cast once to x's dtype."""
    b, h, wd, c = x.shape
    acc = _acc(x.dtype)
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))
    y = None
    for dy in range(3):
        for dx in range(3):
            t = xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, c) \
                @ w[dy, dx].to(acc)
            y = t if y is None else y + t
    return y.to(x.dtype)


def conv3x3(x: torch.Tensor, w: torch.Tensor, stride: int = 1
            ) -> torch.Tensor:
    """x [B, H, W, C], w [3, 3, C, K] -> [B*H*W, K] in x's dtype. Raises on
    stride != 1 and on C or K not a multiple of 16, whatever the device."""
    if stride != 1:
        raise ValueError(f"conv3x3: stride {stride}; the kernel takes 1")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:3] != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [B, H, W, C] and "
                         "[3, 3, C, K]")
    b, h, wd, c = x.shape
    k = w.shape[-1]
    if c % 16 or k % 16:
        raise ValueError(f"conv3x3: C {c} and K {k} must be multiples of 16")
    if not _route("conv3x3", x):
        return conv3x3_plain(x, w)
    _check_cuda("conv3x3", x, w)
    if w.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3: the CUDA kernel takes bfloat16 weights, "
                        f"got {w.dtype}")
    if (x.data_ptr() | w.data_ptr()) % 16:
        raise ValueError("conv3x3: the kernel takes 16-byte aligned operands")
    lib = _build.load_library()
    y = torch.empty((b * h * wd, k), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.vlp_conv3x3(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h,
                              wd, c, k, _stream())
    _build.check(lib, err, "conv3x3")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0

KERNELS = (conv3x3,)
