"""A GEMM with a folded BatchNorm affine and ReLU as its prologue, for
Hopper (counterpart of the probe kernel
``benchmarks/bn_gemm_probe.py:make_pallas``).

  bn_relu_gemm: x [M, C], a and b [1, C] fp32, w [C, K] ->
                bf16(relu(x * a + b)) @ w, fp32 accumulation cast once

The ResNet50 bottleneck boundary ``relu(bn(x)) @ W`` with the normalised
map kept out of device memory. It lies on no model path (the ResNets run
BatchNorm and their 1x1 convolutions as separate PyTorch ops, as the JAX
package ran them in XLA); ``vlp_tpu_torch.probes.bn_gemm_probe`` times it
at ResNet50's stage-1/2 shapes beside the two-op PyTorch version. A CUDA
tensor runs ``csrc/bn_relu_gemm.cu`` or raises; a CPU tensor runs
``bn_relu_gemm_plain``. The wrapper counts its launches in
``bn_relu_gemm.launches``.

The kernel is ``csrc/wgmma_gemm.cuh``'s mainloop in its register-A form
(``AffineReluRows``): x and w arrive by TMA, so x, w and the output must
be 16-byte aligned, and a and b are copied once a block into a table in
shared memory that holds at most ``MAX_C`` channels. The wrapper raises on
anything else before any launch.
"""
from __future__ import annotations

import torch

from vlp_tpu_torch.ops import _build
from vlp_tpu_torch.ops._common import (_acc, _check_cuda, _mm, _route,
                                       _stream)
from vlp_tpu_torch.ops.fused_mlp import check_aligned

# the channels the kernel's a/b table holds (csrc/wgmma_gemm.cuh's
# kMaxAffineChannels: 8 KB of a block's shared memory, two blocks an SM)
MAX_C = 1024


def bn_relu_gemm_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """relu(x * a + b) in fp32 (two roundings: the product, then the sum),
    cast to x's dtype, then the product with w in fp32, cast once."""
    acc = _acc(x.dtype)
    y = torch.relu(x.to(acc) * a.reshape(1, -1).to(acc)
                   + b.reshape(1, -1).to(acc)).to(x.dtype)
    return _mm(y, w).to(x.dtype)


def bn_relu_gemm(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """x [M, C], a and b [C] or [1, C], w [C, K] -> [M, K] in x's dtype.
    Raises on C or K not a multiple of 16, whatever the device; on the card
    also on C above ``MAX_C`` and on x or w off 16-byte alignment."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] \
            or a.numel() != x.shape[1] or b.numel() != x.shape[1]:
        raise ValueError(f"bn_relu_gemm: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, w "
                         f"{tuple(w.shape)} are not [M, C], [C], [C], "
                         "[C, K]")
    m, c = x.shape
    k = w.shape[1]
    if c % 16 or k % 16:
        raise ValueError(f"bn_relu_gemm: C {c} and K {k} must be multiples "
                         "of 16")
    if not _route("bn_relu_gemm", x):
        return bn_relu_gemm_plain(x, a, b, w)
    a, b = a.reshape(-1), b.reshape(-1)
    _check_cuda("bn_relu_gemm", x, a, b, w)
    if w.dtype != torch.bfloat16 or a.dtype != torch.float32 \
            or b.dtype != torch.float32:
        raise TypeError("bn_relu_gemm: the CUDA kernel takes bfloat16 w and "
                        f"fp32 a, b; got {w.dtype}, {a.dtype}, {b.dtype}")
    if c > MAX_C:
        raise ValueError(f"bn_relu_gemm: the CUDA kernel takes C up to "
                         f"{MAX_C} (its a/b table in shared memory), got {c}")
    out = torch.empty((m, k), dtype=x.dtype, device=x.device)
    check_aligned("bn_relu_gemm", x, w, out)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.vlp_bn_relu_gemm(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                                   w.data_ptr(), out.data_ptr(), m, c, k,
                                   _stream())
    _build.check(lib, err, "bn_relu_gemm")
    bn_relu_gemm.launches += 1
    return out


bn_relu_gemm.launches = 0

KERNELS = (bn_relu_gemm,)
