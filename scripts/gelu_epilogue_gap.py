"""How far the dual tile's GELU epilogue lies from the accurate one, on one
CUDA card.

#4/#10's dual tile and the forwards #2/#9 (``csrc/gelu.cuh:gelu_cdf_pdf``)
form cdf = Phi(z) by the Abramowitz & Stegun erf of ``fused_mlp.py:_erf``
and phi = the normal density from one ``__expf`` and one ``__fdividef``.
The accurate form (``csrc/gelu.cuh:erf_as``: ``expf`` and a division, then
a second ``expf`` for phi) is what the wmma epilogue of the same function
computed before it. Both keep the Pallas backward's rounding points: h = bf16(z *
cdf), dh32 = g * (cdf + z * phi), dh = bf16(dh32), with g = dy @ W2^T.

For NesT-Small's three levels at batch 64 (M = 64 * 56^2, 64 * 28^2 and
64 * 14^2 rows; D 96, 192, 384; F = 4D), z = a @ W1 + b1 and g are formed
in fp32 (TF32 off) from bf16 operands drawn as ``scripts/ab_attention.py``
draws them, and a kernel built here from this tree's headers evaluates
both forms on every element of [M, F]; the ``sweep`` does the same on
2^22 points of z evenly over [-12, 12] with g = 1. For each it reports the
largest distance between the two forms in bf16 ulps of h and of dh, the
share of elements where each differs, and the largest gap of dh32 and (at
the levels) of db1, dh32's column sums, each over the largest magnitude of
the accurate form's.

Prints one JSON line with these and the card's name and power limit
(``nvidia-smi``); exits with code 2 without a CUDA device.

Usage:
    python scripts/gelu_epilogue_gap.py [--output gap.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vlp_tpu_torch.ops import _build  # noqa: E402
from vlp_tpu_torch.probes._timing import require_cuda  # noqa: E402

# (rows at batch 64, D) of NesT-Small's three levels; F = 4D
LEVELS = ((64 * 56 * 56, 96), (64 * 28 * 28, 192), (64 * 14 * 14, 384))

SOURCE = r"""
#include <cuda_bf16.h>

#include "gelu.cuh"

// Both GELU forms on every element: [0, n) of h, dh, dh32 the dual tile's,
// [n, 2n) the accurate one's.
__global__ void gelu_forms_kernel(const float* z, const float* g, long n,
                                  __nv_bfloat16* h, __nv_bfloat16* dh,
                                  float* dh32) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    const float zz = z[i], gg = g[i];
    float cdf, phi;
    vlp::gelu_cdf_pdf(zz, cdf, phi);
    float d = gg * (cdf + zz * phi);
    h[i] = __float2bfloat16(zz * cdf);
    dh[i] = __float2bfloat16(d);
    dh32[i] = d;
    cdf = 0.5f * (1.0f + vlp::erf_as(zz * 0.7071067811865476f));
    phi = expf(-0.5f * zz * zz) * 0.3989422804014327f;
    d = gg * (cdf + zz * phi);
    h[n + i] = __float2bfloat16(zz * cdf);
    dh[n + i] = __float2bfloat16(d);
    dh32[n + i] = d;
  }
}

extern "C" int gelu_forms(const void* z, const void* g, long n, void* h,
                          void* dh, void* dh32, void* stream) {
  gelu_forms_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const float*>(g), n,
      static_cast<__nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(dh),
      static_cast<float*>(dh32));
  return (int)cudaGetLastError();
}
"""


def _library():
    """The kernel above, built with the port's nvcc flags against
    ``vlp_tpu_torch/csrc``'s headers into ``build/gelu_epilogue_gap/``."""
    out = _build.BUILD_DIR.parent / "gelu_epilogue_gap"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "gelu_forms.cu", out / "libgelu_forms.so"
    src.write_text(SOURCE)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC), str(src), "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.gelu_forms.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_long] + \
        [ctypes.c_void_p] * 4
    dll.gelu_forms.restype = ctypes.c_int
    return dll


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers whose differences count ulps across 0."""
    bits = x.view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _gap(dll, z: torch.Tensor, g: torch.Tensor, sums: bool = True) -> dict:
    """The two forms on z and g [M, F]; their gaps (with db1's where
    ``sums``)."""
    n = z.numel()
    h = torch.empty(2, *z.shape, dtype=torch.bfloat16, device="cuda")
    dh = torch.empty_like(h)
    dh32 = torch.empty(2, *z.shape, device="cuda")
    err = dll.gelu_forms(z.data_ptr(), g.data_ptr(), n, h.data_ptr(),
                         dh.data_ptr(), dh32.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gelu_forms: CUDA error {err}")
    out = {}
    for name, t in (("h", h), ("dh", dh)):
        ulps = (_ordered(t[0]) - _ordered(t[1])).abs()
        out[f"{name}_max_ulps"] = int(ulps.max())
        out[f"{name}_differ_share"] = float((ulps > 0).double().mean())
    out["dh32_max_gap_rel"] = float((dh32[0] - dh32[1]).abs().max()
                                    / dh32[1].abs().max())
    if not sums:
        return out
    db1 = dh32.double().sum(1)
    out["db1_max_gap_rel"] = float((db1[0] - db1[1]).abs().max()
                                   / db1[1].abs().max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    smi = require_cuda("gelu_epilogue_gap")
    torch.backends.cuda.matmul.allow_tf32 = False
    dll = _library()
    gen = torch.Generator(device="cuda").manual_seed(2)
    result = {"card": smi}
    for i, (m, d) in enumerate(LEVELS):
        f = 4 * d
        a = torch.randn(m, d, generator=gen, device="cuda").bfloat16()
        dy = torch.randn(m, d, generator=gen, device="cuda").bfloat16()
        b1 = 0.02 * torch.randn(f, generator=gen, device="cuda")
        w1 = (torch.randn(d, f, generator=gen, device="cuda")
              * d ** -0.5).bfloat16()
        w2 = (torch.randn(f, d, generator=gen, device="cuda")
              * f ** -0.5).bfloat16()
        z = a.float() @ w1.float() + b1
        g = dy.float() @ w2.float().T
        result[f"nest_l{i}"] = _gap(dll, z, g)
        del z, g
    z = torch.linspace(-12.0, 12.0, 2 ** 22, device="cuda").view(1024, -1)
    result["sweep"] = _gap(dll, z, torch.ones_like(z), sums=False)
    torch.cuda.synchronize()
    print(json.dumps(result), flush=True)
    if args.output:
        with open(args.output, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
