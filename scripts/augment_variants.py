"""Design variants of the augmentation kernels #11 ``shear_rows`` and #12
``add_gaussian_noise`` on one CUDA card, beside the shipped kernels and a
plain copy of the same bytes.

Builds a small library of its own (``build/augment_variants/``) from
``csrc/shear.cu`` and ``csrc/noise.cu`` and the variants below, checks each
variant bit-equal to the shipped kernel on the same inputs (the cases of
``probes/augment_probe.py``: the warp's ramps, the step's sigmas), and
times them in turns at batch 64 and 128 of [B, 224, 224] fp32:

  rows   axis 1: r1w8 (shipped: a warp owns a row, 8 warps a block), r2w8
         (a warp takes two rows, both rows' loads issued first), r1w4 (4
         warps a block), r2w4
  cols   axis 0: w8u4 (shipped: a 32-column strip, 8 warps, four loads in
         flight a thread), w16u4 (16 warps), w8u8 (eight loads in flight),
         w8async (the strip staged by 4-byte cp.async, all of a thread's
         loads in flight)
  noise  p1 (shipped: one Philox call, eight pixels a thread), p2 (two
         calls, sixteen pixels)
  copy   ``torch.clone`` of the same image: the same bytes read and
         written, the rate a plain copy reaches

each as device time alone per call: warm (``_timing.device_in_turns``),
cold (``_timing.cold_in_turns``: a 96 MB buffer written before each call,
so the L2 also holds its dirty lines), and clean (that buffer written, then
a second 96 MB buffer read, so the L2 holds none of the call's data and
nothing dirty). Prints one JSON line per batch with the times and the card's
name and power limit (``nvidia-smi``). Exits with code 2 without a CUDA
device.

Usage:
    python scripts/augment_variants.py [--output variants.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from vlp_tpu_torch.ops import _build  # noqa: E402
from vlp_tpu_torch.ops._common import _stream  # noqa: E402
from vlp_tpu_torch.probes import augment_probe  # noqa: E402
from vlp_tpu_torch.probes._timing import (FLUSH_BYTES,  # noqa: E402
                                          cold_in_turns, device_in_turns,
                                          require_cuda)

ROWS = ("r1w8", "r2w8", "r1w4", "r2w4")
COLS = ("w8u4", "w16u4", "w8u8", "w8async")
NOISE = ("p1", "p2")

SOURCE = r"""
#include "shear.cu"
#include "noise.cu"

namespace {

// axis 1: a warp takes R rows, the R rows' loads issued before any is
// staged (W % 4 == 0 only)
template <int R, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    rows_var(const float* __restrict__ img, const float* __restrict__ shift,
             float* __restrict__ out, int H, int W, int max_shift) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y0 = (blockIdx.x * kWarps + warp) * R;
  if (y0 >= H) return;
  const int words = row_words(W), q4 = W / 4;
  const int nr = min(R, H - y0);
  float* rows = smem + warp * R * words;
  const int line0 = blockIdx.y * H + y0;
  const float4* src4 = reinterpret_cast<const float4*>(img + line0 * W);
  for (int j = lane; j < q4; j += 32) {
    float4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr) v[r] = src4[r * q4 + j];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr) {
        float* row = rows + r * words;
        const int e = 4 * j;
        row[swz(e)] = v[r].x;
        row[swz(e + 1)] = v[r].y;
        row[swz(e + 2)] = v[r].z;
        row[swz(e + 3)] = v[r].w;
      }
  }
  __syncwarp();
  for (int r = 0; r < nr; ++r) {
    int d;
    float f;
    line_shift(shift[line0 + r], max_shift, d, f);
    const float* row = rows + r * words;
    float4* dst4 = reinterpret_cast<float4*>(out + (line0 + r) * W);
    for (int j = lane; j < q4; j += 32) {
      const int i0 = 4 * j + d;
      float t[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) t[q] = row[swz(clampi(i0 + q, W))];
      dst4[j] = make_float4(lerp(t[0], t[1], f), lerp(t[1], t[2], f),
                            lerp(t[2], t[3], f), lerp(t[3], t[4], f));
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// axis 0: kWarps warps a strip, kUnroll loads in flight a thread, or every
// load by cp.async (kUnroll 0)
template <int kWarps, int kUnroll>
__global__ void __launch_bounds__(kWarps * 32)
    cols_var(const float* __restrict__ img, const float* __restrict__ shift,
             float* __restrict__ out, int H, int W, int max_shift) {
  extern __shared__ float strip[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int x = blockIdx.x * kStrip + lane;
  const bool inside = x < W;
  const int base = b * H * W + x;
  constexpr int ld = kStrip + 1;
  if (inside) {
    if constexpr (kUnroll == 0) {
      for (int y = warp; y < H; y += kWarps)
        cp_async4(strip + y * ld + lane, img + base + y * W);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
      int y = warp;
      for (; y + (kUnroll - 1) * kWarps < H; y += kUnroll * kWarps) {
        float v[kUnroll > 0 ? kUnroll : 1];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = img[base + (y + u * kWarps) * W];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          strip[(y + u * kWarps) * ld + lane] = v[u];
      }
      for (; y < H; y += kWarps) strip[y * ld + lane] = img[base + y * W];
    }
  }
  int d = 0;
  float f = 0.0f;
  if (inside) line_shift(shift[b * W + x], max_shift, d, f);
  __syncthreads();
  if (!inside) return;
  for (int y = warp; y < H; y += kWarps) {
    const int i0 = y + d;
    out[base + y * W] = lerp(strip[clampi(i0, H) * ld + lane],
                             strip[clampi(i0 + 1, H) * ld + lane], f);
  }
}

// the noise with two Philox calls a thread (W/2 % 8 == 0 only)
__global__ void __launch_bounds__(256)
    noise_p2(const float* __restrict__ x, const int32_t* __restrict__ seeds,
             const float* __restrict__ sigma, float* __restrict__ out, int H,
             int W) {
  const int b = blockIdx.y;
  const int half = W / 2;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (8 * g >= H * half) return;
  const uint2 key =
      make_uint2((uint32_t)seeds[2 * b], (uint32_t)seeds[2 * b + 1]);
  const float s = sigma[b];
  const int y = 8 * g / half;
  const int lo = b * H * W + y * W + (8 * g - y * half);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint4 w4 =
        philox4x32_10(make_uint4((uint32_t)(2 * g + c), 0u, 0u, 0u), key);
    const int at = lo + 4 * c;
    const float4 xc = *reinterpret_cast<const float4*>(x + at);
    const float4 xs = *reinterpret_cast<const float4*>(x + at + half);
    float zc[4], zs[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) box_muller(word(w4, q), zc[q], zs[q]);
    *reinterpret_cast<float4*>(out + at) =
        make_float4(add_noise(xc.x, s, zc[0]), add_noise(xc.y, s, zc[1]),
                    add_noise(xc.z, s, zc[2]), add_noise(xc.w, s, zc[3]));
    *reinterpret_cast<float4*>(out + at + half) =
        make_float4(add_noise(xs.x, s, zs[0]), add_noise(xs.y, s, zs[1]),
                    add_noise(xs.z, s, zs[2]), add_noise(xs.w, s, zs[3]));
  }
}

}  // namespace

// variant: axis 1 rows 0-3 (r1w8 shipped, r2w8, r1w4, r2w4); axis 0 cols
// 0-3 (w8u4 shipped, w16u4, w8u8, w8async)
extern "C" int var_shear(int variant, const void* img, const void* shift,
                         void* out, int B, int H, int W, int ms, int axis,
                         void* stream) {
  if (variant == 0)
    return vlp_shear_rows(img, shift, out, B, H, W, ms, axis, stream);
  const float* src = static_cast<const float*>(img);
  const float* sh = static_cast<const float*>(shift);
  float* dst = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (axis == 0) {
    const size_t smem = (size_t)H * (kStrip + 1) * sizeof(float);
    const dim3 grid((W + kStrip - 1) / kStrip, B);
    if (variant == 1)
      return launch(cols_var<16, 4>, grid, 512, smem, st, src, sh, dst, H, W,
                    ms);
    if (variant == 2)
      return launch(cols_var<8, 8>, grid, 256, smem, st, src, sh, dst, H, W,
                    ms);
    return launch(cols_var<8, 0>, grid, 256, smem, st, src, sh, dst, H, W,
                  ms);
  }
  if (W % 4) return (int)cudaErrorInvalidValue;
  const int r = variant == 2 ? 1 : 2, warps = variant == 1 ? 8 : 4;
  const dim3 grid((H + warps * r - 1) / (warps * r), B);
  const size_t smem = (size_t)warps * r * row_words(W) * sizeof(float);
  if (variant == 1)
    return launch(rows_var<2, 8>, grid, 256, smem, st, src, sh, dst, H, W, ms);
  if (variant == 2)
    return launch(rows_var<1, 4>, grid, 128, smem, st, src, sh, dst, H, W, ms);
  return launch(rows_var<2, 4>, grid, 128, smem, st, src, sh, dst, H, W, ms);
}

// variant 0 shipped, 1 two Philox calls a thread
extern "C" int var_noise(int variant, const void* x, const void* seeds,
                         const void* sigma, void* out, int B, int H, int W,
                         void* stream) {
  if (variant == 0)
    return vlp_add_gaussian_noise(x, seeds, sigma, out, B, H, W, stream);
  if ((W / 2) % 8) return (int)cudaErrorInvalidValue;
  const int groups = H * (W / 2) / 8;
  noise_p2<<<dim3((groups + 255) / 256, B), 256, 0,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(seeds),
      static_cast<const float*>(sigma), static_cast<float*>(out), H, W);
  return (int)cudaGetLastError();
}
"""


def _library():
    """The entry points above, built with the port's nvcc flags against
    ``vlp_tpu_torch/csrc`` into ``build/augment_variants/``; ptxas's report
    beside it."""
    out = _build.BUILD_DIR.parent / "augment_variants"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "augment_variants.cu", out / "libaugment_variants.so"
    src.write_text(SOURCE)
    proc = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC), str(src), "-o", str(lib)],
        capture_output=True, text=True, timeout=600)
    (out / "ptxas.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.var_shear.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p]
    dll.var_noise.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    dll.var_shear.restype = dll.var_noise.restype = ctypes.c_int
    return dll


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def _clean_cold_ms(fn, calls=20):
    """Median device ms of ``fn`` after a 96 MB write and then a 96 MB read
    of a second buffer: the L2 holds none of the call's data and no dirty
    line; events around the call alone, behind a spin kernel."""
    dirty = torch.empty(FLUSH_BYTES // 4, device="cuda")
    clean = torch.ones(FLUSH_BYTES // 4, device="cuda")
    sink = torch.empty((), device="cuda")
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    events = []
    for i in range(calls):
        dirty.fill_(float(i))
        torch.sum(clean, dim=0, out=sink)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _clean_in_turns(**fns):
    names = list(fns)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(_clean_cold_ms(fns[n]))
    return {n: statistics.mean(t) for n, t in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    smi = require_cuda("augment_variants")
    lib = _library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for batch in augment_probe.BATCHES:
        cases = augment_probe.cases(batch, gen)
        ms = augment_probe.default_max_shift(224, 224)
        fns = {}
        for prefix, case_name, axis, names in (
                ("rows", "shear_ax1_ramp", 1, ROWS),
                ("cols", "shear_ax0_ramp", 0, COLS)):
            img, shift = cases[case_name].args[:2]
            want = cases[case_name].kernel()
            for v, name in enumerate(names):
                def call(v=v, img=img, shift=shift, axis=axis):
                    out = torch.empty_like(img)
                    _check(lib.var_shear(
                        v, img.data_ptr(), shift.data_ptr(), out.data_ptr(),
                        *img.shape, ms, axis, _stream()), "var_shear")
                    return out
                if not torch.equal(call(), want):
                    raise RuntimeError(f"{prefix} {name} differs from the "
                                       "shipped kernel")
                fns[f"{prefix}_{name}"] = call
        x, seeds, sigma = cases["noise"].args
        want = cases["noise"].kernel()
        for v, name in enumerate(NOISE):
            def call(v=v):
                out = torch.empty_like(x)
                _check(lib.var_noise(
                    v, x.data_ptr(), seeds.data_ptr(), sigma.data_ptr(),
                    out.data_ptr(), *x.shape, _stream()), "var_noise")
                return out
            if not torch.equal(call(), want):
                raise RuntimeError(f"noise {name} differs from the shipped "
                                   "kernel")
            fns[f"noise_{name}"] = call
        fns["copy"] = lambda: x.clone()
        rec = {"batch": batch, "card": smi,
               "device": torch.cuda.get_device_name(0),
               "bytes": cases["noise"].bytes,
               "warm_ms": device_in_turns(**fns),
               "cold_ms": cold_in_turns(**fns),
               "clean_ms": _clean_in_turns(**fns)}
        print(json.dumps(rec), flush=True)
        results.append(rec)
        del cases, fns
        torch.cuda.empty_cache()
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
