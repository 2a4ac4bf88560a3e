// The MLP tile engine: one launch computes the whole MLP of a block's row
// tile, with the hidden activation kept on chip. Shared by mlp_tile.cu (the
// probe kernels #13, benchmarks/mega_variants.py:make_mlp, and #19a,
// benchmarks/mlp_probe.py:make_chain). The single product #19b and the
// backward #14 run on wgmma_gemm.cuh (gemm_single.cu, mlp_tile_bwd.cu).
//
//   ln  = LN ? bf16(LN(x) * gamma + beta) : x                 [TM, D]
//   for each F slice s of FS columns:
//     z_s = ln @ W1[:, s] (+ b1[s] with BIAS)                  fp32 [TM, FS]
//     h_s = bf16(GELU ? gelu(z_s) : z_s)
//     acc += h_s @ W2[s, :]                                     fp32 [TM, D]
//   out = BIAS ? bf16(x + (acc + b2)) : bf16(acc)               [M, D]
//
// LN is the Pallas bodies' (fp32, two-pass variance); GELU the exact-erf form
// with the A&S erf (gelu.cuh: gelu_erf). #13 runs with BIAS (its ablations
// turn LN or GELU off); #19a's chain with neither bias nor residual (its "ln" stage is
// LN without affine: null gamma and beta). The rounding points are those of
// the Pallas bodies: ln, h and the output are rounded to bf16 once each,
// every product accumulates in fp32.
//
// Design: a block of 256 threads (8 warps: 2 row groups x 4 column groups)
// owns TM rows. It stages x (cp.async, rows past M zero-filled), normalises
// it in place in shared memory, and walks F in slices of FS columns. W1 and
// W2 stream through one ring of kStages shared-memory stages by cp.async,
// kStages - 1 steps ahead: a step is a [64, FS] chunk of W1 (first product)
// or a [32, D] chunk of W2 (second product). The first product's fp32 tile
// goes through shared memory (zS) so that bias and GELU know each element's
// column; h_s stays in shared memory (hS) as the second product's A operand.
// The [TM, D] accumulator lives in registers (wmma fragments) for the whole
// walk, so h never reaches device memory. The TPU kernel keeps all of
// h [tm, F] in VMEM; at TM = 64 and F = 1536 that is 192 KB of the 227 KB a
// block may have here, so the F-slice walk is the design on this card.
//
// Budget at TM = 64, D = 384 (the probe's NesT-Small level 3): the
// accumulator is 64 x 384 fp32 = 96 KB, 96 registers a thread over 256
// threads, plus 8 (FS = 64) or 16 (FS = 128) for the slice's z fragments;
// TM = 128 would need 192 a thread for the accumulator alone, so TM is 32 or
// 64. Shared memory: ln 64 x 392 bf16 (50 KB), the ring 3 x 32 x 392 bf16
// (75 KB), zS 64 x (FS + 4) fp32 (17 / 33 KB), hS 64 x (FS + 8) bf16 (9 /
// 17 KB): 151-176 KB, one block per SM.
//
// What bounds it on this card: 4 * M * D * F operations (59.2 GFLOP at the
// probe's M = 25088, D = 384, F = 1536: 0.060 ms at 989 TFLOP/s) against
// 4 * M * D bytes of x and y: the tensor cores. But every block reads all of
// W1 and W2 (4 * D * F bytes, 2.36 MB) for its TM rows, so the weights cross
// L2 M / TM times (925 MB at TM = 64): TM FLOP per byte of L2 traffic, half
// as much at TM = 32. wmma (mma.sync) reaches a fraction of the rate of
// wgmma, and one block of 8 warps per SM waits at a barrier per step.
// The mainloop of wgmma_gemm.cuh (wgmma with TMA), and weight chunks
// multicast to the blocks of a cluster, are the later steps.
//
// Requirements (checked by the launchers): D % 64 == 0, D <= 384,
// F % FS == 0, 16-byte aligned contiguous row-major operands.
#pragma once

#include <mma.h>

#include "common.cuh"         // bf16, warp_sum
#include "gelu.cuh"           // erf_as, gelu_erf
#include "implicit_gemm.cuh"  // cp_async16, cp_async_commit, cp_async_wait

namespace vlp {
namespace mlpt {

namespace wmma = nvcuda::wmma;

using igemm::cp_async16;
using igemm::cp_async_commit;
using igemm::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK1 = 64;   // W1 rows per forward step
constexpr int kBK2 = 32;   // W2 rows per forward step
constexpr int kStages = 3;
constexpr int kMaxD = 384;
constexpr int kMaxNF = kMaxD / 64;  // 16-column fragments of a warp across D
constexpr int kLdScratch = 20;      // fp32 per-warp 16 x 16 epilogue staging

__device__ __forceinline__ uint4 pack8(const float* v) {
  __align__(16) bf16 b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = __float2bfloat16(v[e]);
  return *reinterpret_cast<const uint4*>(b);
}

__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const bf16* b = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(b[e]);
}

// rows [m0, m0 + rows) of src [M, D] into dst (row stride ld) by cp.async,
// rows past M zero-filled; the caller commits
__device__ __forceinline__ void load_tile_rows(bf16* dst, int ld,
                                               const bf16* src, int m0, int M,
                                               int D, int rows) {
  const int vecs = D / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i % vecs) * 8;
    const bool ok = m0 + r < M;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)(m0 + r) * D + c : src,
               ok);
  }
}

// In place: each row of t -> bf16(x_hat * gamma + beta) (bf16(x_hat) when
// gamma is null), x_hat in fp32 with the two-pass variance, one warp per
// row; with stats, each row's mean and 1/sigma at stats[2r], stats[2r + 1].
__device__ __forceinline__ void ln_tile(bf16* t, int ld,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        int rows, int D, float eps,
                                        float* stats) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    bf16* row = t + r * ld;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += __bfloat162float(row[c]);
    const float mu = warp_sum(s) / (float)D;
    float q = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = __bfloat162float(row[c]) - mu;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / (float)D + eps);
    for (int c = lane; c < D; c += 32) {
      const float xh = (__bfloat162float(row[c]) - mu) * inv;
      row[c] = __float2bfloat16(gamma != nullptr ? xh * gamma[c] + beta[c]
                                                 : xh);
    }
    if (stats != nullptr && lane == 0) {
      stats[2 * r] = mu;
      stats[2 * r + 1] = inv;
    }
  }
}

// bf16 elements of one ring stage of the forward
__host__ __device__ inline int fwd_stage_elems(int FS, int D) {
  const int a = kBK1 * (FS + 8);
  const int b = kBK2 * (D + 8);
  return a > b ? a : b;
}

inline size_t fwd_smem_bytes(int TM, int FS, int D) {
  return (size_t)TM * (D + 8) * sizeof(bf16) +
         (size_t)kStages * fwd_stage_elems(FS, D) * sizeof(bf16) +
         (size_t)TM * (FS + 4) * sizeof(float) +
         (size_t)TM * (FS + 8) * sizeof(bf16);
}

template <int TM, int FS, bool LN, bool GELU, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_tile_kernel(const bf16* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, const float* __restrict__ b2,
                    bf16* __restrict__ out, int M, int D, int F, float eps) {
  static_assert(TM == 32 || TM == 64, "two row groups of 1 or 2 fragments");
  static_assert(FS == 64 || FS == 128, "four column groups of 16 or 32");
  constexpr int MF = TM / 32;   // 16-row fragments of a warp
  constexpr int NF1 = FS / 64;  // 16-column fragments of a warp in a slice
  constexpr int LDW1 = FS + 8;  // W1 chunk [kBK1][FS]
  constexpr int LDZ = FS + 4;   // zS [TM][FS] fp32
  constexpr int LDH = FS + 8;   // hS [TM][FS] bf16
  const int ldx = D + 8;        // ln tile [TM][D], W2 chunk [kBK2][D]
  const int nf2 = D / 64;
  const int stage = fwd_stage_elems(FS, D);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* lnS = reinterpret_cast<bf16*>(smem);
  bf16* ring = lnS + TM * ldx;
  float* zS = reinterpret_cast<float*>(ring + kStages * stage);
  bf16* hS = reinterpret_cast<bf16*>(zS + TM * LDZ);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = (warp >> 2) * (TM / 2);
  const int wc = warp & 3;
  const int m0 = blockIdx.x * TM;

  load_tile_rows(lnS, ldx, x, m0, M, D, TM);
  cp_async_commit();
  const int k1 = D / kBK1;
  const int per = k1 + FS / kBK2;  // steps per slice
  const int steps = F / FS * per;
  auto load = [&](int t) {
    bf16* st = ring + (t % kStages) * stage;
    const int u = t % per;
    const int f0 = t / per * FS;
    if (u < k1) {
      const bf16* src = w1 + (size_t)u * kBK1 * F + f0;
      for (int i = tid; i < kBK1 * (FS / 8); i += kThreads) {
        const int r = i / (FS / 8);
        const int c = (i % (FS / 8)) * 8;
        cp_async16(st + r * LDW1 + c, src + (size_t)r * F + c, true);
      }
    } else {
      const bf16* src = w2 + (size_t)(f0 + (u - k1) * kBK2) * D;
      const int vecs = D / 8;
      for (int i = tid; i < kBK2 * vecs; i += kThreads) {
        const int r = i / vecs;
        const int c = (i % vecs) * 8;
        cp_async16(st + r * ldx + c, src + (size_t)r * D + c, true);
      }
    }
  };
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps) load(i);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // the x tile has arrived
  __syncthreads();
  if (LN) ln_tile(lnS, ldx, gamma, beta, TM, D, eps, nullptr);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> zf[MF][NF1];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][kMaxNF];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // step t has arrived
    __syncthreads();  // ... for every thread; step t - 1's stage is free
    if (t + kStages - 1 < steps) load(t + kStages - 1);
    cp_async_commit();
    const bf16* st = ring + (t % kStages) * stage;
    const int u = t % per;
    const int f0 = t / per * FS;
    if (u < k1) {
      if (u == 0) {
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF1; ++j) wmma::fill_fragment(zf[i][j], 0.f);
      }
#pragma unroll
      for (int kk = 0; kk < kBK1; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fa[MF];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            fb[NF1];
#pragma unroll
        for (int i = 0; i < MF; ++i)
          wmma::load_matrix_sync(
              fa[i], lnS + (row0 + 16 * i) * ldx + u * kBK1 + kk, ldx);
#pragma unroll
        for (int j = 0; j < NF1; ++j)
          wmma::load_matrix_sync(fb[j], st + kk * LDW1 + wc * (FS / 4) + 16 * j,
                                 LDW1);
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF1; ++j)
            wmma::mma_sync(zf[i][j], fa[i], fb[j], zf[i][j]);
      }
      if (u == k1 - 1) {  // the slice's z is complete: bias, GELU, bf16
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF1; ++j)
            wmma::store_matrix_sync(
                zS + (row0 + 16 * i) * LDZ + wc * (FS / 4) + 16 * j, zf[i][j],
                LDZ, wmma::mem_row_major);
        __syncthreads();
        for (int i = tid; i < TM * (FS / 8); i += kThreads) {
          const int r = i / (FS / 8);
          const int c = (i % (FS / 8)) * 8;
          float v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float z = zS[r * LDZ + c + e];
            if (BIAS) z += b1[f0 + c + e];
            v[e] = GELU ? gelu_erf(z) : z;
          }
          *reinterpret_cast<uint4*>(hS + r * LDH + c) = pack8(v);
        }
        // the next step's barrier makes hS visible to the second product
      }
    } else {
      const int kc = (u - k1) * kBK2;
#pragma unroll
      for (int kk = 0; kk < kBK2; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fa[MF];
#pragma unroll
        for (int i = 0; i < MF; ++i)
          wmma::load_matrix_sync(fa[i], hS + (row0 + 16 * i) * LDH + kc + kk,
                                 LDH);
#pragma unroll
        for (int j = 0; j < kMaxNF; ++j) {
          if (j < nf2) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
                fb;
            wmma::load_matrix_sync(fb, st + kk * ldx + wc * (D / 4) + 16 * j,
                                   ldx);
#pragma unroll
            for (int i = 0; i < MF; ++i)
              wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
          }
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: each warp stages its fragments
  float* scr = reinterpret_cast<float*>(ring) + warp * 16 * kLdScratch;
  const int rr = lane >> 1;
  const int cc = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNF; ++j) {
      if (j >= nf2) continue;
      wmma::store_matrix_sync(scr, acc[i][j], kLdScratch,
                              wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + row0 + 16 * i + rr;
      const int gc = wc * (D / 4) + 16 * j + cc;
      if (gr < M) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = scr[rr * kLdScratch + cc + e];
        if (BIAS) {
          float xv[8];
          unpack8(*reinterpret_cast<const uint4*>(x + (size_t)gr * D + gc),
                  xv);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = xv[e] + (v[e] + b2[gc + e]);
        }
        *reinterpret_cast<uint4*>(out + (size_t)gr * D + gc) = pack8(v);
      }
      __syncwarp();
    }
}

struct TileArgs {
  const bf16* x;
  const float* gamma;
  const float* beta;
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  bf16* out;
  int M, D, F;
  float eps;
  cudaStream_t stream;
};

template <int TM, int FS, bool LN, bool GELU, bool BIAS>
cudaError_t launch_mlp_tile(const TileArgs& a) {
  if (a.M <= 0 || a.D <= 0 || a.D % 64 || a.D > kMaxD || a.F <= 0 ||
      a.F % FS)
    return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(TM, FS, a.D);
  auto kernel = mlp_tile_kernel<TM, FS, LN, GELU, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.M + TM - 1) / TM, kThreads, smem, a.stream>>>(
      a.x, a.gamma, a.beta, a.w1, a.b1, a.w2, a.b2, a.out, a.M, a.D, a.F,
      a.eps);
  return cudaGetLastError();
}

// The forward instances, (TM, FS): (64, 64), (64, 128), (32, 64), (32, 128)
template <bool LN, bool GELU, bool BIAS>
cudaError_t launch_mlp_tile_at(const TileArgs& a, int tm, int fs) {
  if (tm == 64 && fs == 64)
    return launch_mlp_tile<64, 64, LN, GELU, BIAS>(a);
  if (tm == 64 && fs == 128)
    return launch_mlp_tile<64, 128, LN, GELU, BIAS>(a);
  if (tm == 32 && fs == 64)
    return launch_mlp_tile<32, 64, LN, GELU, BIAS>(a);
  if (tm == 32 && fs == 128)
    return launch_mlp_tile<32, 128, LN, GELU, BIAS>(a);
  return cudaErrorInvalidValue;
}

}  // namespace mlpt
}  // namespace vlp
