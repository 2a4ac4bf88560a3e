// Tiled bf16 tensor-core GEMM of the probes: #15's LN-qkv and residual
// out-projection (attn_sched.cu), #16's LN-qkv and do prologue
// (attn_sched_bwd.cu) and #14's split-K weight gradients (mlp_tile_bwd.cu).
// No model path launches it: every shipped kernel runs its products on
// wgmma_gemm.cuh. Its bf16 type and warp_sum are what the other headers
// include it for.
//
//   out[M, N] = epilogue(op(A) @ op(W) + bias[N])
//
// op(A) is A [M, K] row-major or, with TA, the transpose of A stored [K, M]
// (the weight gradients X^T dY, which reduce over K = the activation rows);
// op(W) is W [K, N] row-major or, with TB, the transpose of W stored [N, K]
// (the input gradients dY W^T). Without TA, A' may instead be
// bf16(LN(A)*gamma + beta) computed in fp32 per row (two-pass variance, as
// the Pallas kernels in vlp_tpu/ops/fused_block.py do). The epilogues are:
// bias; bias + residual; raw fp32; raw bf16.
// Products accumulate in fp32 and round once, at the same points as the
// Pallas bodies.
//
// Design: one 128-thread block computes a 64x64 output tile; 4 warps in a 2x2
// grid each own a 32x32 sub-tile (2x2 wmma 16x16x16 fragments). The operands
// stream through shared memory in 32-deep K slices; a transposed operand is
// staged as it lies in memory and read by a col_major fragment, so no
// transpose is ever written. With the LayerNorm prologue the block's 64 rows
// of A (K <= 1024 columns) are staged once, normalised in place and stay
// resident for the whole K loop, so LN(x) never goes to device memory. With
// blockIdx.z > 0 the K range is split (split-K): block z sums rows
// [z * k_chunk, (z + 1) * k_chunk) into its own fp32 partial, out + z*M*N,
// and a separate pass reduces the partials in a fixed order, so a weight
// gradient over 200,704 rows is deterministic (no float atomics). The
// accumulators are staged through shared memory so that the epilogue knows
// each element's coordinates.
//
// Requirements checked by launch_gemm_ex: N % 32 == 0; K % 32 == 0 unless
// TA; M % 8 == 0 with TA; 16-byte aligned, contiguous row-major operands.
// Rows beyond M and (with TA) K rows beyond the split's range are masked.
//
// What bounds it on an H100: this simple form loads each slice, waits, then
// multiplies (no cp.async/TMA pipeline, no wgmma), so the tensor cores idle
// while tiles arrive; it is latency-bound well below the bf16 roofline.
// A multi-stage TMA + wgmma pipeline is later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace vlp {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kGemmThreads = 128;
constexpr int kAPad = 8;   // bf16 elements of padding per shared row
constexpr int kBPad = 8;
constexpr int kCPad = 4;   // fp32 elements

// The values appear in the kernels' names, gemm_kernel<LN, TA, TB, EPI>,
// which profiles of several versions are read by (1 is unused).
enum Epilogue {
  kEpiBias = 0,          // bf16(acc + bias)
  kEpiBiasResidual = 2,  // bf16(R + (acc + bias))
  kEpiF32 = 3,           // fp32 acc (split-K partials, dln)
  kEpiBf16 = 4,          // bf16(acc)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared-memory elements of the A and B staging areas.
__host__ __device__ inline size_t gemm_a_elems(bool layer_norm, bool ta,
                                                int K) {
  if (layer_norm) return (size_t)kBM * (K + kAPad);
  return ta ? (size_t)kBK * (kBM + kAPad) : (size_t)kBM * (kBK + kAPad);
}

__host__ __device__ inline size_t gemm_b_elems(bool tb) {
  return tb ? (size_t)kBN * (kBK + kBPad) : (size_t)kBK * (kBN + kBPad);
}

inline size_t gemm_smem_bytes(bool layer_norm, bool ta, bool tb, int K) {
  return (gemm_a_elems(layer_norm, ta, K) + gemm_b_elems(tb)) * sizeof(bf16) +
         (size_t)kBM * (kBN + kCPad) * sizeof(float);
}

template <bool LN, bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const bf16* __restrict__ A, const float* __restrict__ gamma,
                const float* __restrict__ beta, const bf16* __restrict__ W,
                const float* __restrict__ bias, const bf16* __restrict__ R,
                void* __restrict__ out_ptr, int M, int N, int K, int k_chunk,
                float eps) {
  static_assert(!(LN && TA), "the LayerNorm prologue reads A row-major");
  static_assert(!(TA && TB), "TB stages whole K slices: K % 32 == 0");
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = LN ? K + kAPad : (TA ? kBM + kAPad : kBK + kAPad);
  constexpr int ldb = TB ? kBK + kBPad : kBN + kBPad;
  constexpr int ldc = kBN + kCPad;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + gemm_a_elems(LN, TA, K);
  float* Cs = reinterpret_cast<float*>(Bs + gemm_b_elems(TB));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  // N % 32 == 0: a warp's 32 columns are either all inside N or all outside.
  const bool warp_active = n0 + wn < N;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  if (LN) {
    const int vecs = K / 8;
    for (int i = tid; i < kBM * vecs; i += kGemmThreads) {
      const int r = i / vecs;
      const int c = (i % vecs) * 8;
      uint4 v = zero;
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + c);
      *reinterpret_cast<uint4*>(As + r * lda + c) = v;
    }
    __syncthreads();
    const float inv_k = 1.0f / (float)K;
    for (int r = warp; r < kBM; r += kGemmThreads / 32) {
      bf16* row = As + r * lda;
      float s = 0.f;
      for (int c = lane; c < K; c += 32) s += __bfloat162float(row[c]);
      const float mu = warp_sum(s) * inv_k;
      float q = 0.f;
      for (int c = lane; c < K; c += 32) {
        const float d = __bfloat162float(row[c]) - mu;
        q += d * d;
      }
      const float inv = rsqrtf(warp_sum(q) * inv_k + eps);
      for (int c = lane; c < K; c += 32) {
        const float xh = (__bfloat162float(row[c]) - mu) * inv;
        row[c] = __float2bfloat16(xh * gamma[c] + beta[c]);
      }
    }
    // the first __syncthreads of the K loop orders these writes before use
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    if (TB) {
      // Bs[n][k] = W[n0 + n][k0 + k]; W is [N, K]
      for (int i = tid; i < kBN * (kBK / 8); i += kGemmThreads) {
        const int r = i / (kBK / 8);
        const int c = (i % (kBK / 8)) * 8;
        uint4 v = zero;
        if (n0 + r < N)
          v = *reinterpret_cast<const uint4*>(W + (size_t)(n0 + r) * K + k0 +
                                              c);
        *reinterpret_cast<uint4*>(Bs + r * ldb + c) = v;
      }
    } else {
      for (int i = tid; i < kBK * (kBN / 8); i += kGemmThreads) {
        const int r = i / (kBN / 8);
        const int c = (i % (kBN / 8)) * 8;
        uint4 v = zero;
        if (n0 + c < N && k0 + r < k_end)
          v = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + n0 +
                                              c);
        *reinterpret_cast<uint4*>(Bs + r * ldb + c) = v;
      }
    }
    if (TA) {
      // As[k][m] = A[k0 + k][m0 + m]; A is [K, M]
      for (int i = tid; i < kBK * (kBM / 8); i += kGemmThreads) {
        const int r = i / (kBM / 8);
        const int c = (i % (kBM / 8)) * 8;
        uint4 v = zero;
        if (k0 + r < k_end && m0 + c < M)
          v = *reinterpret_cast<const uint4*>(A + (size_t)(k0 + r) * M + m0 +
                                              c);
        *reinterpret_cast<uint4*>(As + r * lda + c) = v;
      }
    } else if (!LN) {
      for (int i = tid; i < kBM * (kBK / 8); i += kGemmThreads) {
        const int r = i / (kBK / 8);
        const int c = (i % (kBK / 8)) * 8;
        uint4 v = zero;
        if (m0 + r < M)
          v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 +
                                              c);
        *reinterpret_cast<uint4*>(As + r * lda + c) = v;
      }
    }
    __syncthreads();
    if (warp_active) {
      const bf16* a_tile = LN ? As + k0 : As;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        using ALayout =
            typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
        using BLayout =
            typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // col_major A: element (m, k) at As[k * lda + m]
          const bf16* pa = TA ? a_tile + kk * lda + wm + 16 * i
                              : a_tile + (wm + 16 * i) * lda + kk;
          wmma::load_matrix_sync(fa[i], pa, lda);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // col_major B: element (k, n) at Bs[n * ldb + k]
          const bf16* pb = TB ? Bs + (wn + 16 * j) * ldb + kk
                              : Bs + kk * ldb + wn + 16 * j;
          wmma::load_matrix_sync(fb[j], pb, ldb);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if (warp_active) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm + 16 * i) * ldc + wn + 16 * j,
                                acc[i][j], ldc, wmma::mem_row_major);
  }
  __syncthreads();
  bf16* out = static_cast<bf16*>(out_ptr);
  for (int i = tid; i < kBM * kBN; i += kGemmThreads) {
    const int r = i / kBN;
    const int c = i % kBN;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const size_t o = (size_t)gm * N + gn;
    float v = Cs[r * ldc + c];
    if (EPI == kEpiF32) {
      static_cast<float*>(out_ptr)[(size_t)blockIdx.z * M * N + o] = v;
    } else if (EPI == kEpiBf16) {
      out[o] = __float2bfloat16(v);
    } else {
      v += bias[gn];
      if (EPI == kEpiBiasResidual) v = __bfloat162float(R[o]) + v;
      out[o] = __float2bfloat16(v);
    }
  }
}

// Launches one GEMM on `stream` with the K range split into `splits`
// partials (1 = no split); returns the launch's cudaError_t.
template <bool LN, bool TA, bool TB, int EPI>
cudaError_t launch_gemm_ex(const bf16* A, const float* gamma,
                           const float* beta, const bf16* W, const float* bias,
                           const bf16* R, void* out, int M, int N, int K,
                           int splits, float eps, cudaStream_t stream) {
  const int m_tiles = (M + kBM - 1) / kBM;
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || N % 32 ||
      (!TA && K % 32) || (TA && M % 8) || m_tiles > 65535 || splits > 65535 ||
      (splits > 1 && EPI != kEpiF32))
    return cudaErrorInvalidValue;
  const int k_chunk = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  const size_t smem = gemm_smem_bytes(LN, TA, TB, K);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<LN, TA, TB, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, m_tiles, splits);
  gemm_kernel<LN, TA, TB, EPI><<<grid, kGemmThreads, smem, stream>>>(
      A, gamma, beta, W, bias, R, out, M, N, K, k_chunk, eps);
  return cudaGetLastError();
}

// The forward kernels' form: op(A) = A or LN(A), W [K, N], one K range.
template <bool LN, int EPI>
cudaError_t launch_gemm(const bf16* A, const float* gamma, const float* beta,
                        const bf16* W, const float* bias, const bf16* R,
                        bf16* out, int M, int N, int K, float eps,
                        cudaStream_t stream) {
  return launch_gemm_ex<LN, false, false, EPI>(A, gamma, beta, W, bias, R,
                                               out, M, N, K, 1, eps, stream);
}

}  // namespace vlp
