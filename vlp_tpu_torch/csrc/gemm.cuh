// Tiled bf16 tensor-core GEMM shared by the two half-block kernels
// (ln_attention.cu, ln_mlp.cu):
//
//   out[M, N] = epilogue(A'[M, K] @ W[K, N] + bias[N])
//
// A' is either A itself or, with the LayerNorm prologue, bf16(LN(A)*gamma +
// beta) computed in fp32 per row (two-pass variance, as the Pallas kernels in
// vlp_tpu/ops/fused_block.py do). The epilogues are: bias; bias + exact-erf
// GELU; bias + residual. Products accumulate in fp32 and round to bf16 once,
// at the same points as the Pallas bodies.
//
// Design: one 128-thread block computes a 64x64 output tile; 4 warps in a 2x2
// grid each own a 32x32 sub-tile (2x2 wmma 16x16x16 fragments). W streams
// through shared memory in 32-deep slices. With the LayerNorm prologue the
// block's 64 rows of A (K <= 1024 columns) are staged once, normalised in
// place and stay resident for the whole K loop, so LN(x) never goes to device
// memory. The accumulators are staged through shared memory so that the
// epilogue knows each element's coordinates.
//
// Requirements checked by the Python wrappers: N % 32 == 0, K % 32 == 0,
// 16-byte aligned, contiguous row-major operands. Rows beyond M are masked.
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

enum Epilogue { kEpiBias = 0, kEpiBiasGelu = 1, kEpiBiasResidual = 2 };

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

// erf by Abramowitz & Stegun 7.1.26, the form vlp_tpu/ops/fused_mlp.py:_erf
// uses inside the Pallas kernels (|error| <= 1.5e-7).
__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return s * (1.0f - poly * expf(-a * a));
}

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.0f + erf_as(z * 0.7071067811865476f));
}

inline size_t gemm_smem_bytes(bool layer_norm, int K) {
  const size_t a_elems =
      layer_norm ? (size_t)kBM * (K + kAPad) : (size_t)kBM * (kBK + kAPad);
  return a_elems * sizeof(bf16) + (size_t)kBK * (kBN + kBPad) * sizeof(bf16) +
         (size_t)kBM * (kBN + kCPad) * sizeof(float);
}

template <bool LN, int EPI>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const bf16* __restrict__ A, const float* __restrict__ gamma,
                const float* __restrict__ beta, const bf16* __restrict__ W,
                const float* __restrict__ bias, const bf16* __restrict__ R,
                bf16* __restrict__ out, int M, int N, int K, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = LN ? K + kAPad : kBK + kAPad;
  constexpr int ldb = kBN + kBPad;
  constexpr int ldc = kBN + kCPad;
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kBM * lda;
  float* Cs = reinterpret_cast<float*>(Bs + kBK * ldb);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
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

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBK * (kBN / 8); i += kGemmThreads) {
      const int r = i / (kBN / 8);
      const int c = (i % (kBN / 8)) * 8;
      uint4 v = zero;
      if (n0 + c < N)
        v = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * N + n0 + c);
      *reinterpret_cast<uint4*>(Bs + r * ldb + c) = v;
    }
    if (!LN) {
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
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a_tile + (wm + 16 * i) * lda + kk, lda);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * ldb + wn + 16 * j, ldb);
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
  for (int i = tid; i < kBM * kBN; i += kGemmThreads) {
    const int r = i / kBN;
    const int c = i % kBN;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm < M && gn < N) {
      float v = Cs[r * ldc + c] + bias[gn];
      if (EPI == kEpiBiasGelu) v = gelu_erf(v);
      if (EPI == kEpiBiasResidual)
        v = __bfloat162float(R[(size_t)gm * N + gn]) + v;
      out[(size_t)gm * N + gn] = __float2bfloat16(v);
    }
  }
}

// Launches one GEMM on `stream`; returns the launch's cudaError_t.
template <bool LN, int EPI>
cudaError_t launch_gemm(const bf16* A, const float* gamma, const float* beta,
                        const bf16* W, const float* bias, const bf16* R,
                        bf16* out, int M, int N, int K, float eps,
                        cudaStream_t stream) {
  const int m_tiles = (M + kBM - 1) / kBM;
  if (M <= 0 || N <= 0 || K <= 0 || N % 32 || K % 32 || m_tiles > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = gemm_smem_bytes(LN, K);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<LN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, m_tiles);
  gemm_kernel<LN, EPI><<<grid, kGemmThreads, smem, stream>>>(
      A, gamma, beta, W, bias, R, out, M, N, K, eps);
  return cudaGetLastError();
}

}  // namespace vlp
