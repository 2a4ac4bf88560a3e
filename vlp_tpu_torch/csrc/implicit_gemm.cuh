// A bf16 tensor-core GEMM whose A tile is gathered by a source policy, the
// engine of the ResNet probe kernel bn_relu_gemm.cu (#18: rows with a
// BatchNorm affine and ReLU applied as they arrive); its cp.async helpers
// also serve mhsa_reg.cuh. The 3x3 convolution #17
// (conv3x3.cu) runs on the wgmma mainloop of wgmma_gemm.cuh. This one
// computes
//
//   out[M, N] = bf16( sum over the source's K slices of A_s[M, 32] @ B_s[32, N] )
//
// with fp32 accumulation, rounded once.
//
// Design: one 256-thread block computes a 128x128 output tile; 8 warps in a
// 4x2 grid each own 32x64 (2x4 wmma 16x16x16 bf16 fragments). Each K slice
// stages a 128x32 A tile and a 32x128 B tile in shared memory through
// cp.async, two stages deep, so the next slice's loads are in flight while
// the tensor cores work on this one. An element the source masks (a row
// past M, a channel past C or a column past N) is zero-filled by cp.async
// itself (source size 0), so nothing is padded in device memory.
// A source with kTransform rewrites the vectors its thread loaded once they
// have arrived, before the block's barrier. The fp32 accumulators go through
// shared memory (reusing the stages) so that each thread stores 8 bf16 at a
// time, masked at M and N.
//
// Source policy (a struct passed by value):
//   struct Row; Row row(int m) const;            // per-row state, m may be >= M
//   int steps() const;                            // number of K slices
//   const bf16* a_src(const Row&, int step, int col, bool* ok) const;
//   const bf16* b_src(int step, int k, int n, bool* ok) const;
//   static constexpr bool kTransform;
//   void transform(int step, int col, uint4* v) const;  // if kTransform
// col and n are multiples of 8: every staged vector is 16 bytes, so C and N
// must be multiples of 8 and the operands 16-byte aligned.
//
// What bounds it on an H100: no TMA and no wgmma (wmma compiles to the older
// mma.sync), so it stays well below the bf16 peak of 989 TFLOP/s; it reads
// each A element once per 128-column tile of the output.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace vlp {
namespace igemm {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kLda = kBK + 8;   // bf16; 80-byte rows keep cp.async aligned
constexpr int kLdb = kBN + 8;   // bf16
constexpr int kLdc = kBN + 4;   // fp32
constexpr int kAStage = kBM * kLda;
constexpr int kBStage = kBK * kLdb;
constexpr size_t kPipeBytes = 2 * (size_t)(kAStage + kBStage) * sizeof(bf16);
constexpr size_t kOutBytes = (size_t)kBM * kLdc * sizeof(float);
constexpr size_t kSmemBytes = kPipeBytes > kOutBytes ? kPipeBytes : kOutBytes;

// 16 bytes global -> shared, asynchronous; zero-filled when !ok (src is then
// not read, but stays a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <class Src>
__global__ void __launch_bounds__(kThreads)
    igemm_kernel(const Src src, bf16* __restrict__ out, int M, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + 2 * kAStage;
  float* Cs = reinterpret_cast<float*>(smem);  // after the K loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;
  const bool warp_active = n0 + wn < N;

  // this thread's two A vectors: rows tid/4 and tid/4 + 64, columns 8*(tid%4)
  const int a_col = (tid & 3) * 8;
  typename Src::Row rows[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[i] = src.row(m0 + (tid >> 2) + 64 * i);

  auto load = [&](int stage, int step) {
    bf16* as = As + stage * kAStage;
    bf16* bs = Bs + stage * kBStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool ok;
      const bf16* p = src.a_src(rows[i], step, a_col, &ok);
      cp_async16(as + ((tid >> 2) + 64 * i) * kLda + a_col, p, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + kThreads * i;
      const int k = idx >> 4;
      const int c = (idx & 15) * 8;
      bool ok;
      const bf16* p = src.b_src(step, k, n0 + c, &ok);
      cp_async16(bs + k * kLdb + c, p, ok);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int steps = src.steps();
  load(0, 0);
  for (int t = 0; t < steps; ++t) {
    const int stage = t & 1;
    if (t + 1 < steps) {
      load(stage ^ 1, t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (Src::kTransform) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint4* v = reinterpret_cast<uint4*>(
            As + stage * kAStage + ((tid >> 2) + 64 * i) * kLda + a_col);
        src.transform(t, a_col, v);
      }
    }
    __syncthreads();
    if (warp_active) {
      const bf16* as = As + stage * kAStage;
      const bf16* bs = Bs + stage * kBStage;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], as + (wm + 16 * i) * kLda + kk, kLda);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], bs + kk * kLdb + wn + 16 * j, kLdb);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  if (warp_active) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Cs + (wm + 16 * i) * kLdc + wn + 16 * j,
                                acc[i][j], kLdc, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
    const int r = i / (kBN / 8);
    const int c = (i % (kBN / 8)) * 8;
    if (m0 + r >= M || n0 + c >= N) continue;
    const float* row = Cs + r * kLdc + c;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(row[e]);
    *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + c) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// Launches igemm_kernel<Src> on `stream`; returns the launch's cudaError_t.
template <class Src>
cudaError_t launch_igemm(const Src& src, bf16* out, int M, int N,
                         cudaStream_t stream) {
  const int m_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + kBN - 1) / kBN;
  if (M <= 0 || N <= 0 || N % 8 || n_tiles > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      igemm_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  igemm_kernel<Src><<<dim3(m_tiles, n_tiles), kThreads, kSmemBytes, stream>>>(
      src, out, M, N);
  return cudaGetLastError();
}

}  // namespace igemm
}  // namespace vlp
