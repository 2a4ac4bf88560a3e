// Row kernels and the deterministic reduction shared by the backwards
// (ln_attention_bwd.cu, ln_mlp_bwd.cu, fused_mlp_bwd.cu).
//
//   ln_rows_kernel:      ln = bf16(LN(x) * gamma + beta), one warp per row
//   ln_bwd_rows_kernel:  dx = bf16(dy + LN_bwd(dln * gamma)), with the
//                        block's column partial sums of dln * x_hat, dln
//                        and dy (for dgamma, dbeta and the output bias)
//   col_partials_kernel: part[b, c] = sum of x[r, c] over the rows r of
//                        row block b, in a fixed order (for a bias
//                        gradient)
//   reduce_rows_kernel:  out[c] = sum over p of part[p * stride + c], p in
//                        order: partials -> fp32 vector or bf16 weight
//
// The LayerNorm is the Pallas kernels' (vlp_tpu/ops/fused_block.py:39-51):
// fp32, two-pass variance, eps 1e-6, recomputed from x rather than saved.
// Every cross-row sum goes through fixed partials and a fixed-order
// reduction, never float atomics, so reruns agree bit for bit. These are
// memory-bound passes: each reads its rows once (x, dln, dy: 8 bytes per
// element for ln_bwd_rows) and writes one row; one warp per row keeps the
// row's values in registers (D <= 1024, D % 32 == 0).
#pragma once

#include <initializer_list>

#include "common.cuh"

namespace vlp {

constexpr int kRowWarps = 8;
constexpr int kRowsPerBlock = 256;  // rows of one ln_bwd_rows partial
constexpr int kMaxPerLane = 32;     // D / 32 <= 32

// Two-pass mean and 1/sigma of one row held as v[j] = row[lane + 32 j].
// PL is the registers' capacity per lane (>= D / 32), a compile-time bound
// so that the per-lane arrays stay in registers.
template <int PL>
__device__ __forceinline__ void row_stats(const float* v, int per_lane, int D,
                                          float eps, float& mu, float& inv) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j)
    if (j < per_lane) s += v[j];
  mu = warp_sum(s) / (float)D;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j)
    if (j < per_lane) {
      const float d = v[j] - mu;
      q += d * d;
    }
  inv = rsqrtf(warp_sum(q) / (float)D + eps);
}

template <int PL>
__global__ void __launch_bounds__(kRowWarps * 32)
    ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, bf16* __restrict__ ln,
                   int M, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const int per_lane = D / 32;
  const bf16* xr = x + (size_t)row * D;
  float v[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j)
    if (j < per_lane) v[j] = __bfloat162float(xr[lane + 32 * j]);
  float mu, inv;
  row_stats<PL>(v, per_lane, D, eps, mu, inv);
#pragma unroll
  for (int j = 0; j < PL; ++j)
    if (j < per_lane) {
      const int c = lane + 32 * j;
      const float xh = (v[j] - mu) * inv;
      ln[(size_t)row * D + c] = __float2bfloat16(xh * gamma[c] + beta[c]);
    }
}

// grid ceil(M / kRowsPerBlock); part [gridDim.x, 3, D]: sums of dln * x_hat,
// dln and dy over the block's rows.
template <int PL>
__global__ void __launch_bounds__(kRowWarps * 32)
    ln_bwd_rows_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ dln,
                       const bf16* __restrict__ dy, bf16* __restrict__ dx,
                       float* __restrict__ part, int M, int D, float eps) {
  extern __shared__ __align__(16) float red[];  // [kRowWarps][3][D]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per_lane = D / 32;
  float acc_g[PL], acc_b[PL], acc_y[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) acc_g[j] = acc_b[j] = acc_y[j] = 0.f;

  const int r_end = min(M, (blockIdx.x + 1) * kRowsPerBlock);
  for (int row = blockIdx.x * kRowsPerBlock + warp; row < r_end;
       row += kRowWarps) {
    const size_t base = (size_t)row * D;
    float xv[PL], g[PL];
#pragma unroll
    for (int j = 0; j < PL; ++j)
      if (j < per_lane) xv[j] = __bfloat162float(x[base + lane + 32 * j]);
    float mu, inv;
    row_stats<PL>(xv, per_lane, D, eps, mu, inv);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < PL; ++j)
      if (j < per_lane) {
        const int c = lane + 32 * j;
        const float d = dln[base + c];
        xv[j] = (xv[j] - mu) * inv;  // x_hat
        g[j] = d * gamma[c];         // d x_hat
        m1 += g[j];
        m2 += g[j] * xv[j];
        acc_g[j] += d * xv[j];
        acc_b[j] += d;
      }
    m1 = warp_sum(m1) / (float)D;
    m2 = warp_sum(m2) / (float)D;
#pragma unroll
    for (int j = 0; j < PL; ++j)
      if (j < per_lane) {
        const int c = lane + 32 * j;
        const float y = __bfloat162float(dy[base + c]);
        acc_y[j] += y;
        dx[base + c] =
            __float2bfloat16(y + inv * (g[j] - m1 - xv[j] * m2));
      }
  }
#pragma unroll
  for (int j = 0; j < PL; ++j)
    if (j < per_lane) {
      const int c = lane + 32 * j;
      red[(warp * 3 + 0) * D + c] = acc_g[j];
      red[(warp * 3 + 1) * D + c] = acc_b[j];
      red[(warp * 3 + 2) * D + c] = acc_y[j];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * D; i += kRowWarps * 32) {
    float s = 0.f;
    for (int w = 0; w < kRowWarps; ++w) s += red[w * 3 * D + i];
    part[(size_t)blockIdx.x * 3 * D + i] = s;
  }
}

// grid (ceil(D / 64), col_row_blocks(M)); block kColWarps warps. Lane l
// of warp w sums columns 2l, 2l + 1 of the block's 64 (a bf16 pair: a
// warp reads 128 contiguous bytes of a row) over rows w, w + kColWarps,
// ... of the block's kRowsPerBlock, in order; the warps' sums are then
// added in warp order. Each thread walks 32 rows, not 256, so the pass is
// not bound by one thread's chain of loads when M is small (a few blocks
// a column). D even. (A template, as every kernel in these headers, so
// that each object file's copy links as one.)
template <int kColWarps>
__global__ void __launch_bounds__(kColWarps * 32)
    col_partials_kernel(const bf16* __restrict__ x, float* __restrict__ part,
                        int M, int D) {
  __shared__ float2 red[kColWarps][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * 64 + 2 * lane;
  const int r_end = min(M, (int)(blockIdx.y + 1) * kRowsPerBlock);
  float2 s = make_float2(0.f, 0.f);
  if (c < D) {
    for (int r = blockIdx.y * kRowsPerBlock + warp; r < r_end;
         r += kColWarps) {
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)r * D + c);
      s.x += __low2float(v);
      s.y += __high2float(v);
    }
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < D) {
    float2 t = red[0][lane];
#pragma unroll
    for (int w = 1; w < kColWarps; ++w) {
      t.x += red[w][lane].x;
      t.y += red[w][lane].y;
    }
    part[(size_t)blockIdx.y * D + c] = t.x;
    part[(size_t)blockIdx.y * D + c + 1] = t.y;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void reduce_rows_kernel(const float* __restrict__ part,
                                   T* __restrict__ out, int P, size_t stride,
                                   size_t n) {
  const size_t c = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += part[p * stride + c];
  out[c] = from_float<T>(s);
}

// The smallest supported register capacity PL >= D / 32, or 0.
inline int per_lane_bucket(int D) {
  const int pl = D / 32;
  if (D <= 0 || D % 32 || pl > kMaxPerLane) return 0;
  for (int b : {1, 2, 4, 8, 12, 16, 32})
    if (pl <= b) return b;
  return 0;
}

#define VLP_PER_LANE_SWITCH(D, CALL) \
  switch (per_lane_bucket(D)) {      \
    case 1: return CALL<1>();          \
    case 2: return CALL<2>();          \
    case 4: return CALL<4>();          \
    case 8: return CALL<8>();          \
    case 12: return CALL<12>();        \
    case 16: return CALL<16>();        \
    case 32: return CALL<32>();        \
    default: return cudaErrorInvalidValue; \
  }

struct LnRowsArgs {
  const bf16* x;
  const float* gamma;
  const float* beta;
  bf16* ln;
  int M, D;
  float eps;
  cudaStream_t st;
  template <int PL>
  cudaError_t run() const {
    ln_rows_kernel<PL><<<(M + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                         st>>>(x, gamma, beta, ln, M, D, eps);
    return cudaGetLastError();
  }
};

inline cudaError_t launch_ln_rows(const bf16* x, const float* gamma,
                                  const float* beta, bf16* ln, int M, int D,
                                  float eps, cudaStream_t st) {
  if (M <= 0) return cudaErrorInvalidValue;
  const LnRowsArgs a{x, gamma, beta, ln, M, D, eps, st};
  VLP_PER_LANE_SWITCH(D, a.run)
}

inline int ln_bwd_row_blocks(int M) {
  return (M + kRowsPerBlock - 1) / kRowsPerBlock;
}

struct LnBwdRowsArgs {
  const bf16* x;
  const float* gamma;
  const float* dln;
  const bf16* dy;
  bf16* dx;
  float* part;
  int M, D;
  float eps;
  cudaStream_t st;
  template <int PL>
  cudaError_t run() const {
    const size_t smem = (size_t)kRowWarps * 3 * D * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_rows_kernel<PL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    ln_bwd_rows_kernel<PL><<<ln_bwd_row_blocks(M), kRowWarps * 32, smem,
                             st>>>(x, gamma, dln, dy, dx, part, M, D, eps);
    return cudaGetLastError();
  }
};

inline cudaError_t launch_ln_bwd_rows(const bf16* x, const float* gamma,
                                      const float* dln, const bf16* dy,
                                      bf16* dx, float* part, int M, int D,
                                      float eps, cudaStream_t st) {
  if (M <= 0) return cudaErrorInvalidValue;
  const LnBwdRowsArgs a{x, gamma, dln, dy, dx, part, M, D, eps, st};
  VLP_PER_LANE_SWITCH(D, a.run)
}

inline int col_row_blocks(int M) {
  return (M + kRowsPerBlock - 1) / kRowsPerBlock;
}

// x [M, D] bf16, 4-byte aligned rows (D even).
inline cudaError_t launch_col_partials(const bf16* x, float* part, int M,
                                       int D, cudaStream_t st) {
  constexpr int kWarps = 8;
  if (M <= 0 || D <= 0 || D % 2 || col_row_blocks(M) > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 4)
    return cudaErrorInvalidValue;
  col_partials_kernel<kWarps>
      <<<dim3((D + 63) / 64, col_row_blocks(M)), kWarps * 32, 0, st>>>(
          x, part, M, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reduce_rows(const float* part, T* out, int P,
                               size_t stride, size_t n, cudaStream_t st) {
  if (P <= 0 || n == 0) return cudaErrorInvalidValue;
  const int threads = 256;
  reduce_rows_kernel<T><<<(unsigned)((n + threads - 1) / threads), threads, 0,
                          st>>>(part, out, P, stride, n);
  return cudaGetLastError();
}

// Carves one workspace buffer into 256-byte aligned pieces.
struct Carver {
  char* base;
  size_t used = 0;
  template <typename T>
  T* take(size_t elems) {
    T* p = reinterpret_cast<T*>(base ? base + used : nullptr);
    used += (elems * sizeof(T) + 255) / 256 * 256;
    return p;
  }
};

}  // namespace vlp
