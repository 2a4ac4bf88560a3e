// The launch sequence of the MLP forwards, shared by ln_mlp.cu (#2, a = ln =
// bf16(LN(x) * gamma + beta), residual x) and fused_mlp.cu (#9, a = x, no
// residual), over a [M, D] rows, F the hidden width:
//
//   (#2) ln_rows (bwd_rows.cuh):  ln = bf16(LN(x) * gamma + beta)   [M, D]
//   1. DenseEpi<true>:            h = bf16(z * Phi(z)),
//                                 z = a @ W1 + b1                    [M, F]
//   2. DenseEpi<false>:           y = bf16(x + (h @ W2 + b2))  (#2)  [M, D]
//                                 y = bf16(h @ W2 + b2)        (#9)
//
// Both products run on wgmma_gemm.cuh's TMA + wgmma mainloop in the form
// DenseRows (A [M, K] K-major, B [K, N] N-major through the transpose bit,
// the weights read as they lie), with an epilogue of the policy's own in
// place of the store: the fp32 accumulator meets the bias, GELU or the
// residual element by element in the wgmma fragment layout, and is
// rounded to bf16 once, at the Pallas bodies' points
// (vlp_tpu/ops/fused_block.py:576-604, vlp_tpu/ops/fused_mlp.py:70-76). The
// residual is read as bf16 pairs at the fragment's coordinates and added in
// fp32 before the one rounding. GELU is gelu.cuh's gelu_cdf_pdf, the
// function the backwards' dual tile (mlp_bwd.cuh) recomputes h with.
//
// The Pallas bodies keep a row tile's ln and h [tm, F] in VMEM. Here ln and
// h go through device memory: at NesT-Small's level 0 at batch 64 (M =
// 200,704, D = 96, F = 384) h is 154 MB written and read once, ln 38.5 MB.
//
// What bounds it on this card: 4 * M * D * F operations (29.6 GFLOP a call
// at every NesT-Small level at batch 64: 0.030 ms at 989 TFLOP/s) against
// the bytes of the launches: x, ln, h (each written and read), the residual
// and y, ~0.50 GB at level 0, 0.25 at level 1, 0.125 at level 2 (0.15,
// 0.075, 0.037 ms at 3.35 TB/s). So levels 0 and 1 are bound by bytes and
// level 2 (20 of a step's 24 calls) by both about equally. Tiles are 128
// x BN, two blocks an SM, so one block's epilogue overlaps the other's
// loads; the widths were measured on an H100 at NesT-Small's levels
// (scripts/mlp_fwd_widths.py, PERF.md): fc1 (N = F = 4D, K = D) at BN =
// 128, fc2 (N = D, K = 4D: a deep K over few columns) at BN = 64, twice
// the blocks. TMA fills the rows past M and the columns past K with zeros
// (D = 96 is 1.5 steps of 64), and the epilogue masks the stores and the
// residual at M and N.
#pragma once

#include "bwd_rows.cuh"
#include "gelu.cuh"
#include "wgmma_gemm.cuh"

namespace vlp {
namespace wg {

// x @ w as DenseRows reads it, finished in registers: with kGelu h =
// bf16(gelu(acc + bias)); without, y = bf16(acc + bias), or bf16(res + (acc
// + bias)) where res is given. bias [N] fp32, res [M, N] bf16 or null.
template <bool kGelu>
struct DenseEpi : DenseRows {
  static constexpr bool kEpilogue = true;
  const float* bias;
  const bf16* res;

  // acc[4j + 2r + e]: row `row` + 8r, column n0 + 8j + 2 (lane % 4) + e
  template <int BN>
  __device__ __forceinline__ void epilogue(float (&acc)[BN / 2], bf16* out,
                                           int M, int N, int n0, int row,
                                           int lane) const {
#pragma unroll
    for (int c4 = 0; c4 < BN / 32; ++c4) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * c4 + jj;
        const int col = n0 + 8 * j + 2 * (lane & 3);
        const bool in = col < N;  // N % 8 == 0: col + 1 < N as well
        const float b0 = in ? __ldg(bias + col) : 0.f;
        const float b1 = in ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r;
          float z0 = acc[i] + b0, z1 = acc[i + 1] + b1;
          if constexpr (kGelu) {
            float cdf, phi;
            gelu_cdf_pdf(z0, cdf, phi);
            z0 *= cdf;
            gelu_cdf_pdf(z1, cdf, phi);
            z1 *= cdf;
          } else if (res != nullptr) {
            const int rr = row + 8 * r;
            if (in && rr < M) {
              const unsigned pair = __ldg(reinterpret_cast<const unsigned*>(
                  res + (size_t)rr * N + col));
              z0 = __uint_as_float(pair << 16) + z0;
              z1 = __uint_as_float(pair & 0xffff0000u) + z1;
            }
          }
          acc[i] = z0;
          acc[i + 1] = z1;
        }
      }
      store_group<BN>(acc, c4, out, row, n0, M, N, lane);
    }
  }
};

// The forwards' tile widths, measured at NesT-Small's levels
// (scripts/mlp_fwd_widths.py builds both for each form): fc1 (with GELU)
// 128, fc2 64.
constexpr int kFc1Width = 128, kFc2Width = 64;

// One product out = epilogue(a @ w) on 128 x BN tiles, two blocks an SM
// (~97 KB of shared memory each: three stages at BN = 128, four at 64).
// a [M, K], w [K, N], res (or null) and out [M, N] bf16, bias [N] fp32; K
// and N multiples of 8, 16-byte aligned bf16 operands. Encodes the two
// tensor maps on the host and launches once; returns the first failing
// cudaError_t.
template <bool kGelu, int BN>
cudaError_t launch_dense_epi(const bf16* a, const bf16* w, const float* bias,
                             const bf16* res, bf16* out, int M, int N, int K,
                             cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || bias == nullptr ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(res) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return cudaErrorInvalidValue;
  DenseEpi<kGelu> src{};
  CUtensorMap map_a, map_w;
  const cudaError_t err = DenseRows::encode(&map_a, &map_w, a, w, M, N, K);
  if (err != cudaSuccess) return err;
  src.K = K;
  src.bias = bias;
  src.res = res;
  static_assert(BN == 64 || BN == 128, "two blocks an SM");
  return launch_wgmma_gemm<DenseEpi<kGelu>, BN, BN == 128 ? 3 : 4, 2>(
      map_a, map_w, src, out, M, N, st);
}

}  // namespace wg

// Steps 1-2 on one stream: h [M, F] and y [M, D] from a [M, D], w1 [D, F],
// w2 [F, D] bf16 and b1 [F], b2 [D] fp32; y adds res = x where it is given
// (#2). Returns the first failing cudaError_t.
inline cudaError_t mlp_fwd_products(const bf16* a, const bf16* w1,
                                    const float* b1, const bf16* w2,
                                    const float* b2, const bf16* res, bf16* h,
                                    bf16* y, int M, int D, int F,
                                    cudaStream_t st) {
  const cudaError_t err = wg::launch_dense_epi<true, wg::kFc1Width>(
      a, w1, b1, nullptr, h, M, F, D, st);
  if (err != cudaSuccess) return err;
  return wg::launch_dense_epi<false, wg::kFc2Width>(h, w2, b2, res, y, M, D,
                                                    F, st);
}

}  // namespace vlp
