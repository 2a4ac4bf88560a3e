// One dense product with its epilogue in registers, shared by the MLP
// forwards (mlp_fwd.cuh: #2 ln_mlp, #9 fused_mlp, and the probes #13
// mlp_tile and #19a mlp_chain) and the half-block attention forwards
// (ln_attention.cuh: #1 ln_attention, #5 ln_attention_windows):
//
//   DenseEpi<true>:        out = bf16(gelu(a @ w + bias))
//   DenseEpi<true, true>:  the same with the accurate GELU (#13, #19a)
//   DenseEpi<false>:       out = bf16(a @ w + bias), or bf16(res + (a @ w +
//                          bias)) where res is given
//
// The product runs on wgmma_gemm.cuh's TMA + wgmma mainloop in the form
// DenseRows (A [M, K] K-major, B [K, N] N-major through the transpose bit,
// the weights read as they lie), with an epilogue of the policy's own in
// place of the store: the fp32 accumulator meets the bias, GELU or the
// residual element by element in the wgmma fragment layout, and is
// rounded to bf16 once, at the Pallas bodies' points
// (vlp_tpu/ops/fused_block.py:318-323, :576-604,
// vlp_tpu/ops/fused_mlp.py:70-76). The residual is read as bf16 pairs at
// the fragment's coordinates and added in fp32 before the one rounding.
// GELU is gelu.cuh's gelu_cdf_pdf, the function the MLP backwards' dual
// tile (mlp_bwd.cuh) recomputes h with, or with kErf gelu_erf_h, the
// probes' accurate form (one expf and a refined reciprocal an element).
//
// Tiles are 128 x BN (64 or 128), two blocks an SM, so one block's
// epilogue overlaps the other's loads; each sequence picks its widths from
// measurements at NesT-Small's levels (scripts/mlp_fwd_widths.py). TMA
// fills the rows past M and the columns past K with zeros (D = 96 is 1.5
// steps of 64), and the epilogue masks the stores and the residual at M
// and N.
#pragma once

#include "gelu.cuh"
#include "wgmma_gemm.cuh"

namespace vlp {
namespace wg {

// x @ w as DenseRows reads it, finished in registers: with kGelu h =
// bf16(gelu(acc + bias)) (kErf: the accurate GELU); without, y = bf16(acc +
// bias), or bf16(res + (acc + bias)) where res is given. bias [N] fp32, res
// [M, N] bf16 or null.
template <bool kGelu, bool kErf = false>
struct DenseEpi : DenseRows {
  static_assert(kGelu || !kErf, "kErf is a form of the GELU");
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
          if constexpr (kErf) {
            z0 = gelu_erf_h(z0);
            z1 = gelu_erf_h(z1);
          } else if constexpr (kGelu) {
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

// One product out = epilogue(a @ w) on 128 x BN tiles, two blocks an SM
// (~97 KB of shared memory each: three stages at BN = 128, four at 64).
// a [M, K], w [K, N], res (or null) and out [M, N] bf16, bias [N] fp32; K
// and N multiples of 8, 16-byte aligned bf16 operands. Encodes the two
// tensor maps on the host and launches once; returns the first failing
// cudaError_t.
template <bool kGelu, int BN, bool kErf = false>
cudaError_t launch_dense_epi(const bf16* a, const bf16* w, const float* bias,
                             const bf16* res, bf16* out, int M, int N, int K,
                             cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || bias == nullptr ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(res) | reinterpret_cast<uintptr_t>(out)) %
          16)
    return cudaErrorInvalidValue;
  DenseEpi<kGelu, kErf> src{};
  CUtensorMap map_a, map_w;
  const cudaError_t err = DenseRows::encode(&map_a, &map_w, a, w, M, N, K);
  if (err != cudaSuccess) return err;
  src.K = K;
  src.bias = bias;
  src.res = res;
  static_assert(BN == 64 || BN == 128, "two blocks an SM");
  return launch_wgmma_gemm<DenseEpi<kGelu, kErf>, BN, BN == 128 ? 3 : 4,
                           2>(map_a, map_w, src, out, M, N, st);
}

}  // namespace wg
}  // namespace vlp
