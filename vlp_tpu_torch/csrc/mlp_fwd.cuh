// The launch sequence of the MLP forwards, shared by ln_mlp.cu (#2, a = ln =
// bf16(LN(x) * gamma + beta), residual x), fused_mlp.cu (#9, a = x, no
// residual) and the probes' mlp_tile.cu (#13 and its ablations, #19a's
// chain), over a [M, D] rows, F the hidden width:
//
//   (#2) ln_rows (bwd_rows.cuh):  ln = bf16(LN(x) * gamma + beta)   [M, D]
//   1. DenseEpi<true>:            h = bf16(z * Phi(z)),
//                                 z = a @ W1 + b1                    [M, F]
//   2. DenseEpi<false>:           y = bf16(x + (h @ W2 + b2))  (#2)  [M, D]
//                                 y = bf16(h @ W2 + b2)        (#9)
//
// Step 1's epilogue form and width are parameters: #2 and #9 run the fast
// GELU at kFc1Width; #13 and #19a the accurate GELU (DenseEpi<true, true>)
// or none (DenseEpi<false>) at 128 or 64 columns.
//
// Both products are dense_epi.cuh's single-product wgmma + TMA tiles with
// their epilogues in registers, rounded at the Pallas bodies' points
// (vlp_tpu/ops/fused_block.py:576-604, vlp_tpu/ops/fused_mlp.py:70-76).
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
// level 2 (20 of a step's 24 calls) by both about equally. The widths were
// measured on an H100 at NesT-Small's levels (scripts/mlp_fwd_widths.py,
// PERF.md): fc1 (N = F = 4D, K = D) at BN = 128, fc2 (N = D, K = 4D: a deep
// K over few columns) at BN = 64, twice the blocks.
#pragma once

#include "bwd_rows.cuh"
#include "dense_epi.cuh"

namespace vlp {
namespace wg {

// The forwards' tile widths, measured at NesT-Small's levels
// (scripts/mlp_fwd_widths.py builds both for each form): fc1 (with GELU)
// 128, fc2 64.
constexpr int kFc1Width = 128, kFc2Width = 64;

}  // namespace wg

// Steps 1-2 on one stream: h [M, F] and y [M, D] from a [M, D], w1 [D, F],
// w2 [F, D] bf16 and b1 [F], b2 [D] fp32; y adds res = x where it is given
// (#2). Step 1 is DenseEpi<kGelu, kErf> at kFc1 columns a tile (#2's and
// #9's by default). Returns the first failing cudaError_t.
template <bool kGelu = true, bool kErf = false, int kFc1 = wg::kFc1Width>
inline cudaError_t mlp_fwd_products(const bf16* a, const bf16* w1,
                                    const float* b1, const bf16* w2,
                                    const float* b2, const bf16* res, bf16* h,
                                    bf16* y, int M, int D, int F,
                                    cudaStream_t st) {
  const cudaError_t err = wg::launch_dense_epi<kGelu, kFc1, kErf>(
      a, w1, b1, nullptr, h, M, F, D, st);
  if (err != cudaSuccess) return err;
  return wg::launch_dense_epi<false, wg::kFc2Width>(h, w2, b2, res, y, M, D,
                                                    F, st);
}

}  // namespace vlp
