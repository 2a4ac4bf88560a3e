// Backward of ln_mlp, y = x + fc2(gelu(fc1(LN(x)))), over x [M, D] rows.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_block.py:_lnmlp_bwd
// (body _lnmlp_bwd_kernel, :607-645, the default serial schedule), the custom
// VJP of the public ln_mlp. Returns all seven cotangents: dx bf16, dgamma,
// dbeta, db1, db2 fp32 and dW1, dW2 fp32-accumulated and cast to bf16 once.
//
// The TPU kernel keeps a row tile's z, h and dh [tm, 4D] in VMEM and carries
// the weight gradients across its sequential grid. Here the backward runs as
// launches of hand-written kernels on one stream (F = 4D):
//
//   1. ln_rows:      ln = bf16(LN(x) * gamma + beta)                  [M, D]
//   2-5. mlp_bwd.cuh's products on wgmma_gemm.cuh: the dual tile (h and
//        dh [M, F] from z = ln @ W1 + b1 and dy @ W2^T, gelu'(z) kept in
//        registers, fp32 column sums of dh32 per 128-row tile), dW2 = h^T
//        @ dy and dW1 = ln^T @ dh (split-K fp32 partials), dln = dh @ W1^T
//        fp32 [M, D]
//   6. ln_bwd_rows:  dx = bf16(dy + LN_bwd(dln * gamma)), partial sums of
//                    dln * x_hat, dln, dy per 256 rows
//   7. reduce_rows:  the partials in a fixed order -> dW1, dW2 (bf16),
//                    dgamma, dbeta, db1, db2 (fp32)
//
// Nothing is saved from the forward: h is recomputed as bf16(z * cdf), the
// Pallas backward's association, which can differ in the last bit from the
// forward's bf16(gelu(z)). gelu'(z) stays fp32 up to its product with
// dy @ W2^T, as in the Pallas body, and never leaves the dual tile's
// registers. The workspace (ln, h, dh, dln and the partials) is 6 * M * D +
// 4 * M * F bytes plus the partials: ~440 MB at level 0 of NesT-Small at
// batch 64 (M = 200,704, D = 96), reused by every block.
//
// What bounds it on this card: 10 * M * D * F FLOPs (74 GFLOP per call at
// every level of NesT-Small at batch 64, 0.075 ms at 989 TFLOP/s) against
// the bytes the launches move: the products about 1.0 GB at level 0
// (mlp_bwd.cuh), the row passes x, dy, dln, dx and ln once more. So it is
// bound by memory traffic, and with the products on wgmma the row passes
// take a large share; fusing the LN backward into the dln product's
// epilogue is later work. The sequence is mlp_bwd.cuh's ln_mlp_backward,
// which the probe #14 (mlp_tile_bwd.cu) shares.
#include "mlp_bwd.cuh"

extern "C" size_t vlp_ln_mlp_bwd_workspace(int M, int D, int F) {
  return vlp::MlpBwdWs(nullptr, M, D, F).bytes;
}

// x, dy, dx [M, D] bf16; w1 [D, F], w2 [F, D] bf16 ([in, out]); gamma, beta
// [D] and b1 [F] fp32. Outputs: dgamma, dbeta, db2 [D] and db1 [F] fp32;
// dw1, dw2 bf16 like the weights. ws: vlp_ln_mlp_bwd_workspace bytes.
// Returns the first failing cudaError_t.
extern "C" int vlp_ln_mlp_bwd(const void* x, const void* gamma,
                              const void* beta, const void* w1, const void* b1,
                              const void* w2, const void* dy, void* dx,
                              void* dgamma, void* dbeta, void* dw1, void* db1,
                              void* dw2, void* db2, void* ws, int M, int D,
                              int F, float eps, void* stream) {
  using vlp::bf16;
  return (int)vlp::ln_mlp_backward(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<bf16*>(dw1), static_cast<float*>(db1),
      static_cast<bf16*>(dw2), static_cast<float*>(db2), ws, M, D, F, eps,
      static_cast<cudaStream_t>(stream));
}
