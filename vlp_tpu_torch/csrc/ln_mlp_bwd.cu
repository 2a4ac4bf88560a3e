// Backward of ln_mlp, y = x + fc2(gelu(fc1(LN(x)))), over x [M, D] rows.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_block.py:_lnmlp_bwd
// (body _lnmlp_bwd_kernel, :607-645, the default serial schedule), the custom
// VJP of the public ln_mlp. Returns all seven cotangents: dx bf16, dgamma,
// dbeta, db1, db2 fp32 and dW1, dW2 fp32-accumulated and cast to bf16 once.
//
// The TPU kernel keeps a row tile's z, h and dh [tm, 4D] in VMEM and carries
// the weight gradients across its sequential grid. Here the backward runs as
// launches of hand-written kernels on one stream, every product a wmma GEMM
// of gemm.cuh (F = 4D):
//
//   1. ln_rows:           ln = bf16(LN(x) * gamma + beta)           [M, D]
//   2. gemm NN, epilogue: z = ln @ W1 + b1 -> h = bf16(z * cdf) [M, F] and
//                         gelu'(z) = cdf + z * phi fp32 [M, F]
//                         (fused_mlp.py:_gelu_and_grad, the backward's form)
//   3. gemm TN, split-K:  dW2 = h^T @ dy              (fp32 partials)
//   4. gemm NT, epilogue: dh32 = (dy @ W2^T) * gelu'(z); dh = bf16(dh32)
//                         [M, F]; fp32 column sums of dh32 per 64-row tile
//   5. gemm TN, split-K:  dW1 = ln^T @ dh             (fp32 partials)
//   6. gemm NT:           dln = dh @ W1^T  fp32                       [M, D]
//   7. ln_bwd_rows:       dx = bf16(dy + LN_bwd(dln * gamma)), partial sums
//                         of dln * x_hat, dln, dy per 256 rows
//   8. reduce_rows:       the partials in a fixed order -> dW1, dW2 (bf16),
//                         dgamma, dbeta, db1, db2 (fp32)
//
// Nothing is saved from the forward: h is recomputed as bf16(z * cdf), the
// Pallas backward's association, which can differ in the last bit from the
// forward's bf16(gelu(z)). gelu'(z) stays fp32 up to its product with
// dy @ W2^T, as in the Pallas body. The workspace (ln, h, gelu', dh, dln and
// the partials) is 2*M*D + 8*M*F + 4*M*D bytes plus the partials: 730 MB at
// level 0 of NesT-Small at batch 64 (M = 200,704, D = 96), reused by every
// block.
//
// What bounds it on this card: 10 * M * D * F FLOPs (74 GFLOP per call at
// every level of NesT-Small at batch 64) in five GEMMs of the unpipelined
// form of gemm.cuh, which runs far below the bf16 roofline, plus the
// F-wide fp32 gelu' round trip through device memory (8 bytes per element
// of h). Keeping h, gelu' and dh on chip (a fused per-row-tile kernel with
// the weight-gradient partials in registers) and a wgmma/TMA pipeline are
// later work.
#include "bwd_rows.cuh"

namespace vlp {

struct MlpBwdWs {
  bf16* ln;
  bf16* h;
  float* dgelu;
  bf16* dh;
  float* dln;
  float* b1part;  // [m tiles, F]
  float* wpart;   // [splits, D, F] (dW2 reuses it)
  float* rpart;   // [row blocks, 3, D]
  int s_w1, s_w2, m_tiles;
  size_t bytes;

  MlpBwdWs(void* base, int M, int D, int F) {
    s_w2 = weight_grad_splits(F, D, M);
    s_w1 = weight_grad_splits(D, F, M);
    m_tiles = (M + kBM - 1) / kBM;
    Carver c{static_cast<char*>(base)};
    ln = c.take<bf16>((size_t)M * D);
    h = c.take<bf16>((size_t)M * F);
    dgelu = c.take<float>((size_t)M * F);
    dh = c.take<bf16>((size_t)M * F);
    dln = c.take<float>((size_t)M * D);
    b1part = c.take<float>((size_t)m_tiles * F);
    wpart = c.take<float>((size_t)D * F * (s_w1 > s_w2 ? s_w1 : s_w2));
    rpart = c.take<float>((size_t)ln_bwd_row_blocks(M) * 3 * D);
    bytes = c.used;
  }
};

}  // namespace vlp

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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const vlp::MlpBwdWs w(ws, M, D, F);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const float* g = static_cast<const float*>(gamma);
  cudaError_t err = vlp::launch_ln_rows(xb, g, static_cast<const float*>(beta),
                                        w.ln, M, D, eps, st);
  if (err != cudaSuccess) return (int)err;
  // h = bf16(z * cdf), gelu'(z), z = ln @ W1 + b1
  err = vlp::launch_gemm_ex<false, false, false, vlp::kEpiBiasGeluGrad>(
      w.ln, nullptr, nullptr, static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), nullptr, w.dgelu, w.h, nullptr, M, F, D,
      1, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  // dW2 = h^T @ dy
  err = vlp::launch_gemm_ex<false, true, false, vlp::kEpiF32>(
      w.h, nullptr, nullptr, dyb, nullptr, nullptr, nullptr, w.wpart, nullptr,
      F, D, M, w.s_w2, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_reduce_rows(w.wpart, static_cast<bf16*>(dw2), w.s_w2,
                                (size_t)F * D, (size_t)F * D, st);
  if (err != cudaSuccess) return (int)err;
  // dh = bf16((dy @ W2^T) * gelu'(z)), column sums of the fp32 product
  err = vlp::launch_gemm_ex<false, false, true, vlp::kEpiMulAux>(
      dyb, nullptr, nullptr, static_cast<const bf16*>(w2), nullptr, nullptr,
      w.dgelu, w.dh, w.b1part, M, F, D, 1, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  // dW1 = ln^T @ dh
  err = vlp::launch_gemm_ex<false, true, false, vlp::kEpiF32>(
      w.ln, nullptr, nullptr, w.dh, nullptr, nullptr, nullptr, w.wpart,
      nullptr, D, F, M, w.s_w1, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_reduce_rows(w.wpart, static_cast<bf16*>(dw1), w.s_w1,
                                (size_t)D * F, (size_t)D * F, st);
  if (err != cudaSuccess) return (int)err;
  // dln = dh @ W1^T
  err = vlp::launch_gemm_ex<false, false, true, vlp::kEpiF32>(
      w.dh, nullptr, nullptr, static_cast<const bf16*>(w1), nullptr, nullptr,
      nullptr, w.dln, nullptr, M, D, F, 1, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_ln_bwd_rows(xb, g, w.dln, dyb, static_cast<bf16*>(dx),
                                w.rpart, M, D, eps, st);
  if (err != cudaSuccess) return (int)err;
  const int rb = vlp::ln_bwd_row_blocks(M);
  float* outs[3] = {static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                    static_cast<float*>(db2)};
  for (int k = 0; k < 3; ++k) {
    err = vlp::launch_reduce_rows(w.rpart + (size_t)k * D, outs[k], rb,
                                  (size_t)3 * D, (size_t)D, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = vlp::launch_reduce_rows(w.b1part, static_cast<float*>(db1), w.m_tiles,
                                (size_t)F, (size_t)F, st);
  return (int)err;
}
