// Backward of fused_mlp, y = bf16(gelu(x @ W1 + b1)) @ W2 + b2, over x
// [M, D] rows.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_mlp.py:_mlp_bwd (body
// _bwd_kernel, :79-108), the custom VJP of fused_mlp. Returns dx bf16, dW1
// and dW2 fp32-accumulated and cast to bf16 once (fused_mlp.py:192-193),
// db1 = sum of the fp32 dh before its rounding and db2 = sum of do, fp32.
//
// The TPU kernel keeps a row tile's z, h and dh [tm, F] in VMEM and carries
// the weight gradients across its sequential grid. Here it is the launch
// sequence of the half-block MLP backward (ln_mlp_bwd.cu) without the
// LayerNorm and without the residual, every product a wmma GEMM of
// gemm.cuh:
//
//   1. gemm NN, epilogue: z = x @ W1 + b1 -> h = bf16(z * cdf) [M, F] and
//                         gelu'(z) = cdf + z * phi fp32 [M, F]
//                         (fused_mlp.py:_gelu_and_grad, the backward's form)
//   2. gemm TN, split-K:  dW2 = h^T @ do              (fp32 partials)
//   3. gemm NT, epilogue: dh32 = (do @ W2^T) * gelu'(z); dh = bf16(dh32)
//                         [M, F]; fp32 column sums of dh32 per 64-row tile
//   4. gemm TN, split-K:  dW1 = x^T @ dh              (fp32 partials)
//   5. gemm NT:           dx = bf16(dh @ W1^T)                       [M, D]
//   6. col_partials:      column sums of do per 256 rows (fp32)
//   7. reduce_rows:       the partials in a fixed order -> dW1, dW2 (bf16),
//                         db1, db2 (fp32)
//
// Nothing is saved from the forward but x: h is recomputed as
// bf16(z * cdf), the Pallas backward's association. No float atomics, so
// reruns agree bit for bit. The workspace (h, gelu', dh and the partials)
// is 8 * M * F bytes plus the partials: 617 MB at level 0 of NesT-Small at
// batch 64 (M = 200,704, F = 384), reused by every block.
//
// What bounds it on this card: 10 * M * D * F FLOPs (74 GFLOP per call at
// every level of NesT-Small at batch 64, 75 us at 989 TFLOP/s) against
// 6 * M * D bytes of x, do and dx (116 MB at level 0, 35 us at 3.35 TB/s):
// the ideal kernel is bound by the tensor cores, and the five GEMMs of the
// unpipelined form of gemm.cuh run far below them, plus the F-wide fp32
// gelu' round trip through device memory. Keeping h, gelu' and dh on chip
// and a wgmma/TMA pipeline are later work.
#include "bwd_rows.cuh"

namespace vlp {

struct FusedMlpBwdWs {
  bf16* h;
  float* dgelu;
  bf16* dh;
  float* b1part;  // [m tiles, F]
  float* wpart;   // [splits, D, F] (dW2 reuses it)
  float* b2part;  // [row blocks, D]
  int s_w1, s_w2, m_tiles;
  size_t bytes;

  FusedMlpBwdWs(void* base, int M, int D, int F) {
    s_w2 = weight_grad_splits(F, D, M);
    s_w1 = weight_grad_splits(D, F, M);
    m_tiles = (M + kBM - 1) / kBM;
    Carver c{static_cast<char*>(base)};
    h = c.take<bf16>((size_t)M * F);
    dgelu = c.take<float>((size_t)M * F);
    dh = c.take<bf16>((size_t)M * F);
    b1part = c.take<float>((size_t)m_tiles * F);
    wpart = c.take<float>((size_t)D * F * (s_w1 > s_w2 ? s_w1 : s_w2));
    b2part = c.take<float>((size_t)col_row_blocks(M) * D);
    bytes = c.used;
  }
};

}  // namespace vlp

extern "C" size_t vlp_fused_mlp_bwd_workspace(int M, int D, int F) {
  return vlp::FusedMlpBwdWs(nullptr, M, D, F).bytes;
}

// x, dy, dx [M, D] bf16; w1 [D, F], w2 [F, D] bf16 ([in, out]); b1 [F]
// fp32. Outputs: db1 [F] and db2 [D] fp32; dw1, dw2 bf16 like the weights.
// ws: vlp_fused_mlp_bwd_workspace bytes. Returns the first failing
// cudaError_t.
extern "C" int vlp_fused_mlp_bwd(const void* x, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* dy, void* dx, void* dw1,
                                 void* db1, void* dw2, void* db2, void* ws,
                                 int M, int D, int F, void* stream) {
  using vlp::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const vlp::FusedMlpBwdWs w(ws, M, D, F);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  // h = bf16(z * cdf), gelu'(z), z = x @ W1 + b1
  cudaError_t err = vlp::launch_gemm_ex<false, false, false,
                                        vlp::kEpiBiasGeluGrad>(
      xb, nullptr, nullptr, static_cast<const bf16*>(w1),
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
  // dW1 = x^T @ dh
  err = vlp::launch_gemm_ex<false, true, false, vlp::kEpiF32>(
      xb, nullptr, nullptr, w.dh, nullptr, nullptr, nullptr, w.wpart,
      nullptr, D, F, M, w.s_w1, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_reduce_rows(w.wpart, static_cast<bf16*>(dw1), w.s_w1,
                                (size_t)D * F, (size_t)D * F, st);
  if (err != cudaSuccess) return (int)err;
  // dx = bf16(dh @ W1^T)
  err = vlp::launch_gemm_ex<false, false, true, vlp::kEpiBf16>(
      w.dh, nullptr, nullptr, static_cast<const bf16*>(w1), nullptr, nullptr,
      nullptr, dx, nullptr, M, D, F, 1, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_reduce_rows(w.b1part, static_cast<float*>(db1), w.m_tiles,
                                (size_t)F, (size_t)F, st);
  if (err != cudaSuccess) return (int)err;
  // db2 = sum of dy over the rows
  err = vlp::launch_col_partials(dyb, w.b2part, M, D, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_reduce_rows(w.b2part, static_cast<float*>(db2),
                                vlp::col_row_blocks(M), (size_t)D, (size_t)D,
                                st);
  return (int)err;
}
