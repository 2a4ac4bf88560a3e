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
// LayerNorm and without the residual:
//
//   1-4. mlp_bwd.cuh's products on wgmma_gemm.cuh: the dual tile (h and
//        dh [M, F] from z = x @ W1 + b1 and do @ W2^T, gelu'(z) kept in
//        registers, fp32 column sums of dh32 per 128-row tile), dW2 = h^T
//        @ do and dW1 = x^T @ dh (split-K fp32 partials), dx = bf16(dh @
//        W1^T) [M, D]
//   5. col_partials:  column sums of do per 256 rows (fp32)
//   6. reduce_rows:   the partials in a fixed order -> dW1, dW2 (bf16),
//                     db1, db2 (fp32)
//
// Nothing is saved from the forward but x: h is recomputed as
// bf16(z * cdf), the Pallas backward's association. No float atomics, so
// reruns agree bit for bit. The workspace (h, dh and the partials) is
// 4 * M * F bytes plus the partials: ~325 MB at level 0 of NesT-Small at
// batch 64 (M = 200,704, F = 384), reused by every block.
//
// What bounds it on this card: 10 * M * D * F FLOPs (74 GFLOP per call at
// every level of NesT-Small at batch 64, 75 us at 989 TFLOP/s) against
// 6 * M * D bytes of x, do and dx (116 MB at level 0, 35 us at 3.35 TB/s):
// the ideal kernel is bound by the tensor cores, but h and dh [M, F] go
// through device memory between the products (about 1.0 GB of traffic a
// call at level 0, mlp_bwd.cuh), so this sequence is bound by bytes.
// Keeping h and dh on chip across the weight gradients is later work.
#include "mlp_bwd.cuh"

namespace vlp {

struct FusedMlpBwdWs {
  MlpGradWs g;    // h, dh, the column sums and the weight partials
  float* b2part;  // [row blocks, D]
  size_t bytes;

  FusedMlpBwdWs(void* base, int M, int D, int F) {
    Carver c{static_cast<char*>(base)};
    g = MlpGradWs(c, M, D, F);
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
  cudaError_t err = vlp::mlp_bwd_products(
      xb, static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), dyb, w.g, static_cast<bf16*>(dx),
      static_cast<bf16*>(dw1), static_cast<float*>(db1),
      static_cast<bf16*>(dw2), M, D, F, st);
  if (err != cudaSuccess) return (int)err;
  // db2 = sum of dy over the rows
  err = vlp::launch_col_partials(dyb, w.b2part, M, D, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_reduce_rows(w.b2part, static_cast<float*>(db2),
                                vlp::col_row_blocks(M), (size_t)D, (size_t)D,
                                st);
  return (int)err;
}

// The dual tile by itself, for checks against plain products and for
// timing: h, dh [M, F] bf16 and colsum [ceil(M / 128), F] fp32 (the column
// sums of dh32 over each 128-row tile) from a, dy [M, D], w1 [D, F], w2
// [F, D] bf16 and b1 [F] fp32. Returns the launch's cudaError_t.
extern "C" int vlp_mlp_dual(const void* a, const void* w1, const void* b1,
                            const void* dy, const void* w2, void* h, void* dh,
                            void* colsum, int M, int D, int F, void* stream) {
  using vlp::bf16;
  return (int)vlp::wg::launch_mlp_dual(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(w2), static_cast<bf16*>(h),
      static_cast<bf16*>(dh), static_cast<float*>(colsum), M, D, F,
      static_cast<cudaStream_t>(stream));
}
