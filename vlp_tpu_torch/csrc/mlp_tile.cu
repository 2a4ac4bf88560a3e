// The MLP probe forwards #13 and #19a, one entry point running the shipped
// MLP forward #2's launch sequence (mlp_fwd.cuh) on one stream:
//
//   mlp_tile:   y = bf16(x + (h @ W2 + b2)), h = bf16(gelu(bf16(LN(x) *
//               gamma + beta) @ W1 + b1)), and its two ablations: GELU ->
//               identity (h = bf16(z)) and LN -> identity (fc1 reads x)
//   mlp_chain:  y = bf16(bf16(g(x' @ W1)) @ W2), x' = bf16(x_hat) (LayerNorm
//               without affine) with "ln", else x; g = GELU with "gelu",
//               else identity; no bias, no residual
//
// Replaces the Pallas TPU kernels benchmarks/mega_variants.py:make_mlp with
// the body mlp_fwd_kernel_v0 (:83, with its gelu and ln flags), the
// schedule probe of the half block's MLP, and benchmarks/mlp_probe.py:
// make_chain (body chain_kernel, :58), the probe of what the MLP's matmul
// chain costs against the two plain products (its single product,
// make_single, is gemm_single.cu). GELU is the accurate erf form of the
// Pallas bodies (vlp_tpu/ops/fused_mlp.py:_gelu; gelu.cuh's gelu_erf_h).
//
//   (LN)  ln_rows (bwd_rows.cuh):  ln = bf16(LN(x) * gamma + beta)   [M, D]
//   1. DenseEpi<true, true> (the accurate GELU; <false> without) at FS:
//                                  h = bf16(g(a @ W1 + b1))           [M, F]
//   2. DenseEpi<false> at kFc2Width: y = bf16(res + (h @ W2 + b2))    [M, D]
//
// a = ln with LN, else x; res = x for mlp_tile, none for the chain. The
// chain has no bias and its LayerNorm no affine: the caller passes fp32
// zeros as b1 and b2 and ones and zeros as gamma and beta, which leave
// z and x_hat as they are in fp32 (but for the sign of a zero), so the
// pieces are #2's own. make_mlp's splitN (:99) and rowpipe (:124) bodies
// are Mosaic interleavings of the same sums, which the card's warps do on
// their own; the port's knob is the width FS of fc1's tile over F (128, #2's
// kFc1Width, or 64), the counterpart of the script's F slices. make_chain
// launches grid = M // tm and leaves the rows past the last full tile
// unwritten (rows 24576-25087 at tm = 1024); here every row is written.
//
// What bounds it on this card: 4 * M * D * F operations (59.2 GFLOP at the
// probe's M = 25088, D = 384, F = 1536: 0.060 ms at 989 TFLOP/s) against
// the 4 * M * D bytes of x and y. The Pallas bodies keep a row tile's ln and
// h [tm, F] in VMEM; here they go through device memory, as in #2: with LN
// the launches move ~26 * M * D bytes (x twice, ln and h written and read,
// y), 0.075 ms at 3.35 TB/s, so the sequence's own floor is its bytes.
#include "mlp_fwd.cuh"

namespace {

using vlp::bf16;

// Steps 1-2 with fc1's epilogue form (the accurate GELU or none) and width
// fs (128 or 64).
cudaError_t products(bool gelu, int fs, const bf16* a, const bf16* w1,
                     const float* b1, const bf16* w2, const float* b2,
                     const bf16* res, bf16* h, bf16* y, int M, int D, int F,
                     cudaStream_t st) {
  if (gelu && fs == 128)
    return vlp::mlp_fwd_products<true, true, 128>(a, w1, b1, w2, b2, res, h,
                                                  y, M, D, F, st);
  if (gelu)
    return vlp::mlp_fwd_products<true, true, 64>(a, w1, b1, w2, b2, res, h,
                                                 y, M, D, F, st);
  if (fs == 128)
    return vlp::mlp_fwd_products<false, false, 128>(a, w1, b1, w2, b2, res,
                                                    h, y, M, D, F, st);
  return vlp::mlp_fwd_products<false, false, 64>(a, w1, b1, w2, b2, res, h,
                                                 y, M, D, F, st);
}

}  // namespace

// x, y [M, D]; w1 [D, F], w2 [F, D] bf16 ([in, out]); gamma, beta, b2 [D]
// and b1 [F] fp32. ln [M, D] (with ln only; else null) and h [M, F] bf16
// are scratch the caller allocates. tm, fs: (128, 128) or (128, 64). ln,
// gelu, residual: whether ln_rows runs (fc1 reads x without it), whether
// fc1 applies the accurate GELU, whether y adds x. D a multiple of 32 up to
// 1024 with ln, of 8 without; F a multiple of 8; 16-byte aligned bf16
// operands. Returns the first failing cudaError_t.
extern "C" int vlp_mlp_tile(const void* x, const void* gamma,
                            const void* beta, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* ln, void* h,
                            void* y, int M, int D, int F, int tm, int fs,
                            int ln_on, int gelu, int residual, float eps,
                            void* stream) {
  if (tm != vlp::wg::kBM || (fs != 64 && fs != 128) || (ln_on && !ln))
    return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const bf16* a = xb;
  if (ln_on) {
    const cudaError_t err = vlp::launch_ln_rows(
        xb, static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<bf16*>(ln), M, D, eps, st);
    if (err != cudaSuccess) return (int)err;
    a = static_cast<const bf16*>(ln);
  }
  return (int)products(gelu, fs, a, static_cast<const bf16*>(w1),
                       static_cast<const float*>(b1),
                       static_cast<const bf16*>(w2),
                       static_cast<const float*>(b2), residual ? xb : nullptr,
                       static_cast<bf16*>(h), static_cast<bf16*>(y), M, D, F,
                       st);
}
