// The MLP tile engine's entry point (mlp_tile.cuh), one launch per call:
//
//   mlp_tile:   y = bf16(x + (h @ W2 + b2)), h = bf16(gelu(bf16(LN(x) *
//               gamma + beta) @ W1 + b1)), h kept on chip, and its two
//               ablations: GELU -> identity and LN -> identity (ln = x)
//   mlp_chain:  y = bf16(bf16(g(x' @ W1)) @ W2), x' = bf16(x_hat) (LayerNorm
//               without affine) with "ln", else x; g = GELU with "gelu",
//               else identity; no bias, no residual
//   mlp_single: z = bf16(x @ W1) [M, F]
//
// Replaces the Pallas TPU kernels benchmarks/mega_variants.py:make_mlp with
// the body mlp_fwd_kernel_v0 (:83, with its gelu and ln flags), the
// schedule probe of the half block's MLP, and benchmarks/mlp_probe.py:
// make_chain (body chain_kernel, :58) and make_single (body
// single_mm_kernel, :86), the probe of what the MLP's matmul chain costs
// against the two plain products. make_mlp's splitN (:99) and rowpipe
// (:124) bodies are Mosaic interleavings of the same sums, which warps do on
// their own here, so the port's knobs are the row tile TM and the F slice FS
// (mlp_tile.cuh, "Design"). The shipped forward #2 (ln_mlp.cu) computes
// mlp_tile's function in two launches with h [M, F] in device memory; the
// probe times both. make_chain launches grid = M // tm and leaves the rows
// past the last full tile unwritten (rows 24576-25087 at tm = 1024); here
// every row is written.
//
// What bounds it on this card: see mlp_tile.cuh (the tensor cores; the
// weights' L2 traffic M / TM times 2.36 MB at the probe's shape). The single
// product does 2 * M * D * F operations (0.030 ms at the probe's shape)
// against 2 * M * (D + F) bytes of x and z (0.029 ms): both limits are about
// equal, and the weights' L2 traffic (2 * D * F bytes per block) comes on
// top.
#include "mlp_tile.cuh"

// x [M, D] bf16; w1 [D, F], w2 [F, D] bf16 ([in, out]); gamma, beta, b2 [D]
// and b1 [F] fp32; out [M, D] with second, else [M, F]. gamma and beta null
// make the LayerNorm affine-free (x_hat rounded once). tm, fs: one of
// (64, 64), (64, 128), (32, 64), (32, 128). (ln, gelu, bias, second):
// (1, 1, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1) for mlp_tile and its ablations;
// (0, 0, 0, 1), (0, 1, 0, 1), (1, 1, 0, 1) for the chain's stages (),
// ("gelu",), ("ln", "gelu"); (0, 0, 0, 0) for the single product. Returns
// the launch's cudaError_t.
extern "C" int vlp_mlp_tile(const void* x, const void* gamma,
                            const void* beta, const void* w1, const void* b1,
                            const void* w2, const void* b2, void* out, int M,
                            int D, int F, int tm, int fs, int ln, int gelu,
                            int bias, int second, float eps, void* stream) {
  using vlp::bf16;
  namespace mt = vlp::mlpt;
  const mt::TileArgs a{static_cast<const bf16*>(x),
                       static_cast<const float*>(gamma),
                       static_cast<const float*>(beta),
                       static_cast<const bf16*>(w1),
                       static_cast<const float*>(b1),
                       static_cast<const bf16*>(w2),
                       static_cast<const float*>(b2),
                       static_cast<bf16*>(out),
                       M,
                       D,
                       F,
                       eps,
                       static_cast<cudaStream_t>(stream)};
  if (!second)
    return (ln || gelu || bias)
               ? (int)cudaErrorInvalidValue
               : (int)mt::launch_mlp_tile_at<false, false, false, false>(
                     a, tm, fs);
  if (bias) {
    if (ln && gelu)
      return (int)mt::launch_mlp_tile_at<true, true, true, true>(a, tm, fs);
    if (ln)
      return (int)mt::launch_mlp_tile_at<true, false, true, true>(a, tm, fs);
    if (gelu)
      return (int)mt::launch_mlp_tile_at<false, true, true, true>(a, tm, fs);
    return (int)cudaErrorInvalidValue;
  }
  if (ln && gelu)
    return (int)mt::launch_mlp_tile_at<true, true, false, true>(a, tm, fs);
  if (gelu)
    return (int)mt::launch_mlp_tile_at<false, true, false, true>(a, tm, fs);
  if (!ln)
    return (int)mt::launch_mlp_tile_at<false, false, false, true>(a, tm, fs);
  return (int)cudaErrorInvalidValue;
}
