// ln_mlp: y = x + fc2(gelu(fc1(LN(x)))) over x [M, D] rows, bf16.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_block.py:_lnmlp_fwd
// (body _lnmlp_fwd_kernel, :576-604), the forward of the public ln_mlp.
//
// The TPU kernel keeps a row tile's ln and hidden activation [tm, 4D] in
// VMEM. Here the half block is three launches of hand-written kernels on
// one stream (mlp_fwd.cuh):
//
//   ln_rows:                    ln = bf16(LN(x) * gamma + beta)     [M, D]
//   DenseEpi<true>:             h = bf16(gelu(ln @ W1 + b1))        [M, F]
//   DenseEpi<false>:            y = bf16(x + (h @ W2 + b2))         [M, D]
//
// The LayerNorm is the Pallas body's (fp32, two-pass variance), the same
// ln_rows pass that the backward (ln_mlp_bwd.cu) runs; GELU is the A&S erf
// form of gelu.cuh; the residual is added in fp32 before the one rounding.
//
// What bounds it on this card: 4 * M * D * F operations against ~22 * M * D
// bytes (x read twice, ln written and read, h written and read, y written):
// 0.73 * D operations a byte, 70 at D = 96 and 279 at D = 384, below the
// H100's bf16 ridge of ~295. So the bytes bound it, ln's and h's round
// trips most (mlp_fwd.cuh); both products run on the TMA + wgmma mainloop
// with their epilogues in registers. Normalising A inside the first
// product's mainloop (from per-row statistics) would drop ln's round trip;
// that is later work.
#include "mlp_fwd.cuh"

// x, y [M, D]; w1 [D, F]; w2 [F, D] (bf16, row-major, [in, out]); gamma,
// beta, b2 [D], b1 [F] (fp32). ln [M, D] and h [M, F] (bf16) are scratch
// the caller allocates. D a multiple of 32 up to 1024, F of 8; 16-byte
// aligned bf16 operands. Returns the first failing cudaError_t.
extern "C" int vlp_ln_mlp(const void* x, const void* gamma, const void* beta,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, void* ln, void* h, void* y, int M,
                          int D, int F, float eps, void* stream) {
  using vlp::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* lnb = static_cast<bf16*>(ln);
  cudaError_t err = vlp::launch_ln_rows(
      xb, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      lnb, M, D, eps, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::mlp_fwd_products(
      lnb, static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), xb,
      static_cast<bf16*>(h), static_cast<bf16*>(y), M, D, F, st);
  return (int)err;
}
