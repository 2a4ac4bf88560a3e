// fused_mlp: y = bf16(bf16(gelu(x @ W1 + b1)) @ W2 + b2) over x [M, D] rows,
// bf16, F = W1's width.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_mlp.py:_mlp_fwd (body
// _fwd_kernel, :70-76), the forward of fused_mlp on the reference's unfused
// block path where the MLP fits its VMEM budget (NesT-Small with
// model.megakernel=false: D = 96/192/384, F = 4D).
//
// The TPU kernel keeps a row tile's hidden activation [tm, F] in VMEM. Here
// the function is two launches of hand-written kernels on one stream
// (mlp_fwd.cuh, shared with ln_mlp.cu):
//
//   DenseEpi<true>:   h = bf16(gelu(x @ W1 + b1))   [M, F]
//   DenseEpi<false>:  y = bf16(h @ W2 + b2)         [M, D]
//
// GELU is the A&S erf form of gelu.cuh; products accumulate in fp32 and
// round once, as fused_mlp.py:71-76 does.
//
// What bounds it on this card: 4 * M * D * F operations against the bytes
// of x, h (written and read) and y, ~2 * M * (2 D + 2 F) = 20 * M * D at F
// = 4D: 0.8 * D operations a byte, 77 at D = 96 and 307 at D = 384, about
// the H100's bf16 ridge of ~295 at the deepest level. So levels 0 and 1
// are bound by bytes, h's round trip most, and level 2 by both about
// equally; both products run on the TMA + wgmma mainloop with their
// epilogues in registers (mlp_fwd.cuh). Keeping h on chip is later work.
#include "mlp_fwd.cuh"

// x, y [M, D]; w1 [D, F]; w2 [F, D] (bf16, row-major, [in, out]); b1 [F],
// b2 [D] (fp32). h [M, F] is scratch the caller allocates. D and F
// multiples of 8, 16-byte aligned bf16 operands. Returns the first failing
// cudaError_t.
extern "C" int vlp_fused_mlp(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* h, void* y,
                             int M, int D, int F, void* stream) {
  using vlp::bf16;
  return (int)vlp::mlp_fwd_products(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), nullptr, static_cast<bf16*>(h),
      static_cast<bf16*>(y), M, D, F, static_cast<cudaStream_t>(stream));
}

// One product of the forwards by itself, as mlp_fwd_products launches it,
// for checks against plain products: out = bf16(gelu(a @ w + bias)) where
// gelu is nonzero (fc1), else bf16(a @ w + bias), plus res in fp32 where
// res is not null (fc2). a [M, K], w [K, N], res and out [M, N] bf16, bias
// [N] fp32. Returns the launch's cudaError_t.
extern "C" int vlp_mlp_gemm(const void* a, const void* w, const void* bias,
                            const void* res, void* out, int M, int N, int K,
                            int gelu, void* stream) {
  using vlp::bf16;
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* wb = static_cast<const bf16*>(w);
  const float* bb = static_cast<const float*>(bias);
  bf16* ob = static_cast<bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gelu)
    return (int)vlp::wg::launch_dense_epi<true, vlp::wg::kFc1Width>(
        ab, wb, bb, nullptr, ob, M, N, K, st);
  return (int)vlp::wg::launch_dense_epi<false, vlp::wg::kFc2Width>(
      ab, wb, bb, static_cast<const bf16*>(res), ob, M, N, K, st);
}
