// ln_mlp: y = x + fc2(gelu(fc1(LN(x)))) over x [M, D] rows, bf16.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_block.py:_lnmlp_fwd
// (body _lnmlp_fwd_kernel), the forward of the public ln_mlp.
//
// The TPU kernel keeps a row tile's hidden activation [tm, 4D] in VMEM. Here
// the half block is two launches of the shared tiled GEMM (gemm.cuh):
//
//   1. gemm_kernel<LN, bias+GELU>:  h = bf16(gelu(LN(x) @ W1 + b1))  [M, 4D]
//   2. gemm_kernel<residual>:       y = bf16(x + h @ W2 + b2)         [M, D]
//
// LN(x) stays in shared memory; h goes through device memory (NesT-Small
// level 0 at batch 64: 200704 x 384 bf16 = 154 MB written and read once).
// GELU is the exact-erf form of the Pallas body (A&S 7.1.26); the rounding
// points are those of fused_block.py:587-604.
//
// What bounds it on this card: 16*M*D^2 FLOPs over about 22*M*D bytes (x
// read twice, h written and read, y written), 0.73*D FLOP/byte: 70 at
// D = 96, 279 at D = 384, all below the H100's bf16 ridge of ~295 FLOP/byte,
// so h's round trip is the cost a fused kernel would remove. The simple GEMM
// is latency-bound besides (see gemm.cuh); keeping h on chip and a
// wgmma/TMA pipeline are later work.
#include "gemm.cuh"

// x, y [M, D]; w1 [D, F]; w2 [F, D] (bf16, row-major, [in, out]); gamma,
// beta, b2 [D], b1 [F] (fp32). h [M, F] is scratch the caller allocates.
// Returns the first failing cudaError_t.
extern "C" int vlp_ln_mlp(const void* x, const void* gamma, const void* beta,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, void* h, void* y, int M, int D,
                          int F, float eps, void* stream) {
  using vlp::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = vlp::launch_gemm<true, vlp::kEpiBiasGelu>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), nullptr, static_cast<bf16*>(h), M, F, D,
      eps, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_gemm<false, vlp::kEpiBiasResidual>(
      static_cast<const bf16*>(h), nullptr, nullptr,
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const bf16*>(x), static_cast<bf16*>(y), M, D, F, 0.f, st);
  return (int)err;
}
