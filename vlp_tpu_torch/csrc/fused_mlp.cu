// fused_mlp: y = bf16(bf16(gelu(x @ W1 + b1)) @ W2 + b2) over x [M, D] rows,
// bf16, F = W1's width.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_mlp.py:_mlp_fwd (body
// _fwd_kernel, :70-76), the forward of fused_mlp on the reference's unfused
// block path where the MLP fits its VMEM budget (NesT-Small with
// model.megakernel=false: D = 96/192/384, F = 4D).
//
// The TPU kernel keeps a row tile's hidden activation [tm, F] in VMEM. Here
// the function is two launches of the shared tiled GEMM (gemm.cuh):
//
//   1. gemm_kernel<bias+GELU>:  h = bf16(gelu(x @ W1 + b1))   [M, F]
//   2. gemm_kernel<bias>:       y = bf16(h @ W2 + b2)         [M, D]
//
// GELU is the exact-erf form of the Pallas body (A&S 7.1.26); products
// accumulate in fp32 and round once, as fused_mlp.py:71-76 does. h goes
// through device memory (NesT-Small level 0 at batch 64: 200704 x 384 bf16,
// 154 MB written and read once), as in ln_mlp.cu.
//
// What bounds it on this card: 4 * M * D * F FLOPs over 4 * M * D bytes of
// x and y (plus the weights), F FLOP per byte: the ideal kernel is bound by
// the tensor cores at every NesT-Small level (F >= 384, above the bf16 ridge
// of ~295 FLOP per byte). The simple
// GEMM is latency-bound besides (gemm.cuh); keeping h on chip and a
// wgmma/TMA pipeline are later work.
#include "gemm.cuh"

// x, y [M, D]; w1 [D, F]; w2 [F, D] (bf16, row-major, [in, out]); b1 [F],
// b2 [D] (fp32). h [M, F] is scratch the caller allocates. Returns the
// first failing cudaError_t.
extern "C" int vlp_fused_mlp(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* h, void* y,
                             int M, int D, int F, void* stream) {
  using vlp::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = vlp::launch_gemm<false, vlp::kEpiBiasGelu>(
      static_cast<const bf16*>(x), nullptr, nullptr,
      static_cast<const bf16*>(w1), static_cast<const float*>(b1), nullptr,
      static_cast<bf16*>(h), M, F, D, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_gemm<false, vlp::kEpiBias>(
      static_cast<const bf16*>(h), nullptr, nullptr,
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), nullptr,
      static_cast<bf16*>(y), M, D, F, 0.f, st);
  return (int)err;
}
