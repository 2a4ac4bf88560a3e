// attn_sched: y = x + OutProj(MHSA(LN(x))) over x [N, S, D], bf16, with the
// attention core in one of the schedule lab's modes.
//
// Replaces the Pallas TPU probe kernel benchmarks/mega_variants.py:make_attn
// (body attn_fwd_kernel, :331-398): one sample per grid step, its 12-head
// loop in the order of the mode (v0, nosm, pipe, pipe2, stage). On an H100
// the half block runs as three launches, the sequence #1 ran before its
// redesign (gemm.cuh's products, mhsa.cuh's core), with the core in the
// mode's order (attn_sched.cuh says how the modes map onto the card):
//
//   1. gemm_kernel<LN, bias>:     qkv = bf16(LN(x) @ Wqkv + bqkv)  [N*S, 3D]
//   2. mhsa_sched_kernel<mode>:   o   = bf16((bf16(p) @ v) / l)    [N*S, D]
//   3. gemm_kernel<residual>:     y   = bf16(x + o @ Wout + bout)
//
// What bounds it on this card: the projections' 8 * M * D^2 FLOPs and the
// core's 4 * N * S^2 * D (37.1 GFLOP at the probe's batch 128, 0.038 ms at
// the bf16 peak) against 40 MB of x, y and the weights (0.012 ms at
// 3.35 TB/s): operations bound in the ideal, latency-bound in this form
// (the unpipelined wmma GEMM of gemm.cuh, the core's softmax through shared
// memory).
#include "attn_sched.cuh"

// x, y [N, S, D]; wqkv [D, 3D]; wout [D, D] (bf16, row-major, [in, out]);
// gamma, beta, bout [D], bqkv [3D] (fp32). qkv [N, S, 3D] and o [N, S, D]
// are scratch the caller allocates. mode: SchedMode. Returns the first
// failing cudaError_t.
extern "C" int vlp_attn_sched(const void* x, const void* gamma,
                              const void* beta, const void* wqkv,
                              const void* bqkv, const void* wout,
                              const void* bout, void* qkv, void* o, void* y,
                              int N, int S, int D, int H, float scale,
                              float eps, int mode, void* stream) {
  using vlp::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = N * S;
  cudaError_t err = vlp::launch_gemm<true, vlp::kEpiBias>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), nullptr, static_cast<bf16*>(qkv), M,
      3 * D, D, eps, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_mhsa_sched(static_cast<const bf16*>(qkv),
                               static_cast<bf16*>(o), N, S, D, H, scale,
                               mode, false, st);
  if (err != cudaSuccess) return (int)err;
  return (int)vlp::launch_gemm<false, vlp::kEpiBiasResidual>(
      static_cast<const bf16*>(o), nullptr, nullptr,
      static_cast<const bf16*>(wout), static_cast<const float*>(bout),
      static_cast<const bf16*>(x), static_cast<bf16*>(y), M, D, D, 0.f, st);
}

// The core alone: qkv [N, S, 3D] -> o [N, S, D], bf16, in `mode`.
extern "C" int vlp_attn_sched_core(const void* qkv, void* o, int N, int S,
                                   int D, int H, float scale, int mode,
                                   void* stream) {
  return (int)vlp::launch_mhsa_sched(
      static_cast<const vlp::bf16*>(qkv), static_cast<vlp::bf16*>(o), N, S,
      D, H, scale, mode, false, static_cast<cudaStream_t>(stream));
}
