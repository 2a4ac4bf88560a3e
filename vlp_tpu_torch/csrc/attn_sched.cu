// attn_sched: y = x + OutProj(MHSA(LN(x))) over x [N, S, D], bf16, with the
// attention core in one of the schedule lab's modes.
//
// Replaces the Pallas TPU probe kernel benchmarks/mega_variants.py:make_attn
// (body attn_fwd_kernel, :331-398): one sample per grid step, its 12-head
// loop in the order of the mode (v0, nosm, pipe, pipe2, stage). On an H100
// it runs the shipped half-block forward #1's four launches
// (ln_attention.cuh's ln_attention_forward), with the core in the mode's
// order (attn_sched.cuh says how the modes map onto the card):
//
//   1. ln_rows:          ln = bf16(LN(x) * gamma + beta), in o's buffer
//   2. DenseEpi<false>:  qkv = bf16(ln @ Wqkv + bqkv)           [N*S, 3D]
//   3. mhsa_reg_kernel:  o = bf16((bf16(p) @ v) / l) in the mode's order
//   4. DenseEpi<false>:  y = bf16(x + (o @ Wout + bout))
//
// So v0 launches what #1 launches, and its y is #1's bit for bit.
//
// What bounds it on this card: the projections' 8 * M * D^2 FLOPs and the
// core's 4 * N * S^2 * D (37.1 GFLOP at the probe's batch 128, 0.038 ms at
// the bf16 peak of 989 TFLOP/s) against 40 MB of x, y and the weights
// (0.012 ms at 3.35 TB/s): operations bound in the ideal. The launches move
// ~26 M D bytes (ln, qkv and o each written and read back), 250 MB at the
// probe's M = 25,088, 0.075 ms: as for #1, qkv's round trip through device
// memory and the core's softmax issue set the time.
#include "attn_sched.cuh"
#include "ln_attention.cuh"

namespace {

// ln_attention_forward's core in the probe's mode.
struct SchedCore {
  int mode;
  cudaError_t operator()(const vlp::bf16* qkv, vlp::bf16* o, int N, int S,
                         int D, int H, float scale, vlp::IdentityRows,
                         cudaStream_t st) const {
    return vlp::launch_sched_core<false>(qkv, o, N, S, D, H, scale, mode, st);
  }
};

}  // namespace

// x, y [N, S, D]; wqkv [D, 3D]; wout [D, D] (bf16, row-major, [in, out]);
// gamma, beta, bout [D], bqkv [3D] (fp32); heads of 32, S <= 256, N <=
// 65535, 16-byte aligned bf16 operands. qkv [N, S, 3D] and o [N, S, D] are
// scratch the caller allocates. mode: SchedMode. Returns the first failing
// cudaError_t.
extern "C" int vlp_attn_sched(const void* x, const void* gamma,
                              const void* beta, const void* wqkv,
                              const void* bqkv, const void* wout,
                              const void* bout, void* qkv, void* o, void* y,
                              int N, int S, int D, int H, float scale,
                              float eps, int mode, void* stream) {
  using vlp::bf16;
  if (mode < vlp::kSchedV0 || mode > vlp::kSchedStage)
    return (int)cudaErrorInvalidValue;
  return (int)vlp::ln_attention_forward(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(wout),
      static_cast<const float*>(bout), static_cast<bf16*>(qkv),
      static_cast<bf16*>(o), static_cast<bf16*>(y), N, S, D, H, scale, eps,
      vlp::IdentityRows{S}, static_cast<cudaStream_t>(stream),
      SchedCore{mode});
}

// The core alone: qkv [N, S, 3D] -> o [N, S, D], bf16, in `mode`.
extern "C" int vlp_attn_sched_core(const void* qkv, void* o, int N, int S,
                                   int D, int H, float scale, int mode,
                                   void* stream) {
  return (int)vlp::launch_sched_core<false>(
      static_cast<const vlp::bf16*>(qkv), static_cast<vlp::bf16*>(o), N, S,
      D, H, scale, mode, static_cast<cudaStream_t>(stream));
}

// The shared memory of one block of the core in `mode` over S tokens
// (bytes; 0 for an unknown mode or S outside 1..256).
extern "C" size_t vlp_attn_sched_core_smem(int S, int mode) {
  return vlp::sched_core_smem(S, mode);
}
