// Backward of attn_sched, from x and dy alone, in the schedule lab's modes.
//
// Replaces the Pallas TPU probe kernel
// benchmarks/mega_variants.py:make_attn_bwd (body attn_bwd_kernel,
// :410-586): one sample per grid step recomputes LN, qkv and the softmax and
// returns all seven cotangents, the weight gradients in fp32 (:603-609).
// Modes: v0 (two passes over the heads, each with its own softmax
// recompute), stage2 (the same, each pass grouped by stage), uni (the
// softmax computed once). On an H100 every mode runs the launch sequence of
// the shipped half-block backward #3 (ln_attention.cuh) plus the recompute
// that the probe's signature forces, on one stream:
//
//   1. ln_rows:               ln  = bf16(LN(x) * gamma + beta)
//   2. wgmma DenseEpi<false>: qkv = bf16(ln @ Wqkv + bqkv), #1's qkv form
//   3. wgmma RowsNT:          do  = bf16(dy @ Wout^T), #3's form
//   4. the core, per mode:    o = bf16((bf16(p) @ v) * (1/l)), dqkv, and
//                             per-sample fp32 column sums of dqkv
//        uni     mhsa_reg_bwd.cuh's register-resident core with kOut: the
//                scores once per (sample, head), o formed from phase A's p
//        v0      pass 1 the forward core mhsa_reg_kernel in v0's order
//                with kRecip (attn_sched.cuh, o), pass 2 #3's core
//                mhsa_reg_bwd_kernel<32, KT, *, true>
//        stage2  pass 1 the forward core in stage's order with kRecip,
//                pass 2 as v0: a stage-grouped pass 2 would hold the fp32
//                scores and dp of all 13 query tiles at S = 196, two
//                buffers of 176 KB, more than a block has; so on this card
//                stage2 differs from v0 in pass 1 only
//   5-8. ln_attention.cuh's attn_bwd_tail, shared with #3: dWout = o^T dy,
//        dWqkv = ln^T dqkv (wgmma_gemm.cuh, split-K, reduced in a fixed
//        order into fp32), dln, the LN backward, the vector gradients
//
// The Pallas body's dov = bf16(do * (1/l)) rounds the fp32 do; the kernels
// stage do in bf16 (step 3, as #3 does), one bf16 rounding of do apart.
// Every sum runs in a fixed order (no atomics), so reruns are bit-identical.
// uni's o and the two-pass modes' pass-1 o run the same scores, softmax, PV
// and store (mhsa_reg.cuh's pieces), so they are equal bit for bit. Every
// mode takes the register cores' S <= 256.
//
// What bounds it on this card: 104 GFLOP at the probe's batch 128 (uni's
// products; the two-pass modes recompute QK and PV once more), 0.105 ms at
// the bf16 peak, against 61 MB that must move: operations in the ideal.
// The products run on the wgmma + TMA mainloop; the recompute, the core's
// one block per (sample, head) and the fp32 dln round trip of #3's tail
// set the time, as for #3 (a sample's qkv, o and dqkv pass through device
// memory between the launches).
#include "attn_sched.cuh"
#include "ln_attention.cuh"

namespace vlp {

enum BwdMode { kBwdV0 = 0, kBwdStage2 = 1, kBwdUni = 2 };

// The attention core of the backward in `mode` (BwdMode): o, dqkv and the
// per-sample column sums bpart [N, 3D] fp32 from qkv and do.
inline cudaError_t attn_sched_bwd_core(const bf16* qkv, const bf16* dout,
                                       bf16* o, bf16* dqkv, float* bpart,
                                       int N, int S, int D, int H,
                                       float scale, int mode,
                                       cudaStream_t st) {
  if (mode == kBwdUni)
    return launch_mhsa_reg_bwd_sums_o<32>(qkv, dout, o, dqkv, bpart, N, S, D,
                                          H, scale, IdentityRows{S}, st);
  if (mode != kBwdV0 && mode != kBwdStage2) return cudaErrorInvalidValue;
  cudaError_t err = launch_sched_core<true>(
      qkv, o, N, S, D, H, scale, mode == kBwdV0 ? kSchedV0 : kSchedStage,
      st);
  if (err != cudaSuccess) return err;
  return launch_mhsa_reg_bwd_sums<32>(qkv, dout, dqkv, bpart, N, S, D, H,
                                      scale, IdentityRows{S}, st);
}

// #3's workspace, then qkv and o.
struct SchedBwdWs {
  AttnBwdWs base;
  bf16* qkv;
  bf16* o;
  size_t bytes;

  SchedBwdWs(void* p, int N, int S, int D) : base(p, N, S, D) {
    const size_t M = (size_t)N * S;
    Carver c{p ? static_cast<char*>(p) + base.bytes : nullptr};
    qkv = c.take<bf16>(M * 3 * D);
    o = c.take<bf16>(M * D);
    bytes = base.bytes + c.used;
  }
};

}  // namespace vlp

extern "C" size_t vlp_attn_sched_bwd_workspace(int N, int S, int D, int H,
                                               int mode) {
  (void)H;
  (void)mode;
  return vlp::SchedBwdWs(nullptr, N, S, D).bytes;
}

// x, dy, dx [N, S, D] bf16; wqkv [D, 3D], wout [D, D] bf16 ([in, out]);
// gamma, beta [D], bqkv [3D] fp32. Outputs: dgamma, dbeta, dbout [D] and
// dbqkv [3D] fp32; dwqkv [D, 3D] and dwout [D, D] fp32. ws:
// vlp_attn_sched_bwd_workspace bytes. mode: 0 v0, 1 stage2, 2 uni. Returns
// the first failing cudaError_t.
extern "C" int vlp_attn_sched_bwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wout, const void* dy, void* dx,
    void* dgamma, void* dbeta, void* dwqkv, void* dbqkv, void* dwout,
    void* dbout, void* ws, int N, int S, int D, int H, float scale,
    float eps, int mode, void* stream) {
  using vlp::bf16;
  namespace wg = vlp::wg;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const vlp::SchedBwdWs w(ws, N, S, D);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* g = static_cast<const float*>(gamma);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const int M = N * S;
  cudaError_t err = vlp::launch_ln_rows(
      xb, g, static_cast<const float*>(beta), w.base.ln, M, D, eps, st);
  if (err != cudaSuccess) return (int)err;
  err = wg::launch_dense_epi<false, wg::kQkvWidth>(
      w.base.ln, wq, static_cast<const float*>(bqkv), nullptr, w.qkv, M,
      3 * D, D, st);
  if (err != cudaSuccess) return (int)err;
  // do = dy @ Wout^T
  err = wg::launch_dense<wg::RowsNT>(dyb, static_cast<const bf16*>(wout),
                                     w.base.dout, M, D, D, 1, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::attn_sched_bwd_core(w.qkv, w.base.dout, w.o, w.base.dqkv,
                                 w.base.bpart, N, S, D, H, scale, mode, st);
  if (err != cudaSuccess) return (int)err;
  return (int)vlp::attn_bwd_tail(
      xb, g, wq, w.o, dyb, w.base, static_cast<bf16*>(dx),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<float*>(dwqkv), static_cast<float*>(dbqkv),
      static_cast<float*>(dwout), static_cast<float*>(dbout), N, S, D, eps,
      st);
}

// The core's workspace in every mode: the per-sample column sums [N, 3D]
// fp32 that the path's core writes beside dqkv (head dim 32, D = 32 H).
extern "C" size_t vlp_attn_sched_bwd_core_workspace(int N, int S, int H,
                                                    int mode) {
  (void)S;
  (void)mode;
  return (size_t)N * 3 * 32 * H * sizeof(float);
}

// The backward's attention core alone, the path's own launches: qkv
// [N, S, 3D] and do [N, S, D] bf16 -> o [N, S, D] and dqkv [N, S, 3D]
// bf16. ws: vlp_attn_sched_bwd_core_workspace bytes.
extern "C" int vlp_attn_sched_bwd_core(const void* qkv, const void* dout,
                                       void* o, void* dqkv, void* ws, int N,
                                       int S, int D, int H, float scale,
                                       int mode, void* stream) {
  using vlp::bf16;
  return (int)vlp::attn_sched_bwd_core(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<bf16*>(o), static_cast<bf16*>(dqkv),
      static_cast<float*>(ws), N, S, D, H, scale, mode,
      static_cast<cudaStream_t>(stream));
}
