// Backward of ln_attention, y = x + OutProj(MHSA(LN(x))), over x [N, S, D].
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_block.py:_lnattn_bwd
// (body _attn_block_bwd_rows_unified, :395-423), the custom VJP of the
// public ln_attention. Returns all seven cotangents: dx bf16, dgamma, dbeta,
// dbqkv, dbout fp32 and dWqkv, dWout fp32-accumulated and cast to bf16 once.
//
// The TPU kernel recomputes LN, qkv and the softmax per sample in VMEM and
// carries the weight gradients across its sequential grid. On an H100 the
// blocks run in parallel and a block holds 227 KB, so the backward runs as
// launches of hand-written kernels on one stream, every product a wmma GEMM
// of gemm.cuh:
//
//   1. ln_rows:           ln  = bf16(LN(x) * gamma + beta)          [M, D]
//   2. gemm NT:           do  = bf16(dy @ Wout^T)                    [M, D]
//   3. mhsa_bwd_kernel:   dqkv = bf16([dq | dk | dv]) per head      [M, 3D]
//                         and per-sample fp32 column sums of dqkv
//   4. gemm TN, split-K:  dWout = o^T @ dy        (fp32 partials)
//   5. gemm TN, split-K:  dWqkv = ln^T @ dqkv     (fp32 partials)
//   6. gemm NT:           dln = dqkv @ Wqkv^T     fp32               [M, D]
//   7. ln_bwd_rows:       dx = bf16(dy + LN_bwd(dln * gamma)), partial sums
//                         of dln * x_hat, dln, dy per 256 rows
//   8. reduce_rows:       the partials in a fixed order -> dWout, dWqkv (bf16),
//                         dgamma, dbeta, dbout, dbqkv (fp32)
//
// (M = N * S.) qkv and o are not recomputed: the forward launch already
// writes them to device memory (ln_attention.cu), and the autograd Function
// keeps them for the backward: 4 * M * D bf16, 154 MB per level-0 block of
// NesT-Small at batch 64 (39 MB at level 1, 19 MB at level 2), 1.1 GB over
// the 24 blocks. They are the bf16 values the Pallas body recomputes. The
// workspace (ln, do, dqkv, dln and the partials) is 14 * M * D bytes plus
// the partials, 270 MB at level 0, reused by every block.
//
// The attention core (step 3) is mhsa_bwd.cuh's, at head dim 32 (four
// warps, S <= 240), shared with block_attention_bwd.cu.
//
// What bounds it on this card: the projection GEMMs' 16 * M * D^2 FLOPs
// (19 GFLOP at level 0 of NesT-Small at batch 64) and the core's 8 * S^2 *
// Dh FLOPs per (sample, head) are small; the launches stream qkv, o, dy, do,
// dqkv, dln and dx through device memory (about 40 bytes per element of x
// at D = 96), so the backward is bound by memory traffic and by the
// unpipelined GEMM's latency (gemm.cuh). Fusing the LN backward into the dln
// GEMM and keeping dqkv on chip are later work.
// The sequence lives in ln_attention.cuh, which the windowed backward
// (ln_attention_windows_bwd.cu) shares.
#include "ln_attention.cuh"

extern "C" size_t vlp_ln_attention_bwd_workspace(int N, int S, int D, int H) {
  (void)H;
  return vlp::AttnBwdWs(nullptr, N, S, D).bytes;
}

// x, dy, dx [N, S, D] bf16; wqkv [D, 3D], wout [D, D] bf16 ([in, out]);
// qkv [N, S, 3D] and o [N, S, D] bf16 from the forward launch; gamma, beta
// [D] fp32. Outputs: dgamma, dbeta, dbout [D] and dbqkv [3D] fp32; dwqkv,
// dwout bf16 like the weights. ws: vlp_ln_attention_bwd_workspace bytes.
// Returns the first failing cudaError_t.
extern "C" int vlp_ln_attention_bwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* wout, const void* qkv, const void* o, const void* dy,
    void* dx, void* dgamma, void* dbeta, void* dwqkv, void* dbqkv,
    void* dwout, void* dbout, void* ws, int N, int S, int D, int H,
    float scale, float eps, void* stream) {
  using vlp::bf16;
  return (int)vlp::ln_attention_backward(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(wout), static_cast<const bf16*>(qkv),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<bf16*>(dwqkv),
      static_cast<float*>(dbqkv), static_cast<bf16*>(dwout),
      static_cast<float*>(dbout), ws, N, S, D, H, scale, eps,
      vlp::IdentityRows{S}, static_cast<cudaStream_t>(stream));
}
