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
// launches of hand-written kernels on one stream:
//
//   1. ln_rows:             ln  = bf16(LN(x) * gamma + beta)        [M, D]
//   2. wgmma RowsNT:        do  = bf16(dy @ Wout^T)                  [M, D]
//   3. mhsa_reg_bwd_kernel: dqkv = bf16([dq | dk | dv]) per head    [M, 3D]
//                           and per-sample fp32 column sums of dqkv
//   4. wgmma ColsTN, split-K: dWout = o^T @ dy      (fp32 partials)
//   5. wgmma ColsTN, split-K: dWqkv = ln^T @ dqkv   (fp32 partials)
//   6. wgmma RowsNT:        dln = dqkv @ Wqkv^T  fp32               [M, D]
//   7. ln_bwd_rows:         dx = bf16(dy + LN_bwd(dln * gamma)), partial
//                           sums of dln * x_hat, dln, dy per 256 rows
//   8. reduce_rows:         the partials in a fixed order -> dWout, dWqkv
//                           (bf16), dgamma, dbeta, dbout, dbqkv (fp32)
//
// (M = N * S.) qkv and o are not recomputed: the forward launch already
// writes them to device memory (ln_attention.cu), and the autograd Function
// keeps them for the backward: 4 * M * D bf16, 154 MB per level-0 block of
// NesT-Small at batch 64 (39 MB at level 1, 19 MB at level 2), 1.1 GB over
// the 24 blocks. They are the bf16 values the Pallas body recomputes. The
// workspace (ln, do, dqkv, dln and the partials) is 14 * M * D bytes plus
// the partials, 270 MB at level 0, reused by every block.
//
// The attention core (step 3) is mhsa_reg_bwd.cuh's register-resident
// backward at head dim 32 (S <= 256), shared with block_attention_bwd.cu,
// with its per-unit column sums switched on. The four products (steps 2
// and 4-6) run on wgmma_gemm.cuh's TMA + wgmma mainloop, 128 x 128 tiles
// (N = 96 and 288 fill part of a tile; TMA zero-fills the rest): the
// weights read K-major as they lie, o and ln M-major through wgmma's
// transpose bit, and the weight gradients split over the rows so that
// about two blocks an SM run (wgmma_gemm.cuh:split_count). Each launch
// encodes its two tensor maps on the host, eight per call.
//
// What bounds it on this card: the products' 16 * M * D^2 FLOPs (29.6
// GFLOP at every level of NesT-Small at batch 64, where M * D^2 is the
// same: 0.030 ms at 989 TFLOP/s) and the core's 8 * S^2 * Dh FLOPs per
// (sample, head) are small; the launches stream qkv, o, dy, do, dqkv, dln
// and dx through device memory (about 40 bytes per element of x, ~0.8 GB
// a call), so the backward is bound by memory traffic. With the products
// on wgmma the core (one block per SM, mhsa_reg_bwd.cuh) and the row
// passes (ln_rows, ln_bwd_rows, the fp32 dln round trip) set the time.
// Fusing the LN backward into the dln product and keeping dqkv on chip are
// later work.
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

// The sequence's products by themselves, for checks against a plain
// product: form 0, RowsNT, out [M, N] = a [M, K] @ b [N, K]^T (do to bf16,
// fp32 0; dln to fp32, fp32 1); form 1, ColsTN, the fp32 split-K partials
// out [splits, M, N] of a [K, M]^T @ b [K, N] (dWout, dWqkv). bf16
// operands as in wgmma_gemm.cuh:launch_dense. Returns the launch's
// cudaError_t.
extern "C" int vlp_attn_bwd_gemm(const void* a, const void* b, void* out,
                                 int M, int N, int K, int form, int fp32,
                                 int splits, void* stream) {
  namespace wg = vlp::wg;
  const auto* pa = static_cast<const wg::bf16*>(a);
  const auto* pb = static_cast<const wg::bf16*>(b);
  const auto st = static_cast<cudaStream_t>(stream);
  if (form == 0 && fp32 == 0)
    return (int)wg::launch_dense<wg::RowsNT>(
        pa, pb, static_cast<wg::bf16*>(out), M, N, K, splits, st);
  if (form == 0)
    return (int)wg::launch_dense<wg::RowsNT>(pa, pb, static_cast<float*>(out),
                                             M, N, K, splits, st);
  if (form == 1 && fp32 != 0)
    return (int)wg::launch_dense<wg::ColsTN>(pa, pb, static_cast<float*>(out),
                                             M, N, K, splits, st);
  return (int)cudaErrorInvalidValue;
}

// The split count the sequence gives a weight-gradient product [M, N] over
// K rows (wgmma_gemm.cuh:split_count).
extern "C" int vlp_attn_bwd_splits(int M, int N, int K) {
  return vlp::wg::split_count(M, N, K);
}
