// The launch sequences of the half-block attention, forward and backward,
// shared by ln_attention.cu / ln_attention_bwd.cu (#1, #3: N samples of S
// tokens, [N, S, D]) and ln_attention_windows.cu /
// ln_attention_windows_bwd.cu (#5, #6: the N block x block windows of a NesT
// token map [B, H, W, D], S = block^2); the forward also by the probe #15
// with its core in the order of its mode (attn_sched.cu), the backward's
// tail after the attention core by the probe #16 (attn_sched_bwd.cu). Both
// directions run bwd_rows.cuh's LayerNorm rows, the register-resident
// attention cores (mhsa_reg.cuh forward, mhsa_reg_bwd.cuh backward with its
// per-unit column sums) and their products on wgmma_gemm.cuh's TMA + wgmma
// mainloop (dense_epi.cuh's DenseEpi forward, RowsNT and ColsTN backward).
//
// LayerNorm, the projections, the biases, the residual and the LayerNorm
// backward act on each row alone, so their kernels run over the M = N * S
// rows in storage order whatever the layout; only the attention cores learn,
// through a row map (attn_rows.cuh), which rows make up unit n. Each row and
// each unit therefore goes through the same arithmetic in both layouts: y
// and dx of a window equal, bit for bit, those of the same tokens
// blockified, and so do the per-unit column sums behind dbqkv (reduced in
// unit order, which for windows is blockify order). The sums over rows (the
// split-K weight gradients, the 256-row partials of dgamma, dbeta and dbout)
// run in storage order, so for windows they add the same terms in another
// fp32 order. A product's sum for one row runs the same K steps in the same
// order whatever tile the row lands in, so the per-row results (y, qkv, dx)
// stay position-independent.
#pragma once

#include "bwd_rows.cuh"
#include "dense_epi.cuh"
#include "mhsa_reg.cuh"
#include "mhsa_reg_bwd.cuh"
#include "wgmma_gemm.cuh"

namespace vlp {

namespace wg {

// The forward's tile widths, measured at NesT-Small's levels
// (scripts/mlp_fwd_widths.py, forms qkv and out_res): the out-projection
// with the residual (N = D, K = D) is fastest at 64 where most of a step's
// calls run (levels 1 and 2); the qkv product (N = 3D, K = D) runs within
// 2% at 64 and 128 at every level, so it shares the 64-wide instance with
// the out-projection and the MLP's fc2 rather than add one of its own.
constexpr int kQkvWidth = 64, kOutWidth = 64;

}  // namespace wg

// The attention core of #1 and #5: mhsa_reg.cuh's in v0's order. A core
// launches o from qkv for N units of S tokens (D = 32 H) on the stream.
struct RegCore {
  template <class Rows>
  cudaError_t operator()(const bf16* qkv, bf16* o, int N, int S, int D,
                         int H, float scale, Rows rows,
                         cudaStream_t st) const {
    return launch_mhsa_reg<32>(qkv, o, N, S, D, H, scale, rows, st);
  }
};

// The forward, four launches on one stream (ln_attention.cu lists them):
// ln = bf16(LN(x) * gamma + beta), written into o's buffer (the qkv product
// reads it before the core writes o); qkv = bf16(ln @ Wqkv + bqkv); o = the
// attention core per unit (#1's and #5's RegCore; the probe #15 passes its
// mode's order, attn_sched.cu); y = bf16(x + (o @ Wout + bout)). Returns
// the first failing cudaError_t.
template <class Rows, class Core = RegCore>
cudaError_t ln_attention_forward(const bf16* x, const float* gamma,
                                 const float* beta, const bf16* wqkv,
                                 const float* bqkv, const bf16* wout,
                                 const float* bout, bf16* qkv, bf16* o,
                                 bf16* y, int N, int S, int D, int H,
                                 float scale, float eps, Rows rows,
                                 cudaStream_t st, Core core = {}) {
  const int M = N * S;
  cudaError_t err = launch_ln_rows(x, gamma, beta, o, M, D, eps, st);
  if (err != cudaSuccess) return err;
  err = wg::launch_dense_epi<false, wg::kQkvWidth>(o, wqkv, bqkv, nullptr,
                                                   qkv, M, 3 * D, D, st);
  if (err != cudaSuccess) return err;
  err = core(qkv, o, N, S, D, H, scale, rows, st);
  if (err != cudaSuccess) return err;
  return wg::launch_dense_epi<false, wg::kOutWidth>(o, wout, bout, x, y, M, D,
                                                    D, st);
}

// Workspace pieces of the backward, in one order for the size query and the
// launch.
struct AttnBwdWs {
  bf16* ln;
  bf16* dout;
  bf16* dqkv;
  float* dln;
  float* bpart;   // [N, 3D]
  float* wpart;   // [s_qkv, D, 3D] or [s_out, D, D], whichever is larger
  float* rpart;   // [row blocks, 3, D]
  int s_out, s_qkv;
  size_t bytes;

  AttnBwdWs(void* base, int N, int S, int D) {
    const int M = N * S;
    s_out = wg::split_count(D, D, M);
    s_qkv = wg::split_count(D, 3 * D, M);
    const size_t wp = (size_t)D * D *
                      (s_out > 3 * s_qkv ? s_out : 3 * (size_t)s_qkv);
    Carver c{static_cast<char*>(base)};
    ln = c.take<bf16>((size_t)M * D);
    dout = c.take<bf16>((size_t)M * D);
    dqkv = c.take<bf16>((size_t)M * 3 * D);
    dln = c.take<float>((size_t)M * D);
    bpart = c.take<float>((size_t)N * 3 * D);
    wpart = c.take<float>(wp);
    rpart = c.take<float>((size_t)ln_bwd_row_blocks(M) * 3 * D);
    bytes = c.used;
  }
};

// The backward's launches after the attention core (ln_attention_bwd.cu
// lists them, steps 4-8): dWout and dWqkv (split-K partials reduced in a
// fixed order into WT: bf16 like the weights for #3 and #6, fp32 for the
// probe #16), dln, the LN backward and the vector gradients, from x, dy, o
// and the workspace's ln, dqkv and per-unit column sums.
template <class WT>
cudaError_t attn_bwd_tail(const bf16* x, const float* gamma, const bf16* wqkv,
                          const bf16* o, const bf16* dy, const AttnBwdWs& w,
                          bf16* dx, float* dgamma, float* dbeta, WT* dwqkv,
                          float* dbqkv, WT* dwout, float* dbout, int N, int S,
                          int D, float eps, cudaStream_t st) {
  const int M = N * S;
  // dWout = o^T @ dy
  cudaError_t err =
      wg::launch_dense<wg::ColsTN>(o, dy, w.wpart, D, D, M, w.s_out, st);
  if (err != cudaSuccess) return err;
  err = launch_reduce_rows(w.wpart, dwout, w.s_out, (size_t)D * D,
                           (size_t)D * D, st);
  if (err != cudaSuccess) return err;
  // dWqkv = ln^T @ dqkv
  err = wg::launch_dense<wg::ColsTN>(w.ln, w.dqkv, w.wpart, D, 3 * D, M,
                                     w.s_qkv, st);
  if (err != cudaSuccess) return err;
  err = launch_reduce_rows(w.wpart, dwqkv, w.s_qkv, (size_t)D * 3 * D,
                           (size_t)D * 3 * D, st);
  if (err != cudaSuccess) return err;
  // dln = dqkv @ Wqkv^T
  err = wg::launch_dense<wg::RowsNT>(w.dqkv, wqkv, w.dln, M, D, 3 * D, 1, st);
  if (err != cudaSuccess) return err;
  err = launch_ln_bwd_rows(x, gamma, w.dln, dy, dx, w.rpart, M, D, eps, st);
  if (err != cudaSuccess) return err;
  const int rb = ln_bwd_row_blocks(M);
  float* outs[3] = {dgamma, dbeta, dbout};
  for (int k = 0; k < 3; ++k) {
    err = launch_reduce_rows(w.rpart + (size_t)k * D, outs[k], rb,
                             (size_t)3 * D, (size_t)D, st);
    if (err != cudaSuccess) return err;
  }
  return launch_reduce_rows(w.bpart, dbqkv, N, (size_t)3 * D, (size_t)3 * D,
                            st);
}

// The backward's launches (ln_attention_bwd.cu lists them): all seven
// cotangents from x, dy and the forward launch's qkv and o.
template <class Rows>
cudaError_t ln_attention_backward(
    const bf16* x, const float* gamma, const float* beta, const bf16* wqkv,
    const bf16* wout, const bf16* qkv, const bf16* o, const bf16* dy,
    bf16* dx, float* dgamma, float* dbeta, bf16* dwqkv, float* dbqkv,
    bf16* dwout, float* dbout, void* ws, int N, int S, int D, int H,
    float scale, float eps, Rows rows, cudaStream_t st) {
  const int M = N * S;
  const AttnBwdWs w(ws, N, S, D);
  cudaError_t err = launch_ln_rows(x, gamma, beta, w.ln, M, D, eps, st);
  if (err != cudaSuccess) return err;
  // do = dy @ Wout^T
  err = wg::launch_dense<wg::RowsNT>(dy, wout, w.dout, M, D, D, 1, st);
  if (err != cudaSuccess) return err;
  err = launch_mhsa_reg_bwd_sums<32>(qkv, w.dout, w.dqkv, w.bpart, N, S, D, H,
                                     scale, rows, st);
  if (err != cudaSuccess) return err;
  return attn_bwd_tail(x, gamma, wqkv, o, dy, w, dx, dgamma, dbeta, dwqkv,
                       dbqkv, dwout, dbout, N, S, D, eps, st);
}

}  // namespace vlp
