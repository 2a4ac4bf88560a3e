// Backward of ln_attention_windows, the NesT half-block attention within the
// block x block windows of a token map x [B, H, W, D], straight on the map.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_block.py:_lnattn_nhwc_bwd
// (body _lnattn_nhwc_bwd_kernel, :949-976, which runs
// _attn_block_bwd_rows_unified per window), the custom VJP of the public
// ln_attention_windows. Returns all seven cotangents: dx bf16 [B, H, W, D],
// dgamma, dbeta, dbqkv, dbout fp32 and dWqkv, dWout fp32-accumulated and
// cast to bf16 once.
//
// The TPU kernel walks the row strips in order and carries the weight
// gradients across its sequential grid. Here the launches of
// ln_attention_bwd.cu (ln_attention.cuh) run as they are on the map's rows
// in storage order (LN rows, the do product, the split-K weight-gradient
// products, the dln product, the LN-backward rows, the fixed-order
// reductions: all row-wise or sums over rows, the products on
// wgmma_gemm.cuh), and the register-resident attention-core backward
// mhsa_reg_bwd_kernel<32, KT, WindowRows, true> gathers each window's
// block^2 rows of qkv and do and scatters its dqkv rows back
// (attn_rows.cuh). qkv and o come from the forward launch, in the map's row
// order.
//
// Sums and their order: dx goes through #3's arithmetic row by row and
// window by window (a product's sum for one row runs the same K order in
// whatever tile the row lands), so it equals #3 on the blockified map bit
// for bit. The per-window column sums behind dbqkv (per 16-row tile, then
// over the tiles in order) come in window order, which is blockify order,
// so dbqkv does too. The split-K weight gradients and the 256-row partials
// of dgamma, dbeta and dbout sum the same rows in the map's order instead
// of blockify order: the same terms in another fp32 order. No float
// atomics: reruns are bit-identical.
//
// What bounds it on this card: the work and bytes of #3 on the same tokens
// (ln_attention_bwd.cu): memory traffic, with the core (one block per SM)
// and the row passes setting the time. block^2 <= 256 (the core's 16 key
// tiles).
#include "ln_attention.cuh"

// x, dy, dx [B, H, W, D] bf16; wqkv [D, 3D], wout [D, D] bf16 ([in, out]);
// qkv [B, H, W, 3D] and o [B, H, W, D] bf16 from the forward launch; gamma,
// beta [D] fp32. Outputs: dgamma, dbeta, dbout [D] and dbqkv [3D] fp32;
// dwqkv, dwout bf16 like the weights. ws: vlp_ln_attention_bwd_workspace
// bytes for N = B * (H / block) * (W / block) windows of S = block^2 tokens.
// Returns the first failing cudaError_t.
extern "C" int vlp_ln_attention_windows_bwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* wout, const void* qkv, const void* o, const void* dy,
    void* dx, void* dgamma, void* dbeta, void* dwqkv, void* dbqkv,
    void* dwout, void* dbout, void* ws, int B, int H, int W, int D,
    int heads, int block, float scale, float eps, void* stream) {
  using vlp::bf16;
  if (B <= 0 || H <= 0 || W <= 0 || block <= 0 || H % block || W % block)
    return (int)cudaErrorInvalidValue;
  const int N = B * (H / block) * (W / block);
  return (int)vlp::ln_attention_backward(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(wout), static_cast<const bf16*>(qkv),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dy),
      static_cast<bf16*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<bf16*>(dwqkv),
      static_cast<float*>(dbqkv), static_cast<bf16*>(dwout),
      static_cast<float*>(dbout), ws, N, block * block, D, heads, scale, eps,
      vlp::WindowRows{H, W, block}, static_cast<cudaStream_t>(stream));
}
