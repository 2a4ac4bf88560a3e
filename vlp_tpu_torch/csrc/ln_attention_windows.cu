// ln_attention_windows: y = x + OutProj(MHSA(LN(x))) with attention inside
// each block x block window of a NesT token map x [B, H, W, D], bf16, run
// straight on the map: no blockify, no unblockify.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_block.py:_lnattn_nhwc_fwd
// (body _lnattn_nhwc_fwd_kernel, :928-946), the forward of the public
// ln_attention_windows (NesT with nhwc_windows=True).
//
// The TPU kernel takes one row strip (block x W tokens) per program through
// its BlockSpec index map and walks the strip's windows one after another,
// so the map never goes through a transpose. On an H100 nothing ties a
// block to a strip. The four launches of ln_attention.cu (ln_attention.cuh)
// run as they are:
//
//   1. ln_rows:                   ln  = bf16(LN(x) * gamma + beta) (in o)
//   2. DenseEpi<false>:           qkv = bf16(ln @ Wqkv + bqkv)  [B*H*W, 3D]
//   3. mhsa_reg_kernel<WindowRows>: o = attention within each window
//   4. DenseEpi<false>:           y   = bf16(x + (o @ Wout + bout))
//
// LN, the projections, the bias and the residual are row-wise, so launches
// 1, 2 and 4 run on the map's rows in storage order; qkv and o stay in the
// map's row order. Only the attention core, one block per (window, head),
// gathers a window's block^2 rows through WindowRows (attn_rows.cuh; the
// rows are worked out once per block into a table in shared memory): it
// reads one head's 64-byte slice of each row, as it does on blockified
// samples. The rounding points are those of _lnattn_fwd_kernel, and every
// row and window goes through #1's arithmetic, so y, qkv and o equal #1's
// on the blockified map bit for bit.
//
// What bounds it on this card: the work and bytes of #1 on the same tokens
// (ln_attention.cu): the launches are bound by their bytes, qkv's round
// trip most. What the window path saves is the blockify and unblockify
// copies around each level (two passes over the map per level and
// direction), not work inside the kernel.
#include "ln_attention.cuh"

// x, y [B, H, W, D]; wqkv [D, 3D]; wout [D, D] (bf16, row-major, [in, out]);
// gamma, beta, bout [D], bqkv [3D] (fp32); `heads` heads of 32; H and W
// multiples of `block`, block^2 <= 256, at most 65535 windows; 16-byte
// aligned bf16 operands. qkv [B, H, W, 3D] and o [B, H, W, D] are scratch
// the caller allocates, in the map's row order. Returns the first failing
// cudaError_t.
extern "C" int vlp_ln_attention_windows(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wout, const void* bout, void* qkv, void* o,
    void* y, int B, int H, int W, int D, int heads, int block, float scale,
    float eps, void* stream) {
  using vlp::bf16;
  if (B <= 0 || H <= 0 || W <= 0 || block <= 0 || H % block || W % block)
    return (int)cudaErrorInvalidValue;
  const int N = B * (H / block) * (W / block);
  return (int)vlp::ln_attention_forward(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(wout),
      static_cast<const float*>(bout), static_cast<bf16*>(qkv),
      static_cast<bf16*>(o), static_cast<bf16*>(y), N, block * block, D,
      heads, scale, eps, vlp::WindowRows{H, W, block},
      static_cast<cudaStream_t>(stream));
}
