// ln_attention: y = x + OutProj(MHSA(LN(x))) over x [N, S, D], bf16.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_block.py:_lnattn_fwd
// (body _lnattn_fwd_kernel), the forward of the public ln_attention.
//
// The TPU kernel keeps one sample's LN, packed qkv [S, 3D] and all heads'
// scores in VMEM. On an H100 one block has 227 KB of shared memory, and one
// NesT level-2 sample's qkv alone is 196 x 1152 bf16 = 451 KB, so the half
// block runs as three launches of hand-written kernels on one stream:
//
//   1. gemm_kernel<LN, bias>:     qkv = bf16(LN(x) @ Wqkv + bqkv)  [N*S, 3D]
//   2. mhsa_kernel:               o   = bf16((bf16(p) @ v) / l)    [N*S, D]
//                                 with s = (q @ k^T) * Dh^-0.5 in fp32,
//                                 p = exp(s - rowmax(s)), l = sum(p)
//   3. gemm_kernel<residual>:     y   = bf16(x + o @ Wout + bout)
//
// qkv and o go through device memory; LN(x) and the scores do not. The
// rounding points are those of the Pallas body (fused_block.py:313-323).
//
// What bounds it on this card: at NesT-Small's shapes (S = 196, Dh = 32)
// the attention core does 4*S^2*Dh FLOPs per (sample, head) on 8*S*Dh bytes
// of q, k, v and o, S/2 = 98 FLOP/byte, below the bf16 ridge (~295), and the
// projections stream qkv (3x the activation) through device memory, so the
// half block is bound by memory traffic first. The attention core
// (mhsa.cuh, shared with block_attention.cu) is latency-bound in its simple
// form. Fusing the three launches back into one persistent kernel (with the
// projections) is later work. The sequence lives in ln_attention.cuh, which
// the windowed forward (ln_attention_windows.cu) shares.
#include "ln_attention.cuh"

// x, y [N, S, D]; wqkv [D, 3D]; wout [D, D] (bf16, row-major, [in, out]);
// gamma, beta, bout [D], bqkv [3D] (fp32). qkv [N, S, 3D] and o [N, S, D]
// are scratch the caller allocates. Returns the first failing cudaError_t.
extern "C" int vlp_ln_attention(const void* x, const void* gamma,
                                const void* beta, const void* wqkv,
                                const void* bqkv, const void* wout,
                                const void* bout, void* qkv, void* o, void* y,
                                int N, int S, int D, int H, float scale,
                                float eps, void* stream) {
  using vlp::bf16;
  return (int)vlp::ln_attention_forward(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), static_cast<const bf16*>(wout),
      static_cast<const float*>(bout), static_cast<bf16*>(qkv),
      static_cast<bf16*>(o), static_cast<bf16*>(y), N, S, D, H, scale, eps,
      vlp::IdentityRows{S}, static_cast<cudaStream_t>(stream));
}

extern "C" const char* vlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
