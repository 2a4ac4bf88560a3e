// ln_attention: y = x + OutProj(MHSA(LN(x))) over x [N, S, D], bf16.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_block.py:_lnattn_fwd
// (body _lnattn_fwd_kernel), the forward of the public ln_attention.
//
// The TPU kernel keeps one sample's LN, packed qkv [S, 3D] and all heads'
// scores in VMEM. On an H100 one block has 227 KB of shared memory, and one
// NesT level-2 sample's qkv alone is 196 x 1152 bf16 = 451 KB, so the half
// block runs as four launches of hand-written kernels on one stream
// (ln_attention.cuh):
//
//   1. ln_rows (bwd_rows.cuh):  ln  = bf16(LN(x) * gamma + beta)  [N*S, D]
//                               (in o's buffer)
//   2. DenseEpi<false>:         qkv = bf16(ln @ Wqkv + bqkv)      [N*S, 3D]
//   3. mhsa_reg_kernel:         o   = bf16((bf16(p) @ v) / l)     [N*S, D]
//                               with s = (q @ k^T) * Dh^-0.5 in fp32,
//                               p = exp(s - rowmax(s)), l = sum(p)
//   4. DenseEpi<false>:         y   = bf16(x + (o @ Wout + bout))
//
// The rounding points are those of the Pallas body (fused_block.py:
// 313-323): LN in fp32 (two-pass variance, eps 1e-6) rounded once, the
// products accumulated in fp32 with the bias added before one rounding,
// s * scale and s - max rounded separately, bf16(p) for PV, then / l, and
// the residual added in fp32 before the last rounding. ln is the pass the
// backward (ln_attention_bwd.cu) recomputes, bit for bit; the core is #7's
// (block_attention.cu), so o equals attend_qkv on the same qkv.
//
// What bounds it on this card: at NesT-Small's level 2 at batch 64 (M =
// 12,544, D = 384, S = 196) a call does 8 M D^2 + 4 M S D = 18.6 GFLOP
// (0.019 ms at 989 TFLOP/s), and its launches move ~26 M D bytes (x read
// twice, ln and o each written and read, qkv written and read, y written):
// 125 MB, 0.037 ms at 3.35 TB/s; at level 0 (M = 200,704, D = 96) 500 MB
// against 29.9 GFLOP. So the four launches are bound by their bytes, qkv's
// round trip most; the products run on the TMA + wgmma mainloop with their
// epilogues in registers, and the core keeps its score rows in registers
// (mhsa_reg.cuh). Keeping ln and qkv on chip would need one persistent
// kernel with the projections; that is later work. The sequence is shared
// with the windowed forward (ln_attention_windows.cu).
#include "ln_attention.cuh"

// x, y [N, S, D]; wqkv [D, 3D]; wout [D, D] (bf16, row-major, [in, out]);
// gamma, beta, bout [D], bqkv [3D] (fp32); heads of 32, S <= 256, N <=
// 65535, 16-byte aligned bf16 operands. qkv [N, S, 3D] and o [N, S, D] are
// scratch the caller allocates. Returns the first failing cudaError_t.
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
