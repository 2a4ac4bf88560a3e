// Backward of attend_qkv: qkv [N, S, 3D] and the output's cotangent
// do [N, S, D] bf16 -> the packed dqkv [N, S, 3D] bf16, head dim 32 or 64.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/block_attention.py:_attend_bwd
// (body _bwd_kernel, :96-144), the custom VJP of attend_qkv.
//
// The TPU kernel recomputes p per (sample, head) in VMEM from qkv. Here the
// kernel is the attention-core backward of the half-block backward
// (mhsa_bwd.cuh), launched on its own without the column sums and templated
// on the head dim: p recomputed from qkv in shared memory, the row
// statistics kept there, dq from query tiles and dk, dv from key tiles with
// the 16x16 score tiles recomputed, in a fixed summation order. Its
// rounding points are block_attention.py:119-144's: bf16(p) unnormalised,
// bf16(do / l), bf16(ds), dq and dk scaled in fp32, one cast each.
//
// What bounds it on this card: 8 * N * S^2 * D FLOPs (plus the phase-B
// recompute) over 7 * N * S * D bf16 bytes (qkv and do read, dqkv written:
// ViT-B at batch 32, 67.8 MB, 20.2 us at 3.35 TB/s; 7.7 GFLOP, 7.8 us at
// 989 TFLOP/s), so device memory bounds the ideal kernel. At Dh = 64 the
// staged q, k, v, do and do / l leave room for two warps per block and one
// block per SM (mhsa_bwd.cuh), so this form is latency-bound.
#include "mhsa_bwd.cuh"

// qkv, dqkv [N, S, 3D] and dout [N, S, D] bf16 row-major; H heads of D / H
// in {32, 64}; S <= 240 (Dh 32) or 224 (Dh 64). Returns the launch's
// cudaError_t.
extern "C" int vlp_attend_qkv_bwd(const void* qkv, const void* dout,
                                  void* dqkv, int N, int S, int D, int H,
                                  float scale, void* stream) {
  using vlp::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* in = static_cast<const bf16*>(qkv);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* out = static_cast<bf16*>(dqkv);
  if (H <= 0 || D % H) return (int)cudaErrorInvalidValue;
  switch (D / H) {
    case 32:
      return (int)vlp::launch_mhsa_bwd<32>(in, d, out, nullptr, N, S, D, H,
                                           scale, vlp::IdentityRows{S}, st);
    case 64:
      return (int)vlp::launch_mhsa_bwd<64>(in, d, out, nullptr, N, S, D, H,
                                           scale, vlp::IdentityRows{S}, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
