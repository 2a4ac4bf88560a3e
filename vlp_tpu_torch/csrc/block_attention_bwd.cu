// Backward of attend_qkv: qkv [N, S, 3D] and the output's cotangent
// do [N, S, D] bf16 -> the packed dqkv [N, S, 3D] bf16, head dim 32 or 64.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/block_attention.py:_attend_bwd
// (body _bwd_kernel, :96-144), the custom VJP of attend_qkv.
//
// The TPU kernel recomputes p per (sample, head) in VMEM from qkv. Here one
// block per (sample, head) runs the register-resident core of
// mhsa_reg_bwd.cuh: phase A keeps each warp's 16 score rows in registers for
// the row statistics, dq and dov; phase B recomputes p and ds per 16 x 16
// tile with phase A's own instructions and accumulates dk and dv in
// registers, in a fixed summation order. Its rounding points are
// block_attention.py:119-144's: bf16(p) unnormalised, bf16(do / l),
// bf16(ds), dq and dk scaled in fp32, one cast each.
//
// What bounds it on this card: 8 * N * S^2 * D FLOPs (plus the phase-B
// recompute) over 7 * N * S * D bf16 bytes (qkv and do read, dqkv written:
// ViT-B at batch 32, 67.8 MB, 20.2 us at 3.35 TB/s; 7.7 GFLOP, 7.8 us at
// 989 TFLOP/s), so device memory bounds the ideal kernel. This one runs one
// block of up to 13 warps per SM (the five staged matrices) and is bound by
// its warps' latency and the exp of every score, twice (mhsa_reg_bwd.cuh).
#include "mhsa_reg_bwd.cuh"

namespace {

cudaError_t launch(const void* qkv, const void* dout, void* dqkv,
                   void* check, void* bad, int N, int S, int D, int H,
                   float scale, void* stream) {
  using vlp::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* in = static_cast<const bf16*>(qkv);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* out = static_cast<bf16*>(dqkv);
  float* chk = static_cast<float*>(check);
  unsigned* nbad = static_cast<unsigned*>(bad);
  if (H <= 0 || D % H) return cudaErrorInvalidValue;
  switch (D / H) {
    case 32:
      return vlp::launch_mhsa_reg_bwd<32>(in, d, out, chk, nbad, N, S, D, H,
                                          scale, vlp::IdentityRows{S}, st);
    case 64:
      return vlp::launch_mhsa_reg_bwd<64>(in, d, out, chk, nbad, N, S, D, H,
                                          scale, vlp::IdentityRows{S}, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv, dqkv [N, S, 3D] and dout [N, S, D] bf16 row-major; H heads of D / H
// in {32, 64}; S <= 256. Returns the launch's cudaError_t.
extern "C" int vlp_attend_qkv_bwd(const void* qkv, const void* dout,
                                  void* dqkv, int N, int S, int D, int H,
                                  float scale, void* stream) {
  return (int)launch(qkv, dout, dqkv, nullptr, nullptr, N, S, D, H, scale,
                     stream);
}

// The same launch with the kernel's recompute check (mhsa_reg_bwd.cuh):
// check [N * H, 2, 16 ceil(S / 16), 16 ceil(S / 16)] fp32 scratch, bad one
// unsigned int the caller zeroes, which receives the number of recomputed
// p and ds elements that differ from phase A's in any bit.
extern "C" int vlp_attend_qkv_bwd_checked(const void* qkv, const void* dout,
                                          void* dqkv, void* check, void* bad,
                                          int N, int S, int D, int H,
                                          float scale, void* stream) {
  return (int)launch(qkv, dout, dqkv, check, bad, N, S, D, H, scale, stream);
}
