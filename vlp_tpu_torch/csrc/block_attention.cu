// attend_qkv: multi-head softmax attention over a packed projection,
// qkv [N, S, 3D] bf16 (q | k | v, heads packed inside each D block) ->
// o [N, S, D] bf16, head dim 32 or 64.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/block_attention.py:_attend_fwd
// (body _fwd_kernel, :63-94), the forward of attend_qkv on the reference's
// unfused block path (ViT-B/16 and ViT-L/16: S = 197, Dh = 64; NesT with
// model.megakernel=false: S = 196, Dh = 32).
//
// The TPU kernel keeps a group of samples' [S, S] scores in VMEM, one head
// after another. Here one block per (sample, head) runs the register-resident
// core of mhsa_reg.cuh: each warp's 16 score rows stay in registers from the
// QK^T product through the softmax into the A fragments of PV, and shared
// memory holds only k and v; its rounding points are
// block_attention.py:75-85's.
//
// What bounds it on this card: 4 * N * S^2 * D FLOPs over 4 * N * S * D
// bf16 bytes read and written once (ViT-B at batch 32: 3.8 GFLOP, 38.7 MB),
// S / 2 FLOP per byte, below the bf16 ridge (~295 FLOP/byte): device memory
// bounds the ideal kernel (11.6 us at 3.35 TB/s for ViT-B). This one is
// bound by the warps an SM holds (the score rows' registers: three blocks
// of 4 warps) and the exp of every score (mhsa_reg.cuh).
#include "mhsa_reg.cuh"

// qkv [N, S, 3D] and o [N, S, D] bf16 row-major; H heads of D / H in
// {32, 64}; S <= 256. Returns the launch's cudaError_t.
extern "C" int vlp_attend_qkv(const void* qkv, void* o, int N, int S, int D,
                              int H, float scale, void* stream) {
  using vlp::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* out = static_cast<bf16*>(o);
  if (H <= 0 || D % H) return (int)cudaErrorInvalidValue;
  switch (D / H) {
    case 32:
      return (int)vlp::launch_mhsa_reg<32>(in, out, N, S, D, H, scale,
                                           vlp::IdentityRows{S}, st);
    case 64:
      return (int)vlp::launch_mhsa_reg<64>(in, out, N, S, D, H, scale,
                                           vlp::IdentityRows{S}, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
