// The schedule modes of the probe kernels #15 (attn_sched.cu) and, for the
// first pass of #16's two-pass modes, attn_sched_bwd.cu, as orders of
// mhsa_reg.cuh's register-resident core: the counterpart of
// benchmarks/mega_variants.py:attn_fwd_kernel's modes.
//
//   o = bf16((bf16(p) @ v) / l) per (sample, head), s = (q @ k^T) * scale
//   in fp32, p = exp(s - rowmax(s)), l = sum(p); with kRecip the backward's
//   o = bf16((bf16(p) @ v) * (1 / l)) (mega_variants.py:461-463)
//
// On the TPU one grid step is one sample, and the modes reorder its 12-head
// loop so that the VPU softmax of one head overlaps the MXU products of
// another. Here each (sample, head) has its own block, as for #1, and the
// unit that a mode reorders is a warp's 16-query tile: the question stays
// whether the tensor-core products of one unit, issued beside the softmax
// of another, hide it.
//
//   v0     mhsa_reg_kernel as #1 runs it (reg::kOrderV0)
//   nosm   v0's order with the softmax replaced by p = bf16(s * 0.01), l = 1:
//          a bound, another function (mega_variants.py:354-356; kNosm)
//   pipe   the next tile's QK before this tile's PV (reg::kOrderPipe)
//   pipe2  softmax of tile t, QK of t + 1, PV of t - 1 (reg::kOrderPipe2:
//          t - 1's bf16 p parked in shared memory)
//   stage  every tile's QK and softmax, then every tile's PV
//          (reg::kOrderStage: the block's bf16 p parked in shared memory)
//
// Every order runs the same pieces on the same fragments, so v0, pipe,
// pipe2 and stage give bit-equal o, and v0 is #1's core bit for bit. Every
// mode takes S <= 256 (mhsa_reg.cuh's key tiles; stage's parked p is
// 132 KB at S = 256).
//
// What bounds it on this card: 4 * S^2 * HD FLOPs per (sample, head) on
// 8 * S * HD bytes, S / 2 = 98 FLOP/byte at S = 196, below the bf16 ridge
// (~295 FLOP/byte), so the ideal core is bound by device memory; these
// cores are bound by the warps an SM holds and their issue of the softmax
// arithmetic, which is what the orders probe.
#pragma once

#include "mhsa_reg.cuh"

namespace vlp {

enum SchedMode {
  kSchedV0 = 0,
  kSchedNosm = 1,
  kSchedPipe = 2,
  kSchedPipe2 = 3,
  kSchedStage = 4,
};

// The core in `mode` (SchedMode) at head dim 32 over N samples of S tokens;
// kRecip: the backward's o, in v0's and stage's orders only.
template <bool kRecip>
inline cudaError_t launch_sched_core(const bf16* qkv, bf16* o, int N, int S,
                                     int D, int H, float scale, int mode,
                                     cudaStream_t st) {
  const IdentityRows rows{S};
  if constexpr (kRecip) {
    if (mode == kSchedV0)
      return launch_mhsa_reg<32, reg::kOrderV0, false, true>(
          qkv, o, N, S, D, H, scale, rows, st);
    if (mode == kSchedStage)
      return launch_mhsa_reg<32, reg::kOrderStage, false, true>(
          qkv, o, N, S, D, H, scale, rows, st);
    return cudaErrorInvalidValue;
  } else {
    switch (mode) {
      case kSchedV0:
        return launch_mhsa_reg<32>(qkv, o, N, S, D, H, scale, rows, st);
      case kSchedNosm:
        return launch_mhsa_reg<32, reg::kOrderV0, true>(qkv, o, N, S, D, H,
                                                        scale, rows, st);
      case kSchedPipe:
        return launch_mhsa_reg<32, reg::kOrderPipe>(qkv, o, N, S, D, H,
                                                    scale, rows, st);
      case kSchedPipe2:
        return launch_mhsa_reg<32, reg::kOrderPipe2>(qkv, o, N, S, D, H,
                                                     scale, rows, st);
      case kSchedStage:
        return launch_mhsa_reg<32, reg::kOrderStage>(qkv, o, N, S, D, H,
                                                     scale, rows, st);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

// Shared memory of one block of the core in `mode` over S tokens: the
// staged k and v, and the parked p of pipe2 and stage (bytes; 0 for an
// unknown mode or S outside 1..256).
template <int KT = 1>
inline size_t sched_core_smem(int S, int mode) {
  if constexpr (KT < reg::kMaxTiles) {
    if ((S + 15) / 16 > KT) return sched_core_smem<KT + 1>(S, mode);
  }
  if (S <= 0 || (S + 15) / 16 > KT) return 0;
  switch (mode) {
    case kSchedV0:
    case kSchedNosm:
      return reg::mhsa_reg_smem_bytes<32, KT, IdentityRows,
                                      reg::kOrderV0>(S);
    case kSchedPipe:
      return reg::mhsa_reg_smem_bytes<32, KT, IdentityRows,
                                      reg::kOrderPipe>(S);
    case kSchedPipe2:
      return reg::mhsa_reg_smem_bytes<32, KT, IdentityRows,
                                      reg::kOrderPipe2>(S);
    case kSchedStage:
      return reg::mhsa_reg_smem_bytes<32, KT, IdentityRows,
                                      reg::kOrderStage>(S);
    default:
      return 0;
  }
}

}  // namespace vlp
