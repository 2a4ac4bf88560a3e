// The schedule variants of the attention core (mhsa.cuh) for the probe
// kernels #15 (attn_sched.cu) and #16 (attn_sched_bwd.cu): the counterpart
// of benchmarks/mega_variants.py:attn_fwd_kernel's modes.
//
//   o = bf16((bf16(p) @ v) / l) per (sample, head), s = (q @ k^T) * scale
//   in fp32, p = exp(s - rowmax(s)), l = sum(p); with kRecip the backward's
//   o = bf16((bf16(p) @ v) * (1 / l)) (mega_variants.py:461-463)
//
// On the TPU one grid step is one sample, and the modes reorder its 12-head
// loop so that the VPU softmax of one head overlaps the MXU products of
// another. Here each (sample, head) has its own block (grid (H, N), 4
// warps), as in mhsa.cuh, and a warp walks the block's 16-query tiles; so
// the unit that the modes reorder is the 16-query tile within a head's
// block, and the question stays the same: do the tensor-core products of the
// next unit, issued before the softmax of the current one, hide it?
//
//   v0     tile by tile: QK -> softmax -> PV (mhsa.cuh's order)
//   nosm   v0 with the softmax replaced by p = bf16(s * 0.01), l = 1: a
//          bound, another function (mega_variants.py:354-356)
//   pipe   each warp issues the QK of its next tile into a second score
//          buffer before it runs the softmax and PV of the current one
//   pipe2  two deep, three buffers per warp: QK of tile t+1, softmax of t,
//          PV of t-1
//   stage  block-wide: every tile's QK into one [sp x lds] fp32 buffer,
//          barrier, every row's softmax, barrier, every tile's PV. The TPU
//          groups across the 12 heads; 12 heads' fp32 scores are 1.8 MB at
//          S = 196, so here the grouping is across one head's tiles.
//
// Every mode runs mhsa.cuh's steps (stage, scores, softmax, PV): each
// row's softmax is one warp's, in the same lane order, and each tile's
// products are the same wmma sums, so v0, pipe, pipe2 and stage give
// bit-equal o (v0 is the order of the half-block forwards' first core).
//
// Shared memory at HD = 32 (staged q, k, v: 3 * sp * 40 bf16; a score row
// lds = max(sp, HD) + 4 fp32), S = 196 (sp 208, lds 212): v0 and nosm
// 102 KB, pipe 155 KB, pipe2 208 KB, stage 222 KB of the 227 KB a block
// may have; so S <= 240 for v0, nosm and pipe, 224 for pipe2, 208 for
// stage (sched_smem_bytes; the launch refuses more).
//
// What bounds it on this card: as mhsa.cuh, 4 * S^2 * HD FLOPs per (sample,
// head) on 8 * S * HD bytes, below the bf16 ridge, so the ideal core is
// bound by device memory; these simple forms are bound by latency (the
// softmax through shared memory, a wmma store before every reuse), which
// is what the modes probe.
#pragma once

#include "attn_rows.cuh"
#include "gemm.cuh"
#include "mhsa.cuh"

namespace vlp {

enum SchedMode {
  kSchedV0 = 0,
  kSchedNosm = 1,
  kSchedPipe = 2,
  kSchedPipe2 = 3,
  kSchedStage = 4,
};

constexpr size_t kMaxBlockSmem = 232448;

// Score buffers per warp (stage: one block-wide buffer).
__host__ __device__ constexpr int sched_bufs(int mode) {
  return mode == kSchedPipe ? 2 : (mode == kSchedPipe2 ? 3 : 1);
}

template <int HD>
inline size_t sched_smem_bytes(int S, int mode) {
  const int sp = (S + 15) / 16 * 16;
  const size_t lds = mhsa_lds(S, HD);
  const size_t staged = 3 * (size_t)sp * (HD + 8) * sizeof(bf16);
  if (mode == kSchedStage)
    return staged + (size_t)sp * (lds + 1) * sizeof(float);
  return staged +
         (size_t)kAttnWarps * sched_bufs(mode) * 16 * (lds + 1) * sizeof(float);
}

// grid (H, N); block kAttnWarps * 32 threads. qkv [N*S, 3D] -> o [N*S, D].
template <int HD, int Mode, bool kRecip>
__global__ void __launch_bounds__(kAttnWarps * 32)
    mhsa_sched_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o,
                      int S, int D, float scale) {
  constexpr int ld = HD + 8;
  constexpr int W = kAttnWarps;
  constexpr int bufs = sched_bufs(Mode);
  constexpr bool nosm = Mode == kSchedNosm;
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int tiles = (S + 15) / 16;
  const int sp = tiles * 16;
  const int lds = mhsa_lds(S, HD);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + sp * ld;
  bf16* Vs = Ks + sp * ld;
  float* Ss = reinterpret_cast<float*>(Vs + sp * ld);
  float* Ls = Ss + (Mode == kSchedStage ? sp : W * bufs * 16) * lds;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const UnitRows<IdentityRows> row_of =
      unit_rows(IdentityRows{S}, n, S, nullptr, tid, W * 32);
  mhsa_stage<HD>(qkv, Qs, S, sp, D, h, row_of, tid, W * 32);
  __syncthreads();

  if (Mode == kSchedStage) {
    for (int qt = warp; qt < tiles; qt += W)
      mhsa_scores<HD>(Qs, Ks, qt, tiles, Ss + qt * 16 * lds, lds);
    __syncthreads();
    for (int r = warp; r < sp; r += W)
      mhsa_softmax_row<false>(Ss + r * lds, Ls + r, S, sp, scale, lane);
    __syncthreads();
    for (int qt = warp; qt < tiles; qt += W)
      mhsa_pv<HD, kRecip>(Ss + qt * 16 * lds, Ls + qt * 16, lds, Vs, qt,
                          tiles, S, o, D, h, row_of, lane);
    return;
  }

  // this warp's tiles are warp, warp + W, ...: cnt of them
  const int cnt = warp < tiles ? (tiles - warp + W - 1) / W : 0;
  float* S_w = Ss + warp * bufs * 16 * lds;
  float* L_w = Ls + warp * bufs * 16;
  auto sbuf = [&](int b) { return S_w + b * 16 * lds; };
  auto lbuf = [&](int b) { return L_w + b * 16; };
  auto tile = [&](int k) { return warp + k * W; };

  if (Mode == kSchedPipe) {
    if (cnt > 0) mhsa_scores<HD>(Qs, Ks, tile(0), tiles, sbuf(0), lds);
    for (int k = 0; k < cnt; ++k) {
      const int cur = k & 1;
      if (k + 1 < cnt)  // the next tile's products, before this softmax
        mhsa_scores<HD>(Qs, Ks, tile(k + 1), tiles, sbuf(cur ^ 1), lds);
      mhsa_softmax_tile<false>(sbuf(cur), lbuf(cur), lds, S, sp, scale,
                               lane);
      mhsa_pv<HD, kRecip>(sbuf(cur), lbuf(cur), lds, Vs, tile(k), tiles, S,
                          o, D, h, row_of, lane);
    }
  } else if (Mode == kSchedPipe2) {
    // step k: QK of tile k+1, softmax of tile k, PV of tile k-1; buffer
    // (k+1) % 3 last held tile k-2, whose PV ended at step k-1
    if (cnt > 0) mhsa_scores<HD>(Qs, Ks, tile(0), tiles, sbuf(0), lds);
    for (int k = 0; k <= cnt; ++k) {
      if (k + 1 < cnt)
        mhsa_scores<HD>(Qs, Ks, tile(k + 1), tiles, sbuf((k + 1) % 3), lds);
      if (k < cnt)
        mhsa_softmax_tile<false>(sbuf(k % 3), lbuf(k % 3), lds, S, sp,
                                 scale, lane);
      if (k >= 1)
        mhsa_pv<HD, kRecip>(sbuf((k - 1) % 3), lbuf((k - 1) % 3), lds, Vs,
                            tile(k - 1), tiles, S, o, D, h, row_of, lane);
    }
  } else {  // v0, nosm
    for (int k = 0; k < cnt; ++k) {
      mhsa_scores<HD>(Qs, Ks, tile(k), tiles, sbuf(0), lds);
      mhsa_softmax_tile<nosm>(sbuf(0), lbuf(0), lds, S, sp, scale, lane);
      mhsa_pv<HD, kRecip>(sbuf(0), lbuf(0), lds, Vs, tile(k), tiles, S, o,
                          D, h, row_of, lane);
    }
  }
}

template <int HD, int Mode, bool kRecip>
cudaError_t launch_sched_mode(const bf16* qkv, bf16* o, int N, int S, int D,
                              int H, float scale, cudaStream_t st) {
  const size_t smem = sched_smem_bytes<HD>(S, Mode);
  if (smem > kMaxBlockSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mhsa_sched_kernel<HD, Mode, kRecip>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mhsa_sched_kernel<HD, Mode, kRecip>
      <<<dim3(H, N), kAttnWarps * 32, smem, st>>>(qkv, o, S, D, scale);
  return cudaGetLastError();
}

// The core in `mode` (SchedMode) at head dim 32; `recip`: the backward's o
// (v0 and stage only).
inline cudaError_t launch_mhsa_sched(const bf16* qkv, bf16* o, int N, int S,
                                     int D, int H, float scale, int mode,
                                     bool recip, cudaStream_t st) {
  if (N <= 0 || S <= 0 || S > kMaxSeq || D != H * 32 || N > 65535)
    return cudaErrorInvalidValue;
  if (recip) {
    if (mode == kSchedV0)
      return launch_sched_mode<32, kSchedV0, true>(qkv, o, N, S, D, H, scale,
                                                   st);
    if (mode == kSchedStage)
      return launch_sched_mode<32, kSchedStage, true>(qkv, o, N, S, D, H,
                                                      scale, st);
    return cudaErrorInvalidValue;
  }
  switch (mode) {
    case kSchedV0:
      return launch_sched_mode<32, kSchedV0, false>(qkv, o, N, S, D, H,
                                                    scale, st);
    case kSchedNosm:
      return launch_sched_mode<32, kSchedNosm, false>(qkv, o, N, S, D, H,
                                                      scale, st);
    case kSchedPipe:
      return launch_sched_mode<32, kSchedPipe, false>(qkv, o, N, S, D, H,
                                                      scale, st);
    case kSchedPipe2:
      return launch_sched_mode<32, kSchedPipe2, false>(qkv, o, N, S, D, H,
                                                       scale, st);
    case kSchedStage:
      return launch_sched_mode<32, kSchedStage, false>(qkv, o, N, S, D, H,
                                                       scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vlp
