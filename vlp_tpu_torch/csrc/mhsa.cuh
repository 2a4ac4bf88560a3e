// The pieces of the port's first attention core, which the half-block
// forwards #1 and #5 ran before they moved to mhsa_reg.cuh's register core:
// the schedule variants of the probe kernels #15 (attn_sched.cuh) order
// them, and no model path launches them.
//
//   o = bf16((bf16(p) @ v) / l) per (sample, head), with s = (q @ k^T) *
//   scale in fp32, p = exp(s - rowmax(s)), l = sum(p)
//
// over a packed qkv [N, S, 3D] bf16 (q | k | v, heads packed inside each D
// block) into o [N, S, D] bf16. The rounding points are those of the Pallas
// bodies (vlp_tpu/ops/block_attention.py:75-85, fused_block.py:313-323). A
// row map (attn_rows.cuh) says which rows of qkv and o make up unit n.
//
// One block per (sample, head) stages q, k and v in shared memory (rows
// S..sp-1 zero, sp = S rounded up to 16), and each of its 4 warps takes
// 16-query tiles: the 16 x S fp32 score rows with wmma, the softmax from
// shared memory, P (bf16, unnormalised) written over its own score row, and
// P @ V with wmma. HD (the head dim) is a template parameter; its users run
// HD = 32. S <= 256 (8 keys per lane).
//
// What bounds it on this card: 4 * S^2 * HD FLOPs per (sample, head) on
// 8 * S * HD bytes of q, k, v and o, S / 2 = 98 FLOP/byte at S = 196, below
// the bf16 ridge (~295 FLOP/byte), so the ideal kernel is bound by device
// memory; this simple form is latency-bound instead (one pass per tile,
// the softmax through shared memory, no overlap of the staging with the
// products), which is what the probe's schedules vary.
#pragma once

#include "attn_rows.cuh"
#include "gemm.cuh"

namespace vlp {

constexpr int kAttnWarps = 4;
constexpr int kMaxSeq = 256;          // keys held per lane: kMaxSeq / 32
constexpr int kKeysPerLane = kMaxSeq / 32;

// fp32 pitch of a warp's score rows; at least HD + 4 so that the 16 x HD
// output tile staged there fits a row.
__host__ __device__ inline int mhsa_lds(int S, int HD) {
  const int sp = (S + 15) / 16 * 16;
  return (sp > HD ? sp : HD) + 4;
}

// The pieces of the core, which the schedule variants of the probe kernel
// #15 (attn_sched.cuh) order in their own ways.

// Stages q, k, v of head h of one unit ([sp, HD + 8] bf16 each, rows
// S..sp-1 zero); every thread of the block calls it.
template <int HD, class Rows>
__device__ __forceinline__ void mhsa_stage(const bf16* __restrict__ qkv,
                                           bf16* Qs, int S, int sp, int D,
                                           int h, const UnitRows<Rows>& row_of,
                                           int tid, int threads) {
  constexpr int ld = HD + 8;
  constexpr int vecs = HD / 8;
  const bf16* base = qkv + h * HD;
  const size_t row_stride = 3 * (size_t)D;
  for (int i = tid; i < 3 * sp * vecs; i += threads) {
    const int mat = i / (sp * vecs);
    const int rem = i % (sp * vecs);
    const int r = rem / vecs;
    const int c = (rem % vecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < S)
      v = *reinterpret_cast<const uint4*>(base + row_of(r) * row_stride +
                                          mat * D + c);
    *reinterpret_cast<uint4*>(Qs + (size_t)mat * sp * ld + r * ld + c) = v;
  }
}

// S_t[16, sp] = Q[qt] @ K^T in fp32 (unscaled), fp32 pitch lds; one warp.
template <int HD>
__device__ __forceinline__ void mhsa_scores(const bf16* Qs, const bf16* Ks,
                                            int qt, int tiles, float* S_t,
                                            int lds) {
  constexpr int ld = HD + 8;
  constexpr int kf = HD / 16;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[kf];
#pragma unroll
  for (int kk = 0; kk < kf; ++kk)
    wmma::load_matrix_sync(qa[kk], Qs + qt * 16 * ld + kk * 16, ld);
  for (int kt = 0; kt < tiles; ++kt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
    wmma::fill_fragment(sc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kf; ++kk) {
      // col_major B: element (k, j) = K[kt*16 + j][kk*16 + k] = (K^T)[k][j]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
      wmma::load_matrix_sync(kb, Ks + kt * 16 * ld + kk * 16, ld);
      wmma::mma_sync(sc, qa[kk], kb, sc);
    }
    wmma::store_matrix_sync(S_t + kt * 16, sc, lds, wmma::mem_row_major);
  }
  __syncwarp();
}

// One score row -> bf16 p = exp(s * scale - max) written over it (keys
// S..sp-1 zero, unnormalised) and l = sum(p) in fp32; one warp. kNosm (the
// probe's bound): p = bf16(s * scale * 0.01), l = 1.
template <bool kNosm>
__device__ __forceinline__ void mhsa_softmax_row(float* srow, float* l_out,
                                                 int S, int sp, float scale,
                                                 int lane) {
  float v[kKeysPerLane];
  float l = 1.f;
  if (kNosm) {
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < S ? (srow[j] * scale) * 0.01f : 0.f;
    }
  } else {
    const float neg_inf = __int_as_float(0xff800000);
    float m = neg_inf;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < S ? srow[j] * scale : neg_inf;
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    l = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      v[i] = j < S ? expf(v[i] - m) : 0.f;
      l += v[i];
    }
    l = warp_sum(l);
  }
  __syncwarp();  // every lane has read the row before p overwrites it
  bf16* prow = reinterpret_cast<bf16*>(srow);
#pragma unroll
  for (int i = 0; i < kKeysPerLane; ++i) {
    const int j = lane + 32 * i;
    if (j < sp) prow[j] = __float2bfloat16(v[i]);
  }
  if (lane == 0) *l_out = l;
}

// The 16 score rows of one tile at S_t -> p over them, l into L_t[16].
template <bool kNosm>
__device__ __forceinline__ void mhsa_softmax_tile(float* S_t, float* L_t,
                                                  int lds, int S, int sp,
                                                  float scale, int lane) {
  for (int r = 0; r < 16; ++r)
    mhsa_softmax_row<kNosm>(S_t + r * lds, L_t + r, S, sp, scale, lane);
  __syncwarp();
}

// o rows of tile qt = bf16((P @ V) / l) (kRecip: * (1 / l)), P the bf16
// rows written over S_t (pitch 2 * lds); the accumulators are staged
// through S_t; one warp.
template <int HD, bool kRecip, class Rows>
__device__ __forceinline__ void mhsa_pv(float* S_t, const float* L_t,
                                        int lds, const bf16* Vs, int qt,
                                        int tiles, int S, bf16* o, int D,
                                        int h, const UnitRows<Rows>& row_of,
                                        int lane) {
  constexpr int ld = HD + 8;
  constexpr int kf = HD / 16;
  const bf16* P_t = reinterpret_cast<const bf16*>(S_t);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc[kf];
#pragma unroll
  for (int j = 0; j < kf; ++j) wmma::fill_fragment(oc[j], 0.f);
  for (int kt = 0; kt < tiles; ++kt) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
    wmma::load_matrix_sync(pa, P_t + kt * 16, 2 * lds);
#pragma unroll
    for (int j = 0; j < kf; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
      wmma::load_matrix_sync(vb, Vs + kt * 16 * ld + j * 16, ld);
      wmma::mma_sync(oc[j], pa, vb, oc[j]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kf; ++j)
    wmma::store_matrix_sync(S_t + j * 16, oc[j], lds, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < 16 * HD; i += 32) {
    const int r = i / HD;
    const int c = i % HD;
    const int row = qt * 16 + r;
    if (row < S) {
      const float a = S_t[r * lds + c];
      o[row_of(row) * D + h * HD + c] =
          __float2bfloat16(kRecip ? a * (1.0f / L_t[r]) : a / L_t[r]);
    }
  }
  __syncwarp();  // the next tile's scores overwrite S_t
}

}  // namespace vlp
