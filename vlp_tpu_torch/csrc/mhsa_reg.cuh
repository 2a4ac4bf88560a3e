// The register-resident attention core of the standalone packed-qkv
// attention #7 (block_attention.cu), of the half-block forwards #1 and #5
// (ln_attention.cuh) and, in the orders of its schedule modes, of the probe
// #15 and the first pass of #16's two-pass modes (attn_sched.cuh):
//
//   o = bf16((bf16(p) @ v) / l) per (unit, head), with s = (q @ k^T) * scale
//   in fp32, p = exp(s - rowmax(s)), l = sum(p)
//
// over a packed qkv [M, 3D] bf16 (q | k | v, heads packed inside each D
// block) into o [M, D] bf16, the rows of unit n given by a row map
// (attn_rows.cuh). The rounding points are those of the Pallas body
// vlp_tpu/ops/block_attention.py:75-85: s * scale and s - max rounded
// separately (__fmul_rn, __fsub_rn: nvcc would contract the pair into an
// FMA), p = exp(s - max) (exp_p below) rounded once to bf16 for the PV
// product, the division by l after it. Two template flags give the probes'
// other functions: kRecip the backward's o = bf16((bf16(p) @ v) * (1 / l))
// (mega_variants.py:461-463), kNosm the bound p = bf16(s * 0.01), l = 1.
//
// Design. S <= 256, so a warp's 16 query rows of scores fit in registers:
// KT = ceil(S / 16) key tiles (a template parameter, so every score array is
// indexed by constants) of 2 x 4 fp32 a lane, 104 registers at S = 197. One
// block of kFwdWarps warps per (unit, head) stages only k and v in shared
// memory by cp.async, in two groups, so the scores start when k has landed
// while v is still in flight. Each warp takes 16-query tiles: q straight from
// device memory as mma A fragments, the 16 x 16 KT scores with inline-PTX
// mma.sync m16n8k16 (k read by ldmatrix), keys S..16 KT - 1 masked to -inf,
// the row max and sum by quad shuffles, p = exp(s - max) in place, and
// bf16(p) packed into the A fragments of P @ V in place: the m16n8k16
// accumulator layout of a 16 x 16 score block is the A layout of the next
// product, so p never leaves the registers (v read by ldmatrix.trans). The
// scores never touch shared memory, which therefore holds 60 KB at head dim
// 64 and S = 197 (33 KB at 32): three blocks of 4 warps fit an SM.
//
// Orders (FwdOrder). The probe #15's Pallas body reorders one sample's
// 12-head loop so that the VPU softmax of one head overlaps the MXU products
// of another. Here the unit that is reordered is a warp's 16-query tile; a
// tile's pieces (load_q, scores, p_rows, the packing, pv, the store) are the
// same instructions in every order, so every order gives the same bits. A
// form that would hold two tiles' fp32 scores (104 registers each at 13 key
// tiles) parks bf16 p in shared memory instead, in the fragment layout, each
// lane its own 16-byte words:
//
//   v0     tile by tile: QK, softmax, p packed to bf16, PV, store
//   pipe   the QK of the warp's next tile is issued before this tile's PV
//          (whose p was packed right after its softmax), the next tile's
//          softmax right after that PV: one fp32 score array and one bf16 p
//          in registers; 2 blocks an SM
//   pipe2  step k: the softmax of tile k, the QK of tile k + 1, the PV of
//          tile k - 1, whose p waits in shared memory (one tile's p a warp,
//          26 KB a block at 13 key tiles); 2 blocks an SM
//   stage  block-wide: every tile's QK and softmax, its p parked (the
//          block's 16 KT x 16 KT bf16 p and row sums: 88 KB at 13 key
//          tiles, 132 KB at 16), barrier, every tile's PV; 8 warps, one
//          block an SM
//
// What bounds it on this card: 4 * S^2 * HD FLOPs per (unit, head) on
// 8 * S * HD bytes of q, k, v and o, S / 2 = 98 FLOP/byte at S = 196, below
// the bf16 ridge (~295 FLOP/byte): device memory bounds the ideal kernel.
// What bounds this one is the warps an SM can hold (the registers of the
// score rows) and their issue of the per-score softmax arithmetic: at
// ViT-B's 384 units the grid is one wave of three blocks per SM, whose 4
// warps take the 13 query tiles in four rounds (the last with one warp),
// and only v's staging overlaps the products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_rows.cuh"
#include "common.cuh"  // bf16, cp_async16, cp_async_commit, cp_async_wait

namespace vlp {
namespace reg {

constexpr int kMaxTiles = 16;  // S <= 256
constexpr int kFwdWarps = 4;

// The orders of the forward's pieces over a warp's tiles (the header says
// what each does).
enum FwdOrder {
  kOrderV0 = 0,
  kOrderPipe = 1,
  kOrderPipe2 = 2,
  kOrderStage = 3,
};

// Warps a block of the forward: stage's block parks every tile's p and
// takes one block an SM, so it runs 8 warps; the other orders 4.
template <int Order>
__host__ __device__ constexpr int fwd_warps() {
  return Order == kOrderStage ? 8 : kFwdWarps;
}

// Blocks of the forward an SM holds: v0 3 (<= 168 registers a thread) up
// to 13 key tiles (S = 208), 2 above; pipe and pipe2 2 (a second tile's
// scores or p beside the first's); stage 1 (its parked p).
template <int KT, int Order>
__host__ __device__ constexpr int fwd_min_blocks() {
  return Order == kOrderStage ? 1 : Order != kOrderV0 ? 2 : KT <= 13 ? 3 : 2;
}

// ---- warp-level tensor-core pieces (inline PTX) ----
//
// Lane (g, t) = (lane / 4, lane % 4). An m16n8k16 A fragment a[4] (16 x 16
// bf16, row-major) holds rows g, g + 8 at columns 2t, 2t + 1 (a[0], a[1]) and
// 2t + 8, 2t + 9 (a[2], a[3]); a B fragment (b0, b1) (16 x 8) holds column g
// at rows 2t, 2t + 1 (b0) and 2t + 8, 2t + 9 (b1); an accumulator d[4]
// (16 x 8 fp32) holds row g (d[0], d[1]) and row g + 8 (d[2], d[3]) at
// columns 2t, 2t + 1. Each register holds the lower column in its low half.

// d += a @ b
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The 16 x 16 tile at (r0, c0) of a row-major bf16 matrix (pitch ld) as an
// A fragment; also, with .trans, the B fragments of two 8-column tiles
// (c0, c0 + 8) of B = that tile (rows the k index): r[0], r[1] and r[2],
// r[3].
__device__ __forceinline__ const bf16* frag_a_addr(const bf16* m, int ld,
                                                   int r0, int c0, int lane) {
  return m + (r0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + c0 +
         ((lane >> 4) & 1) * 8;
}

// The B fragments of two 8-column tiles of B = M^T, M's rows r0..r0 + 15
// the columns of B and its columns c0..c0 + 15 the k index: (r[0], r[1])
// for B columns r0..r0 + 7, (r[2], r[3]) for r0 + 8..r0 + 15 (ldmatrix
// without .trans).
__device__ __forceinline__ const bf16* frag_bt_addr(const bf16* m, int ld,
                                                    int r0, int c0,
                                                    int lane) {
  return m + (r0 + ((lane >> 4) & 1) * 8 + (lane & 7)) * ld + c0 +
         ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp of a softmax argument x <= 0 by the special-function unit (ex2 of
// x * log2 e): within 2 + 1.17 |x| ulp of expf, far inside the bf16
// rounding of p that follows; less forward time than expf at S 196, and
// the same bits wherever a backward pass recomputes p.
__device__ __forceinline__ float exp_p(float x) { return __expf(x); }

// max and sum over the four lanes of a quad (one accumulator row); every
// lane gets the same bits (a + b == b + a in IEEE arithmetic)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Stages rows 0..16 KT - 1 of one head's slice of src (row r at
// src + row_of(r) * pitch, HD bf16) into dst [16 KT, HD + 8] by cp.async,
// rows S.. zero-filled; the caller commits.
template <int HD, int KT, int kThreads, class Rows>
__device__ __forceinline__ void stage_head(bf16* dst, const bf16* src,
                                           size_t pitch, int S,
                                           const UnitRows<Rows>& row_of,
                                           int tid) {
  constexpr int ld = HD + 8;
  constexpr int vecs = HD / 8;
  for (int i = tid; i < KT * 16 * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i % vecs) * 8;
    const bool ok = r < S;
    cp_async16(dst + r * ld + c, ok ? src + row_of(r) * pitch + c : src,
                      ok);
  }
}

// s[2 KT][4] = (q tile @ K^T) * scale for one warp's 16 query rows, keys
// S..16 KT - 1 at -inf; qa the tile's A fragments over the head dim, Ks the
// staged keys [16 KT, HD + 8]. The products run in a fixed order (key tile,
// then head-dim step), so phase B of the backward, issuing the same mma on
// the same fragments, gets the same bits.
template <int HD, int KT>
__device__ __forceinline__ void scores(float (&s)[2 * KT][4],
                                       const uint32_t (&qa)[HD / 16][4],
                                       const bf16* Ks, int S, float scale,
                                       int lane) {
  constexpr int ld = HD + 8;
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, frag_bt_addr(Ks, ld, kt * 16, kk * 16, lane));
      mma16816(s[2 * kt], qa[kk], b[0], b[1]);
      mma16816(s[2 * kt + 1], qa[kk], b[2], b[3]);
    }
  }
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __fmul_rn(s[j][e], scale);
      // only the last key tile can hold keys >= S
      if (j >= 2 * KT - 2 && j * 8 + 2 * t + (e & 1) >= S)
        s[j][e] = __int_as_float(0xff800000);
    }
}

// In place s -> p = exp(s - max) per row; the row maxima (rows g, g + 8)
// into m[2] and the row sums into l[2].
template <int KT>
__device__ __forceinline__ void softmax_rows(float (&s)[2 * KT][4],
                                             float (&m)[2], float (&l)[2]) {
  m[0] = m[1] = __int_as_float(0xff800000);
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp_p(__fsub_rn(s[j][e], m[e >> 1]));
      l[e >> 1] += s[j][e];
    }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
}

// The A fragment of key tile kt (16 x 16 bf16) from accumulator tiles
// x[2 kt], x[2 kt + 1].
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&x)[N][4], int kt) {
  a[0] = pack_bf16(x[2 * kt][0], x[2 * kt][1]);
  a[1] = pack_bf16(x[2 * kt][2], x[2 * kt][3]);
  a[2] = pack_bf16(x[2 * kt + 1][0], x[2 * kt + 1][1]);
  a[3] = pack_bf16(x[2 * kt + 1][2], x[2 * kt + 1][3]);
}


// q of query tile qt as the A fragments of its 16 rows over the head dim,
// straight from device memory (rows >= S zero).
template <int HD, class Rows>
__device__ __forceinline__ void load_q(uint32_t (&qa)[HD / 16][4],
                                       const bf16* head, size_t row3, int qt,
                                       int S, const UnitRows<Rows>& row_of,
                                       int lane) {
  const int t = lane & 3;
  const int r0 = qt * 16 + (lane >> 2);
  const int r1 = r0 + 8;
  const bool ok0 = r0 < S, ok1 = r1 < S;
  const bf16* q0 = head + (ok0 ? row_of(r0) : 0) * row3 + 2 * t;
  const bf16* q1 = head + (ok1 ? row_of(r1) : 0) * row3 + 2 * t;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16;
    qa[kk][0] = ok0 ? __ldg(reinterpret_cast<const unsigned*>(q0 + c)) : 0u;
    qa[kk][1] = ok1 ? __ldg(reinterpret_cast<const unsigned*>(q1 + c)) : 0u;
    qa[kk][2] =
        ok0 ? __ldg(reinterpret_cast<const unsigned*>(q0 + c + 8)) : 0u;
    qa[kk][3] =
        ok1 ? __ldg(reinterpret_cast<const unsigned*>(q1 + c + 8)) : 0u;
  }
}

// In place s -> p and the row sums l of the forward: p = exp(s - max) by
// softmax_rows; kNosm (the probe's bound, mega_variants.py:354-356):
// p = s * 0.01 at keys < S and 0 beyond (their staged v rows are zero, and
// -inf * 0 would be NaN), l = 1.
template <int KT, bool kNosm>
__device__ __forceinline__ void p_rows(float (&s)[2 * KT][4], float (&l)[2],
                                       int S, int lane) {
  if constexpr (kNosm) {
    const int t = lane & 3;
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = j * 8 + 2 * t + (e & 1) < S ? __fmul_rn(s[j][e], 0.01f)
                                              : 0.f;
    l[0] = l[1] = 1.f;
  } else {
    float m[2];
    softmax_rows<KT>(s, m, l);
  }
}

// acc = bf16(p) @ V for one warp's 16 query rows, key tile by key tile
// (every core's PV order); pfrag(kt, a) gives p's A fragment of key tile
// kt, from registers or from where a schedule parked it.
template <int HD, int KT, class PFrag>
__device__ __forceinline__ void pv(float (&acc)[HD / 8][4], PFrag pfrag,
                                   const bf16* Vs, int lane) {
  constexpr int ld = HD + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t a[4];
    pfrag(kt, a);
#pragma unroll
    for (int dn = 0; dn < HD / 16; ++dn) {
      uint32_t b[4];
      ldsm_x4_trans(b, frag_a_addr(Vs, ld, kt * 16, dn * 16, lane));
      mma16816(acc[2 * dn], a, b[0], b[1]);
      mma16816(acc[2 * dn + 1], a, b[2], b[3]);
    }
  }
}

// Stores o = bf16(acc * il) of a warp's 16 query rows (r0 = tile * 16 + g
// and r0 + 8, rows < S; il their 1 / l) at column col of o's rows [M, D]:
// the backward's o (mega_variants.py:461-463), formed by the forward core
// with kRecip and by the backward core with kOut (mhsa_reg_bwd.cuh).
template <int HD, class Rows>
__device__ __forceinline__ void store_o(const float (&acc)[HD / 8][4],
                                        const float (&il)[2], bf16* o, int D,
                                        int col, int r0, int S,
                                        const UnitRows<Rows>& row_of,
                                        int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= S) continue;
    bf16* dst = o + row_of(r) * D + col + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_bf16(__fmul_rn(acc[j][2 * half], il[half]),
                    __fmul_rn(acc[j][2 * half + 1], il[half]));
  }
}

// Stores the forward's o = bf16(acc / l) (kRecip: bf16(acc * (1 / l)))
// of a warp's 16 query rows, as store_o.
template <int HD, bool kRecip, class Rows>
__device__ __forceinline__ void store_tile(const float (&acc)[HD / 8][4],
                                           const float (&l)[2], bf16* o,
                                           int D, int col, int r0, int S,
                                           const UnitRows<Rows>& row_of,
                                           int lane) {
  if constexpr (kRecip) {
    const float il[2] = {1.0f / l[0], 1.0f / l[1]};
    store_o<HD>(acc, il, o, D, col, r0, S, row_of, lane);
  } else {
    const int t = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r >= S) continue;
      bf16* dst = o + row_of(r) * D + col + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) =
            pack_bf16(__fdiv_rn(acc[j][2 * half], l[half]),
                      __fdiv_rn(acc[j][2 * half + 1], l[half]));
    }
  }
}

// Packs p's KT key tiles (s after p_rows) as A fragments into where a
// schedule parks them: this lane's word of key tile kt at park[kt * 32].
template <int KT>
__device__ __forceinline__ void park_p(uint4* park,
                                       const float (&s)[2 * KT][4]) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t a[4];
    acc_to_a(a, s, kt);
    park[kt * 32] = make_uint4(a[0], a[1], a[2], a[3]);
  }
}

// pv's source of p for a parked tile (park_p's layout).
struct Parked {
  const uint4* park;
  __device__ __forceinline__ void operator()(int kt, uint32_t (&a)[4]) const {
    const uint4 v = park[kt * 32];
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
  }
};

// Bytes of shared memory a block parks p in: pipe2 one tile of bf16 p a
// warp, stage every tile's p and row sums, in the fragment layout (lane
// `lane` of the tile's warp holds key tile kt's A fragment at uint4
// [kt * 32 + lane] and its rows' l at float2 [lane]: 16-byte accesses,
// each lane its own words, no bank conflict).
template <int KT, int Order>
__host__ __device__ constexpr size_t fwd_park_bytes() {
  return Order == kOrderPipe2 ? (size_t)kFwdWarps * KT * 32 * sizeof(uint4)
         : Order == kOrderStage
             ? (size_t)KT * 32 * (KT * sizeof(uint4) + sizeof(float2))
             : 0;
}

// grid (H, N); block fwd_warps<Order>() * 32 threads. Token r of unit n is
// row rows(n, r) of qkv and o. Order: FwdOrder; kNosm: p_rows' bound;
// kRecip: o = bf16(acc * (1 / l)).
template <int HD, int KT, class Rows, int Order, bool kNosm, bool kRecip>
__global__ void __launch_bounds__(fwd_warps<Order>() * 32,
                                  fwd_min_blocks<KT, Order>())
    mhsa_reg_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o,
                    int S, int D, float scale, Rows rows) {
  constexpr int ld = HD + 8;  // bf16 pitch of the staged k, v rows
  constexpr int KF = HD / 16;
  constexpr int W = fwd_warps<Order>();
  constexpr int kThreads = W * 32;
  constexpr int kRounds = (KT + W - 1) / W;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + KT * 16 * ld;
  uint4* Pk = reinterpret_cast<uint4*>(Vs + KT * 16 * ld);  // parked p
  int* Rt = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(Pk) +
                                   fwd_park_bytes<KT, Order>());  // row table
  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const size_t row3 = 3 * (size_t)D;
  const UnitRows<Rows> row_of = unit_rows(rows, n, S, Rt, tid, kThreads);
  const bf16* head = qkv + h * HD;
  stage_head<HD, KT, kThreads>(Ks, head + D, row3, S, row_of, tid);
  cp_async_commit();
  stage_head<HD, KT, kThreads>(Vs, head + 2 * D, row3, S, row_of, tid);
  cp_async_commit();
  const int col = h * HD;

  if constexpr (Order == kOrderV0) {
#pragma unroll 1
    for (int round = 0; round < kRounds; ++round) {
      const int qt = warp + round * W;
      const bool active = qt < KT;  // warp-uniform
      uint32_t qa[KF][4];
      if (active) load_q<HD>(qa, head, row3, qt, S, row_of, lane);
      if (round == 0) {  // k has landed
        cp_async_wait<1>();
        __syncthreads();
      }
      float s[2 * KT][4];
      float l[2];
      uint32_t pa[KT][4];
      if (active) {
        scores<HD, KT>(s, qa, Ks, S, scale, lane);
        p_rows<KT, kNosm>(s, l, S, lane);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) acc_to_a(pa[kt], s, kt);
      }
      if (round == 0) {  // v has landed
        cp_async_wait<0>();
        __syncthreads();
      }
      if (!active) continue;
      float acc[HD / 8][4];
      pv<HD, KT>(acc, [&](int kt, uint32_t (&a)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = pa[kt][i];
      }, Vs, lane);
      store_tile<HD, kRecip>(acc, l, o, D, col, qt * 16 + g, S, row_of,
                             lane);
    }
  } else if constexpr (Order == kOrderStage) {
    float2* Lk = reinterpret_cast<float2*>(Pk + KT * KT * 32);
    // stage 1: every tile's QK and softmax, p and l parked
#pragma unroll 1
    for (int round = 0; round < kRounds; ++round) {
      const int qt = warp + round * W;
      const bool active = qt < KT;  // warp-uniform
      uint32_t qa[KF][4];
      if (active) load_q<HD>(qa, head, row3, qt, S, row_of, lane);
      if (round == 0) {  // k has landed
        cp_async_wait<1>();
        __syncthreads();
      }
      if (!active) continue;
      float s[2 * KT][4];
      float l[2];
      scores<HD, KT>(s, qa, Ks, S, scale, lane);
      p_rows<KT, kNosm>(s, l, S, lane);
      park_p<KT>(Pk + qt * KT * 32 + lane, s);
      Lk[qt * 32 + lane] = make_float2(l[0], l[1]);
    }
    cp_async_wait<0>();  // v has landed
    __syncthreads();            // and every tile's p is parked
    // stage 2: every tile's PV
#pragma unroll 1
    for (int qt = warp; qt < KT; qt += W) {
      float acc[HD / 8][4];
      pv<HD, KT>(acc, Parked{Pk + qt * KT * 32 + lane}, Vs, lane);
      const float2 lq = Lk[qt * 32 + lane];
      const float l[2] = {lq.x, lq.y};
      store_tile<HD, kRecip>(acc, l, o, D, col, qt * 16 + g, S, row_of,
                             lane);
    }
  } else {  // pipe, pipe2: a warp's tiles are warp, warp + W, ...
    const int cnt = warp < KT ? (KT - warp + W - 1) / W : 0;
    uint32_t qa[KF][4];
    float s[2 * KT][4];
    float l[2];
    float acc[HD / 8][4];
    auto qk = [&](int k) {  // the QK of the warp's k-th tile into s
      load_q<HD>(qa, head, row3, warp + k * W, S, row_of, lane);
      scores<HD, KT>(s, qa, Ks, S, scale, lane);
    };
    auto tile_row = [&](int k) { return (warp + k * W) * 16 + g; };
    if (cnt > 0) load_q<HD>(qa, head, row3, warp, S, row_of, lane);
    cp_async_wait<1>();  // k has landed
    __syncthreads();
    if (cnt > 0) scores<HD, KT>(s, qa, Ks, S, scale, lane);
    if constexpr (Order == kOrderPipe) {
      uint32_t pa[KT][4];
      auto softmax = [&]() {  // s -> p, packed into pa
        p_rows<KT, kNosm>(s, l, S, lane);
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) acc_to_a(pa[kt], s, kt);
      };
      auto from_regs = [&](int kt, uint32_t (&a)[4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = pa[kt][i];
      };
      if (cnt > 0) softmax();
      cp_async_wait<0>();  // v has landed
      __syncthreads();
      // tile k's p is in pa: the next tile's QK is issued before tile k's
      // PV, and its softmax follows that PV, before tile k's store
#pragma unroll 1
      for (int k = 0; k + 1 < cnt; ++k) {
        const float lk[2] = {l[0], l[1]};
        qk(k + 1);
        pv<HD, KT>(acc, from_regs, Vs, lane);
        softmax();
        store_tile<HD, kRecip>(acc, lk, o, D, col, tile_row(k), S, row_of,
                               lane);
      }
      if (cnt > 0) {
        pv<HD, KT>(acc, from_regs, Vs, lane);
        store_tile<HD, kRecip>(acc, l, o, D, col, tile_row(cnt - 1), S,
                               row_of, lane);
      }
    } else {  // pipe2
      uint4* park = Pk + warp * KT * 32 + lane;  // one tile's p
      auto softmax = [&]() {  // s -> p, packed straight into the park
        p_rows<KT, kNosm>(s, l, S, lane);
        park_p<KT>(park, s);
      };
      const Parked from_park{park};
      float lp[2];  // the parked tile's row sums
      if (cnt > 0) {
        softmax();
        lp[0] = l[0], lp[1] = l[1];
      }
      cp_async_wait<0>();  // v has landed
      __syncthreads();
      if (cnt > 1) qk(1);
      // step k: the PV of tile k - 1 from the park, the softmax of tile k
      // into the park, the QK of tile k + 1; a lane holds one fp32 score
      // array and the PV accumulators
#pragma unroll 1
      for (int k = 1; k + 1 < cnt; ++k) {
        pv<HD, KT>(acc, from_park, Vs, lane);
        softmax();
        qk(k + 1);
        store_tile<HD, kRecip>(acc, lp, o, D, col, tile_row(k - 1), S,
                               row_of, lane);
        lp[0] = l[0], lp[1] = l[1];
      }
      if (cnt > 1) {
        pv<HD, KT>(acc, from_park, Vs, lane);
        softmax();
        store_tile<HD, kRecip>(acc, lp, o, D, col, tile_row(cnt - 2), S,
                               row_of, lane);
        lp[0] = l[0], lp[1] = l[1];
      }
      if (cnt > 0) {
        pv<HD, KT>(acc, from_park, Vs, lane);
        store_tile<HD, kRecip>(acc, lp, o, D, col, tile_row(cnt - 1), S,
                               row_of, lane);
      }
    }
  }
}

template <int HD, int KT, class Rows, int Order>
inline size_t mhsa_reg_smem_bytes(int S) {
  return 2 * (size_t)KT * 16 * (HD + 8) * sizeof(bf16) +
         fwd_park_bytes<KT, Order>() + row_table_bytes<Rows>(S);
}

// Launches the instance with KT = ceil(S / 16) key tiles.
template <int HD, class Rows, int Order, bool kNosm, bool kRecip, int KT = 1>
cudaError_t launch_mhsa_reg_tiles(const bf16* qkv, bf16* o, int N, int S,
                                  int D, int H, float scale, Rows rows,
                                  cudaStream_t stream) {
  if constexpr (KT < kMaxTiles) {
    if ((S + 15) / 16 > KT)
      return launch_mhsa_reg_tiles<HD, Rows, Order, kNosm, kRecip, KT + 1>(
          qkv, o, N, S, D, H, scale, rows, stream);
  }
  auto kernel = mhsa_reg_kernel<HD, KT, Rows, Order, kNosm, kRecip>;
  // the instance's largest shared memory (a row table of 16 KT rows), set
  // at its first launch only: the port runs one card per process, and the
  // runtime call costs host time at every launch of a 40 us kernel
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mhsa_reg_smem_bytes<HD, KT, Rows, Order>(16 * KT));
  if (configured != cudaSuccess) return configured;
  kernel<<<dim3(H, N), fwd_warps<Order>() * 32,
           mhsa_reg_smem_bytes<HD, KT, Rows, Order>(S), stream>>>(
      qkv, o, S, D, scale, rows);
  return cudaGetLastError();
}

}  // namespace reg

// The forward core in order `Order` (v0: #1's, #5's and #7's); kNosm and
// kRecip as mhsa_reg_kernel.
template <int HD, int Order = reg::kOrderV0, bool kNosm = false,
          bool kRecip = false, class Rows>
cudaError_t launch_mhsa_reg(const bf16* qkv, bf16* o, int N, int S, int D,
                            int H, float scale, Rows rows,
                            cudaStream_t stream) {
  if (N <= 0 || S <= 0 || S > 16 * reg::kMaxTiles || D != H * HD ||
      N > 65535)
    return cudaErrorInvalidValue;
  return reg::launch_mhsa_reg_tiles<HD, Rows, Order, kNosm, kRecip>(
      qkv, o, N, S, D, H, scale, rows, stream);
}

}  // namespace vlp
