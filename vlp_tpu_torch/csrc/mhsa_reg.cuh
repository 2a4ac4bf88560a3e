// The register-resident attention core of the standalone packed-qkv
// attention, kernel #7 (block_attention.cu):
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
// product, the division by l after it.
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
// 64 and S = 197 (33 KB at 32): three blocks of 4 warps fit an SM (12
// warps, against one block of 4 warps for mhsa.cuh's core at head dim 64).
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
#include "gemm.cuh"            // bf16
#include "implicit_gemm.cuh"   // cp_async16, cp_async_commit, cp_async_wait

namespace vlp {
namespace reg {

constexpr int kMaxTiles = 16;  // S <= 256
constexpr int kFwdWarps = 4;

// Blocks of the forward an SM holds: 3 (<= 168 registers a thread) up to
// 13 key tiles (S = 208), 2 above.
template <int KT>
__host__ __device__ constexpr int fwd_min_blocks() { return KT <= 13 ? 3 : 2; }

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
    igemm::cp_async16(dst + r * ld + c, ok ? src + row_of(r) * pitch + c : src,
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

// grid (H, N); block kFwdWarps * 32 threads. Token r of unit n is row
// rows(n, r) of qkv and o.
template <int HD, int KT, class Rows>
__global__ void __launch_bounds__(kFwdWarps * 32, fwd_min_blocks<KT>())
    mhsa_reg_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o,
                    int S, int D, float scale, Rows rows) {
  constexpr int ld = HD + 8;  // bf16 pitch of the staged k, v rows
  constexpr int KF = HD / 16;
  constexpr int kThreads = kFwdWarps * 32;
  constexpr int kRounds = (KT + kFwdWarps - 1) / kFwdWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + KT * 16 * ld;
  int* Rt = reinterpret_cast<int*>(Vs + KT * 16 * ld);  // row table
  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t row3 = 3 * (size_t)D;
  const UnitRows<Rows> row_of = unit_rows(rows, n, S, Rt, tid, kThreads);
  const bf16* head = qkv + h * HD;
  stage_head<HD, KT, kThreads>(Ks, head + D, row3, S, row_of, tid);
  igemm::cp_async_commit();
  stage_head<HD, KT, kThreads>(Vs, head + 2 * D, row3, S, row_of, tid);
  igemm::cp_async_commit();

#pragma unroll 1
  for (int round = 0; round < kRounds; ++round) {
    const int qt = warp + round * kFwdWarps;
    const bool active = qt < KT;  // warp-uniform
    const int r0 = qt * 16 + g;
    const int r1 = r0 + 8;
    uint32_t qa[KF][4];
    if (active) {  // q as A fragments, straight from device memory
      const bool ok0 = r0 < S, ok1 = r1 < S;
      const bf16* q0 = head + (ok0 ? row_of(r0) : 0) * row3 + 2 * t;
      const bf16* q1 = head + (ok1 ? row_of(r1) : 0) * row3 + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KF; ++kk) {
        const int c = kk * 16;
        qa[kk][0] = ok0 ? __ldg(reinterpret_cast<const unsigned*>(q0 + c)) : 0u;
        qa[kk][1] = ok1 ? __ldg(reinterpret_cast<const unsigned*>(q1 + c)) : 0u;
        qa[kk][2] =
            ok0 ? __ldg(reinterpret_cast<const unsigned*>(q0 + c + 8)) : 0u;
        qa[kk][3] =
            ok1 ? __ldg(reinterpret_cast<const unsigned*>(q1 + c + 8)) : 0u;
      }
    }
    if (round == 0) {  // k has landed
      igemm::cp_async_wait<1>();
      __syncthreads();
    }
    float s[2 * KT][4];
    float m[2], l[2];
    uint32_t pa[KT][4];
    if (active) {
      scores<HD, KT>(s, qa, Ks, S, scale, lane);
      softmax_rows<KT>(s, m, l);
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) acc_to_a(pa[kt], s, kt);
    }
    if (round == 0) {  // v has landed
      igemm::cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    float acc[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int dn = 0; dn < KF; ++dn) {
        uint32_t b[4];
        ldsm_x4_trans(b, frag_a_addr(Vs, ld, kt * 16, dn * 16, lane));
        mma16816(acc[2 * dn], pa[kt], b[0], b[1]);
        mma16816(acc[2 * dn + 1], pa[kt], b[2], b[3]);
      }
    if (r0 < S) {
      bf16* dst = o + row_of(r0) * D + h * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) = pack_bf16(
            __fdiv_rn(acc[j][0], l[0]), __fdiv_rn(acc[j][1], l[0]));
    }
    if (r1 < S) {
      bf16* dst = o + row_of(r1) * D + h * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8) = pack_bf16(
            __fdiv_rn(acc[j][2], l[1]), __fdiv_rn(acc[j][3], l[1]));
    }
  }
}

template <int HD, int KT, class Rows>
inline size_t mhsa_reg_smem_bytes(int S) {
  return 2 * (size_t)KT * 16 * (HD + 8) * sizeof(bf16) +
         row_table_bytes<Rows>(S);
}

// Launches the instance with KT = ceil(S / 16) key tiles.
template <int HD, class Rows, int KT = 1>
cudaError_t launch_mhsa_reg_tiles(const bf16* qkv, bf16* o, int N, int S,
                                  int D, int H, float scale, Rows rows,
                                  cudaStream_t stream) {
  if constexpr (KT < kMaxTiles) {
    if ((S + 15) / 16 > KT)
      return launch_mhsa_reg_tiles<HD, Rows, KT + 1>(qkv, o, N, S, D, H,
                                                     scale, rows, stream);
  }
  // the instance's largest shared memory (a row table of 16 KT rows), set
  // at its first launch only: the port runs one card per process, and the
  // runtime call costs host time at every launch of a 40 us kernel
  static const cudaError_t configured = cudaFuncSetAttribute(
      mhsa_reg_kernel<HD, KT, Rows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mhsa_reg_smem_bytes<HD, KT, Rows>(16 * KT));
  if (configured != cudaSuccess) return configured;
  mhsa_reg_kernel<HD, KT, Rows>
      <<<dim3(H, N), kFwdWarps * 32, mhsa_reg_smem_bytes<HD, KT, Rows>(S),
         stream>>>(qkv, o, S, D, scale, rows);
  return cudaGetLastError();
}

}  // namespace reg

template <int HD, class Rows>
cudaError_t launch_mhsa_reg(const bf16* qkv, bf16* o, int N, int S, int D,
                            int H, float scale, Rows rows,
                            cudaStream_t stream) {
  if (N <= 0 || S <= 0 || S > 16 * reg::kMaxTiles || D != H * HD ||
      N > 65535)
    return cudaErrorInvalidValue;
  return reg::launch_mhsa_reg_tiles<HD, Rows>(qkv, o, N, S, D, H, scale, rows,
                                              stream);
}

}  // namespace vlp
