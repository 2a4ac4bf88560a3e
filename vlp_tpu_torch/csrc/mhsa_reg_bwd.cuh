// The register-resident attention-core backward of the standalone
// packed-qkv attention, kernel #8 (block_attention_bwd.cu), and of the
// half-block backwards #3 and #6 (ln_attention.cuh, with the per-unit
// column sums of dq, dk, dv behind their dbqkv: kSums): from qkv
// [M, 3D] and do [M, D] bf16 to dqkv = bf16([dq | dk | dv]) [M, 3D], the
// body of vlp_tpu/ops/block_attention.py:109-144, the rows of unit n given
// by a row map (attn_rows.cuh). Its rounding points are the body's:
// s * scale and s - max rounded separately, p = exp(s - max) unnormalised,
// bf16(p) for dv, dov = bf16(do / l), t = p * dp, c = sum(t) / l,
// ds = (t - p * c) / l rounded at each step (no FMA) and once to bf16,
// dq and dk scaled in fp32, one cast each.
//
// Design. One block per (unit, head) stages q, k, v and do in shared memory
// by cp.async, in two groups (q, k, then v, do), and keeps dov and the row
// statistics there; KT = ceil(S / 16) is a template parameter, so the score
// arrays stay in registers (mhsa_reg.cuh has the fragment layouts). With no
// per-warp score buffers a block runs one warp per 16-row tile (KT warps up
// to 13; 8 above), S <= 256 at both head dims.
//
//   Phase A, per warp, 16 query rows: s in registers (the forward's
//   scores()), the row max, p = exp(s - max) in place, l, 1/l; dp = do v^T
//   one 16-key tile at a time, accumulating c = sum(p dp) / l. A second
//   pass issues the same mma on the same fragments (so the same dp) and
//   forms ds, packed as bf16 A fragments; dq = bf16(ds) @ k * scale, stored
//   once. dov = bf16(do / l) and the row statistics (max, 1/l, c) go to
//   shared memory. (Recomputing p in the second pass instead of holding it
//   took 1.25-1.35x the time.)
//   Phase B, per warp, 16 keys: for every query tile, the 16 x 16 score and
//   dp tiles are recomputed with phase A's own instructions (A = the query
//   tile, B = the key tile), so p and ds are phase A's bit for bit;
//   movmatrix transposes their bf16 8 x 8 blocks into the A fragments of
//   p^T and ds^T, and dv += bf16(p)^T @ dov, dk += bf16(ds)^T @ q accumulate
//   in registers.
//
// Every sum runs in a fixed order and nothing is added atomically, so
// reruns agree bit for bit. With a check buffer (null on the model path)
// phase A writes its fp32 p and ds there, and phase B counts its
// recomputed elements that differ from them in any bit: the card's own
// proof that phase B sees phase A's p. Shared memory: 5 x 16 KT x (HD + 8)
// bf16 and 3 x 16 KT fp32 (152 KB at HD = 64, S = 197; 187 KB at S = 256),
// one block per SM.
//
// What bounds it on this card: 8 * S^2 * HD FLOPs (plus the recomputed
// scores and dp) per (unit, head) on 14 * S * HD bytes of qkv, do and dqkv:
// at S = 196 above 100 FLOP/byte but below the bf16 ridge (~295), so device
// memory bounds the ideal kernel. What bounds this one is one block per SM
// (the staged rows) and its warps' registers, the staging that no other
// block overlaps, and the exp of every score twice (phases A and B).
#pragma once

#include "mhsa_reg.cuh"

namespace vlp {
namespace reg {

// Warps per block of the backward: one per 16-row tile up to 8, then 8
// (two rounds; 8 warps may hold 255 registers a thread).
template <int KT>
__host__ __device__ constexpr int bwd_warps() { return KT <= 8 ? KT : 8; }

// The transpose of an 8 x 8 bf16 matrix held one row per quad.
__device__ __forceinline__ uint32_t movm_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// The A fragment of X^T from the two accumulator tiles x[0], x[1] of a
// 16 x 16 block X (rows = A's columns), as bf16.
__device__ __forceinline__ void acc_to_at(uint32_t (&a)[4],
                                          const float (&x)[2][4]) {
  a[0] = movm_trans(pack_bf16(x[0][0], x[0][1]));
  a[1] = movm_trans(pack_bf16(x[1][0], x[1][1]));
  a[2] = movm_trans(pack_bf16(x[0][2], x[0][3]));
  a[3] = movm_trans(pack_bf16(x[1][2], x[1][3]));
}

// dp[2][4] = do tile @ V[kt]^T for one warp's 16 query rows: the same
// instructions in phase A and phase B.
template <int HD>
__device__ __forceinline__ void dp_tile(float (&dp)[2][4], const bf16* Ds,
                                        const bf16* Vs, int qt, int kt,
                                        int lane) {
  constexpr int ld = HD + 8;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t da[4], b[4];
    ldsm_x4(da, frag_a_addr(Ds, ld, qt * 16, kk * 16, lane));
    ldsm_x4(b, frag_bt_addr(Vs, ld, kt * 16, kk * 16, lane));
    mma16816(dp[0], da, b[0], b[1]);
    mma16816(dp[1], da, b[2], b[3]);
  }
}

// A guard at each key tile of phase A's unrolled passes. S <= 16 KT holds
// (the launch picks KT), but ptxas cannot prove it, so every guard closes a
// scheduling region: without them ptxas hoists later tiles' loads and
// products above earlier ones and spills at head dim 64 (-Xptxas -v).
template <int KT>
__device__ __forceinline__ void tile_guard(int S) {
  if (S > 16 * KT) __trap();
}

// p = exp(s * scale - m) of a score tile's element at key `key` (0 for
// keys >= S), rounded as scores() and softmax_rows() round it
__device__ __forceinline__ float p_of(float s, float scale, float m, int key,
                                      int S) {
  return key < S ? exp_p(__fsub_rn(__fmul_rn(s, scale), m)) : 0.f;
}

// ds = (t - p * c) * invl with t = p * dp, each product and difference
// rounded on its own (block_attention.py:129-131)
__device__ __forceinline__ float ds_of(float p, float dp, float c,
                                       float invl) {
  return __fmul_rn(__fsub_rn(__fmul_rn(p, dp), __fmul_rn(p, c)), invl);
}

// Stores the fp32 16 x HD tile v = acc * mul (rows r0 = tile * 16 + g and
// r0 + 8) as bf16 at column col of dqkv's rows; with part non-null, also
// the tile's column sums of v over its rows < S into part[HD]: each lane
// adds its two rows, then the eight lanes of a column in a fixed butterfly,
// so the sums depend only on the tile's values. Every lane of the warp
// calls it.
template <int HD, class Rows>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 8][4],
                                           float mul, bf16* dqkv, size_t row3,
                                           int col, int r0, int S,
                                           const UnitRows<Rows>& row_of,
                                           int lane, float* part) {
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= S) continue;
    bf16* dst = dqkv + row_of(r) * row3 + col + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_bf16(__fmul_rn(acc[j][2 * half], mul),
                    __fmul_rn(acc[j][2 * half + 1], mul));
  }
  if (part == nullptr) return;  // a constant where it is inlined
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = (r0 < S ? __fmul_rn(acc[j][e], mul) : 0.f) +
                (r0 + 8 < S ? __fmul_rn(acc[j][2 + e], mul) : 0.f);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) part[j * 8 + 2 * t + e] = v;
    }
}

// grid (H, N); block bwd_warps<KT>() * 32 threads. qkv [M, 3D] and dout (do)
// [M, D] bf16 -> dqkv [M, 3D] bf16; token r of unit n is row rows(n, r) of
// each. With kSums, bpart [N, 3D] fp32 receives the unit's column sums of
// the fp32 dq, dk, dv that dqkv rounds (the half block's dbqkv before the
// sum over units): per 16-row tile at the store (store_rows), staged
// [KT][3][HD] in shared memory, then added over the tiles in tile order, so
// they depend on S and the unit's values alone (a template switch, so that
// #8's instances, which take none, keep their registers: at HD 64 and 16
// key tiles a runtime switch cost 4 bytes of spill). check: null, or
// [N * H][2][16 KT][16 KT]
// fp32 (phase A's p, ds) and bad, the count of recomputed elements that
// differ from them. The check's branches stay in the model path's code
// (check null): they too bound ptxas's scheduling regions, and the kernel
// spills without them.
template <int HD, int KT, class Rows, bool kSums>
__global__ void __launch_bounds__(bwd_warps<KT>() * 32, 1)
    mhsa_reg_bwd_kernel(const bf16* __restrict__ qkv,
                        const bf16* __restrict__ dout,
                        bf16* __restrict__ dqkv, float* __restrict__ bpart,
                        float* __restrict__ check,
                        unsigned* __restrict__ bad, int S, int D,
                        float scale, Rows rows) {
  constexpr int W = bwd_warps<KT>();
  constexpr int kThreads = W * 32;
  constexpr int kRounds = (KT + W - 1) / W;
  constexpr int ld = HD + 8;  // bf16 pitch of a staged row
  constexpr int KF = HD / 16;
  constexpr int SP = KT * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + SP * ld;
  bf16* Vs = Ks + SP * ld;
  bf16* Ds = Vs + SP * ld;    // do
  bf16* DOVs = Ds + SP * ld;  // bf16(do / l)
  float* Mx = reinterpret_cast<float*>(DOVs + SP * ld);  // row max of s
  float* Il = Mx + SP;                                   // 1 / l
  float* Cr = Il + SP;                                   // c
  float* Bp = Cr + SP;  // the tiles' column sums, [KT][3][HD] (kSums)
  int* Rt = reinterpret_cast<int*>(Bp + (kSums ? 3 * KT * HD : 0));
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
  const bool do_chk = check != nullptr;
  float* chk =
      do_chk ? check + ((size_t)n * gridDim.x + h) * 2 * SP * SP : nullptr;
  stage_head<HD, KT, kThreads>(Qs, head, row3, S, row_of, tid);
  stage_head<HD, KT, kThreads>(Ks, head + D, row3, S, row_of, tid);
  igemm::cp_async_commit();
  stage_head<HD, KT, kThreads>(Vs, head + 2 * D, row3, S, row_of, tid);
  stage_head<HD, KT, kThreads>(Ds, dout + h * HD, (size_t)D, S, row_of, tid);
  igemm::cp_async_commit();

  // ---- phase A: query tiles -> row statistics, dov, dq ----
#pragma unroll 1
  for (int round = 0; round < kRounds; ++round) {
    const int qt = warp + round * W;
    const bool active = qt < KT;  // warp-uniform
    if (round == 0) {  // q and k have landed
      igemm::cp_async_wait<1>();
      __syncthreads();
    }
    float p[2 * KT][4];
    float m[2], l[2], il[2];
    if (active) {
      uint32_t qa[KF][4];
#pragma unroll
      for (int kk = 0; kk < KF; ++kk)
        ldsm_x4(qa[kk], frag_a_addr(Qs, ld, qt * 16, kk * 16, lane));
      scores<HD, KT>(p, qa, Ks, S, scale, lane);
      softmax_rows<KT>(p, m, l);
      if (do_chk)
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            chk[(qt * 16 + g + 8 * (e >> 1)) * SP + j * 8 + 2 * t + (e & 1)] =
                p[j][e];
      il[0] = 1.0f / l[0];
      il[1] = 1.0f / l[1];
    }
    if (round == 0) {  // v and do have landed
      igemm::cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;
    float c[2] = {0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      tile_guard<KT>(S);
      float dp[2][4];
      dp_tile<HD>(dp, Ds, Vs, qt, kt, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[e >> 1] += __fmul_rn(p[2 * kt + j][e], dp[j][e]);
    }
    c[0] = __fmul_rn(quad_sum(c[0]), il[0]);
    c[1] = __fmul_rn(quad_sum(c[1]), il[1]);
    uint32_t dsa[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      tile_guard<KT>(S);
      float dp[2][4];
      dp_tile<HD>(dp, Ds, Vs, qt, kt, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[j][e] = ds_of(p[2 * kt + j][e], dp[j][e], c[e >> 1],
                           il[e >> 1]);
          if (do_chk)
            chk[SP * SP + (qt * 16 + g + 8 * (e >> 1)) * SP + kt * 16 +
                j * 8 + 2 * t + (e & 1)] = dp[j][e];
        }
      dsa[kt][0] = pack_bf16(dp[0][0], dp[0][1]);
      dsa[kt][1] = pack_bf16(dp[0][2], dp[0][3]);
      dsa[kt][2] = pack_bf16(dp[1][0], dp[1][1]);
      dsa[kt][3] = pack_bf16(dp[1][2], dp[1][3]);
    }
    float dq[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      tile_guard<KT>(S);
#pragma unroll
      for (int dn = 0; dn < KF; ++dn) {
        uint32_t b[4];
        ldsm_x4_trans(b, frag_a_addr(Ks, ld, kt * 16, dn * 16, lane));
        mma16816(dq[2 * dn], dsa[kt], b[0], b[1]);
        mma16816(dq[2 * dn + 1], dsa[kt], b[2], b[3]);
      }
    }
    const int r0 = qt * 16 + g;
    store_rows<HD>(dq, scale, dqkv, row3, h * HD, r0, S, row_of, lane,
                   kSums ? Bp + 3 * qt * HD : nullptr);
    // dov = bf16(do / l) (rows past S hold zeros) and the row statistics
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = j * 8 + 2 * t;
        const __nv_bfloat162 d =
            *reinterpret_cast<const __nv_bfloat162*>(Ds + r * ld + col);
        *reinterpret_cast<uint32_t*>(DOVs + r * ld + col) =
            pack_bf16(__fmul_rn(__low2float(d), il[half]),
                      __fmul_rn(__high2float(d), il[half]));
      }
      if (t == 0) {
        Mx[r] = m[half];
        Il[r] = il[half];
        Cr[r] = c[half];
      }
    }
  }
  __syncthreads();  // dov and the row statistics of every row are in place

  // ---- phase B: key tiles -> dk, dv ----
#pragma unroll 1
  for (int kt = warp; kt < KT; kt += W) {
    uint32_t kb[KF][4], vb[KF][4];
#pragma unroll
    for (int kk = 0; kk < KF; ++kk) {
      ldsm_x4(kb[kk], frag_bt_addr(Ks, ld, kt * 16, kk * 16, lane));
      ldsm_x4(vb[kk], frag_bt_addr(Vs, ld, kt * 16, kk * 16, lane));
    }
    float dv[HD / 8][4], dk[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[j][e] = dk[j][e] = 0.f;
#pragma unroll 1
    for (int qt = 0; qt < KT; ++qt) {
      // phase A's score and dp tiles of (qt, kt): the same mma on the same
      // fragments in the same order
      float st[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KF; ++kk) {
        uint32_t qa[4], da[4];
        ldsm_x4(qa, frag_a_addr(Qs, ld, qt * 16, kk * 16, lane));
        mma16816(st[0], qa, kb[kk][0], kb[kk][1]);
        mma16816(st[1], qa, kb[kk][2], kb[kk][3]);
        ldsm_x4(da, frag_a_addr(Ds, ld, qt * 16, kk * 16, lane));
        mma16816(dp[0], da, vb[kk][0], vb[kk][1]);
        mma16816(dp[1], da, vb[kk][2], vb[kk][3]);
      }
      const int q0 = qt * 16 + g;
      const float rm[2] = {Mx[q0], Mx[q0 + 8]};
      const float ri[2] = {Il[q0], Il[q0 + 8]};
      const float rc[2] = {Cr[q0], Cr[q0 + 8]};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kt * 16 + j * 8 + 2 * t + (e & 1);
          const float pv = p_of(st[j][e], scale, rm[e >> 1], key, S);
          dp[j][e] = ds_of(pv, dp[j][e], rc[e >> 1], ri[e >> 1]);
          st[j][e] = pv;
          if (do_chk) {
            const int at = (q0 + 8 * (e >> 1)) * SP + key;
            if (__float_as_uint(pv) != __float_as_uint(chk[at]) ||
                __float_as_uint(dp[j][e]) !=
                    __float_as_uint(chk[SP * SP + at]))
              atomicAdd(bad, 1u);
          }
        }
      uint32_t pt[4], dst[4];
      acc_to_at(pt, st);
      acc_to_at(dst, dp);
#pragma unroll
      for (int dn = 0; dn < KF; ++dn) {
        uint32_t b[4];
        ldsm_x4_trans(b, frag_a_addr(DOVs, ld, qt * 16, dn * 16, lane));
        mma16816(dv[2 * dn], pt, b[0], b[1]);
        mma16816(dv[2 * dn + 1], pt, b[2], b[3]);
        ldsm_x4_trans(b, frag_a_addr(Qs, ld, qt * 16, dn * 16, lane));
        mma16816(dk[2 * dn], dst, b[0], b[1]);
        mma16816(dk[2 * dn + 1], dst, b[2], b[3]);
      }
    }
    const int r0 = kt * 16 + g;
    store_rows<HD>(dk, scale, dqkv, row3, D + h * HD, r0, S, row_of, lane,
                   kSums ? Bp + (3 * kt + 1) * HD : nullptr);
    store_rows<HD>(dv, 1.0f, dqkv, row3, 2 * D + h * HD, r0, S, row_of, lane,
                   kSums ? Bp + (3 * kt + 2) * HD : nullptr);
  }
  if constexpr (!kSums) return;
  __syncthreads();  // every tile's sums are in place
  for (int i = tid; i < 3 * HD; i += kThreads) {
    const int part = i / HD;  // 0: q, 1: k, 2: v
    const int c = i - part * HD;
    float sum = 0.f;
    for (int tile = 0; tile < KT; ++tile) sum += Bp[(3 * tile + part) * HD + c];
    bpart[(size_t)n * row3 + part * D + h * HD + c] = sum;
  }
}

template <int HD, int KT, class Rows, bool kSums>
inline size_t mhsa_reg_bwd_smem_bytes(int S) {
  return 5 * (size_t)KT * 16 * (HD + 8) * sizeof(bf16) +
         3 * (size_t)KT * 16 * sizeof(float) +
         (kSums ? 3 * (size_t)KT * HD * sizeof(float) : 0) +
         row_table_bytes<Rows>(S);
}

// Launches the instance with KT = ceil(S / 16) key tiles.
template <int HD, class Rows, bool kSums, int KT = 1>
cudaError_t launch_mhsa_reg_bwd_tiles(const bf16* qkv, const bf16* dout,
                                      bf16* dqkv, float* bpart, float* check,
                                      unsigned* bad, int N, int S, int D,
                                      int H, float scale, Rows rows,
                                      cudaStream_t stream) {
  if constexpr (KT < kMaxTiles) {
    if ((S + 15) / 16 > KT)
      return launch_mhsa_reg_bwd_tiles<HD, Rows, kSums, KT + 1>(
          qkv, dout, dqkv, bpart, check, bad, N, S, D, H, scale, rows,
          stream);
  }
  auto kernel = mhsa_reg_bwd_kernel<HD, KT, Rows, kSums>;
  // set at the instance's first launch only, as in mhsa_reg.cuh
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mhsa_reg_bwd_smem_bytes<HD, KT, Rows, kSums>(16 * KT));
  if (configured != cudaSuccess) return configured;
  kernel<<<dim3(H, N), bwd_warps<KT>() * 32,
           mhsa_reg_bwd_smem_bytes<HD, KT, Rows, kSums>(S), stream>>>(
      qkv, dout, dqkv, bpart, check, bad, S, D, scale, rows);
  return cudaGetLastError();
}

}  // namespace reg

// check and bad: both null, or the kernel's recompute check
// (mhsa_reg_bwd_kernel; bad zeroed by the caller).
template <int HD, class Rows>
cudaError_t launch_mhsa_reg_bwd(const bf16* qkv, const bf16* dout,
                                bf16* dqkv, float* check, unsigned* bad,
                                int N, int S, int D, int H, float scale,
                                Rows rows, cudaStream_t stream) {
  if (N <= 0 || S <= 0 || S > 16 * reg::kMaxTiles || D != H * HD ||
      N > 65535 || (check == nullptr) != (bad == nullptr))
    return cudaErrorInvalidValue;
  return reg::launch_mhsa_reg_bwd_tiles<HD, Rows, false>(
      qkv, dout, dqkv, nullptr, check, bad, N, S, D, H, scale, rows, stream);
}

// The same with the units' column sums into bpart [N, 3D] fp32 (the half
// block's backward, ln_attention.cuh).
template <int HD, class Rows>
cudaError_t launch_mhsa_reg_bwd_sums(const bf16* qkv, const bf16* dout,
                                     bf16* dqkv, float* bpart, int N, int S,
                                     int D, int H, float scale, Rows rows,
                                     cudaStream_t stream) {
  if (N <= 0 || S <= 0 || S > 16 * reg::kMaxTiles || D != H * HD ||
      N > 65535 || bpart == nullptr)
    return cudaErrorInvalidValue;
  return reg::launch_mhsa_reg_bwd_tiles<HD, Rows, true>(
      qkv, dout, dqkv, bpart, nullptr, nullptr, N, S, D, H, scale, rows,
      stream);
}

}  // namespace vlp
