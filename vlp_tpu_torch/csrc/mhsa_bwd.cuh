// The wmma attention-core backward of the probe #16 (attn_sched_bwd.cu,
// modes v0 and stage2) alone; the half-block backwards #3 and #6 and the
// standalone packed-qkv attention backward #8 run the register-resident
// core of mhsa_reg_bwd.cuh instead.
// From qkv [N, S, 3D] and do [N, S, D] bf16
// to dqkv = bf16([dq | dk | dv]) [N, S, 3D], the body of
// vlp_tpu/ops/block_attention.py:109-144 (and fused_block.py's
// _attn_block_bwd_rows_unified). Optionally per-sample fp32 column sums of
// dq, dk, dv (the half block's dbqkv). A row map (attn_rows.cuh) says which
// rows of qkv, do and dqkv make up unit n: a sample (IdentityRows), or a
// NesT window of a [B, H, W, *] map (WindowRows, whose column sums then come
// per window, in window order).
//
// One block per (sample, head) stages q, k, v and do (rows padded to sp, a
// multiple of 16, with zeros; the steps it shares with the probe #16's
// single-softmax core are device functions below). Phase A: each warp takes 16-query tiles,
// computes the fp32 score and dp = do v^T rows with wmma into its own shared
// buffers, then per row p = exp(s - max), l, c = sum(p * dp) / l and
// ds = (p * dp - p * c) / l, written as bf16 over its own score row;
// dq = bf16(ds) @ k * scale, and dov = bf16(do / l). The row statistics
// (max, 1/l, c) stay in shared memory. Phase B: each warp takes 16-key tiles
// and, for every query tile, recomputes the 16x16 score and dp tiles (the
// same wmma sums as phase A, so the same p), forms p and ds for them, and
// accumulates dv += bf16(p)^T @ dov and dk += bf16(ds)^T @ q with col_major
// fragments, so no transpose is written. The rounding points are those of
// the Pallas bodies: bf16(p) with p unnormalised, bf16(do / l), bf16(ds),
// bf16(dqkv); the column sums add the fp32 dq, dk, dv. Every sum runs in a
// fixed order, so reruns agree bit for bit.
//
// Shared memory: 5 staged matrices of sp x (HD + 8) bf16, and per warp an
// fp32 score and a dp row block of 16 x lds (a window map adds its row
// table, S ints: 221 KB at S = 240). Its users run HD = 32, where four
// warps take 196 KB at S = 196 (S <= 240); at HD = 64 the staged rows and
// four warps' rows would not fit the 232,448 bytes a block may have.
//
// What bounds it on this card: 8 * S^2 * HD FLOPs (plus the phase-B
// recompute, another 4 * S^2 * HD) per (sample, head) on 14 * S * HD bytes
// of qkv, do and dqkv: at S = 196 that is above 100 FLOP/byte but below the
// bf16 ridge (~295), so the ideal kernel is bound by device memory; this
// form, one block per SM with the score tiles round-tripping shared memory,
// is bound by latency.
#pragma once

#include "attn_rows.cuh"
#include "gemm.cuh"

namespace vlp {

constexpr int kBwdKeysPerLane = 256 / 32;

// Warps per block of the backward core.
template <int HD>
__host__ __device__ constexpr int mhsa_bwd_warps() { return 4; }

// fp32 pitch of a warp's score and dp rows; at least HD + 36 so that phase
// B's scratch (two 16 x 20 fp32 tiles, two 16 x 24 bf16 tiles and two
// 16 x (HD + 4) fp32 tiles) fits in a warp's two buffers.
template <int HD>
__host__ __device__ inline int mhsa_bwd_lds(int S) {
  const int sp = (S + 15) / 16 * 16;
  return sp + 4 > HD + 36 ? sp + 4 : HD + 36;
}

template <int HD, class Rows>
inline size_t mhsa_bwd_smem_bytes(int S) {
  constexpr int warps = mhsa_bwd_warps<HD>();
  const int sp = (S + 15) / 16 * 16;
  return 5 * (size_t)sp * (HD + 8) * sizeof(bf16) +
         (size_t)warps * 2 * 16 * mhsa_bwd_lds<HD>(S) * sizeof(float) +
         3 * (size_t)sp * sizeof(float) +
         3 * (size_t)warps * HD * sizeof(float) + row_table_bytes<Rows>(S);
}

// The pieces of the backward core, shared with the probe #16's
// single-softmax core (attn_sched_bwd.cu:mhsa_uni_bwd_kernel).

// Stages q, k, v and do of head h of one unit ([sp, HD + 8] bf16 each, rows
// S..sp-1 zero); every thread of the block calls it.
template <int HD, class Rows>
__device__ __forceinline__ void mhsa_bwd_stage(
    const bf16* __restrict__ qkv, const bf16* __restrict__ dout, bf16* Qs,
    int S, int sp, int D, int h, const UnitRows<Rows>& row_of, int tid,
    int threads) {
  constexpr int ld = HD + 8;
  constexpr int vecs = HD / 8;
  const size_t row3 = 3 * (size_t)D;
  for (int i = tid; i < 4 * sp * vecs; i += threads) {
    const int mat = i / (sp * vecs);
    const int rem = i % (sp * vecs);
    const int r = rem / vecs;
    const int c = (rem % vecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < S) {
      const size_t g = row_of(r);
      const bf16* src = mat < 3 ? qkv + g * row3 + mat * D + h * HD + c
                                : dout + g * D + h * HD + c;
      v = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>(Qs + (size_t)mat * sp * ld + r * ld + c) = v;
  }
}

// The fp32 score rows S_w[16, sp] = Q[qt] K^T and DP_w[16, sp] = do[qt] V^T
// of one query tile (unscaled), pitch lds; one warp.
template <int HD>
__device__ __forceinline__ void mhsa_bwd_scores(const bf16* Qs,
                                                const bf16* Ks,
                                                const bf16* Vs,
                                                const bf16* Ds, int qt,
                                                int tiles, float* S_w,
                                                float* DP_w, int lds) {
  constexpr int ld = HD + 8;
  constexpr int kf = HD / 16;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[kf],
      da[kf];
#pragma unroll
  for (int kk = 0; kk < kf; ++kk) {
    wmma::load_matrix_sync(qa[kk], Qs + qt * 16 * ld + kk * 16, ld);
    wmma::load_matrix_sync(da[kk], Ds + qt * 16 * ld + kk * 16, ld);
  }
  for (int kt = 0; kt < tiles; ++kt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc, dc;
    wmma::fill_fragment(sc, 0.f);
    wmma::fill_fragment(dc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kf; ++kk) {
      // col_major B: element (k, j) = K[kt*16 + j][kk*16 + k]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb,
          vb;
      wmma::load_matrix_sync(kb, Ks + kt * 16 * ld + kk * 16, ld);
      wmma::load_matrix_sync(vb, Vs + kt * 16 * ld + kk * 16, ld);
      wmma::mma_sync(sc, qa[kk], kb, sc);
      wmma::mma_sync(dc, da[kk], vb, dc);
    }
    wmma::store_matrix_sync(S_w + kt * 16, sc, lds, wmma::mem_row_major);
    wmma::store_matrix_sync(DP_w + kt * 16, dc, lds, wmma::mem_row_major);
  }
  __syncwarp();
}

// One row's softmax and its backward statistics, by one warp: lane's keys
// j = lane + 32 i get p[i] = exp(s * scale - m) and t[i] = p[i] * dp (0 for
// j >= S); invl = 1 / sum(p), c = sum(t) * invl. ds = (t - p * c) * invl.
struct BwdRow {
  float p[kBwdKeysPerLane], t[kBwdKeysPerLane];
  float m, invl, c;
};

__device__ __forceinline__ BwdRow mhsa_bwd_row(const float* srow,
                                               const float* dprow, int S,
                                               float scale, int lane) {
  BwdRow b;
  b.m = __int_as_float(0xff800000);
#pragma unroll
  for (int i = 0; i < kBwdKeysPerLane; ++i) {
    const int j = lane + 32 * i;
    b.p[i] = j < S ? srow[j] * scale : __int_as_float(0xff800000);
    b.m = fmaxf(b.m, b.p[i]);
  }
  b.m = warp_max(b.m);
  float l = 0.f;
#pragma unroll
  for (int i = 0; i < kBwdKeysPerLane; ++i) {
    const int j = lane + 32 * i;
    b.p[i] = j < S ? expf(b.p[i] - b.m) : 0.f;
    l += b.p[i];
  }
  b.invl = 1.0f / warp_sum(l);
  float c = 0.f;
#pragma unroll
  for (int i = 0; i < kBwdKeysPerLane; ++i) {
    const int j = lane + 32 * i;
    b.t[i] = j < S ? b.p[i] * dprow[j] : 0.f;
    c += b.t[i];
  }
  b.c = warp_sum(c) * b.invl;
  return b;
}

// dk = dk_t * scale and dv = dv_t (fp32 16 x HD tiles at pitch ldt) of key
// tile kt -> bf16 into dqkv's k and v parts, their column sums into col_k,
// col_v; one warp.
template <int HD, class Rows>
__device__ __forceinline__ void mhsa_bwd_store_kv(
    const float* dv_t, const float* dk_t, int ldt, int kt, int S,
    bf16* __restrict__ dqkv, int D, int h, float scale,
    const UnitRows<Rows>& row_of, int lane, float* col_k, float* col_v) {
  constexpr int cl = HD / 32;
  const size_t row3 = 3 * (size_t)D;
  for (int r = 0; r < 16; ++r) {
    const int row = kt * 16 + r;
    if (row < S) {
      bf16* dst_row = dqkv + row_of(row) * row3 + h * HD;
#pragma unroll
      for (int j = 0; j < cl; ++j) {
        const int col = lane + 32 * j;
        const float dv = dv_t[r * ldt + col];
        const float dk = dk_t[r * ldt + col] * scale;
        bf16* dst = dst_row + col;
        dst[D] = __float2bfloat16(dk);
        dst[2 * D] = __float2bfloat16(dv);
        col_k[j] += dk;
        col_v[j] += dv;
      }
    }
  }
  __syncwarp();
}

// The unit's column sums of dq, dk, dv, from each warp's in Col
// [3][warps][HD], in warp order, into bpart[n] ([3D] fp32).
template <int HD>
__device__ __forceinline__ void mhsa_bwd_bias_parts(const float* Col,
                                                    float* __restrict__ bpart,
                                                    int n, int D, int h,
                                                    int warps, int tid) {
  for (int i = tid; i < 3 * HD; i += warps * 32) {
    const int part = i / HD;  // 0: q, 1: k, 2: v
    const int c = i % HD;
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += Col[(part * warps + w) * HD + c];
    bpart[(size_t)n * 3 * D + part * D + h * HD + c] = s;
  }
}

// grid (H, N); block mhsa_bwd_warps<HD>() * 32 threads. qkv [N*S, 3D] and
// dout (do) [N*S, D] bf16 -> dqkv [N*S, 3D] bf16; bpart [N, 3D] fp32 column
// sums of this unit's fp32 dq, dk, dv, unless null. Token r of unit n is row
// rows(n, r) of qkv, dout and dqkv.
template <int HD, class Rows>
__global__ void __launch_bounds__(mhsa_bwd_warps<HD>() * 32)
    mhsa_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    bf16* __restrict__ dqkv, float* __restrict__ bpart, int S,
                    int D, float scale, Rows rows) {
  constexpr int warps = mhsa_bwd_warps<HD>();
  constexpr int ld = HD + 8;   // bf16 pitch of a staged row
  constexpr int kf = HD / 16;  // wmma fragments across the head dim
  constexpr int cl = HD / 32;  // head-dim columns per lane
  constexpr int ldo = HD + 4;  // fp32 pitch of phase B's dv, dk tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int tiles = (S + 15) / 16;
  const int sp = tiles * 16;
  const int lds = mhsa_bwd_lds<HD>(S);
  const int ldp = 2 * lds;  // bf16 pitch of ds rows written over score rows
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + sp * ld;
  bf16* Vs = Ks + sp * ld;
  bf16* Ds = Vs + sp * ld;     // do
  bf16* DOVs = Ds + sp * ld;   // bf16(do / l)
  float* Wbuf = reinterpret_cast<float*>(DOVs + sp * ld);
  float* Mx = Wbuf + warps * 2 * 16 * lds;  // row max of the scores
  float* Il = Mx + sp;                      // 1 / l
  float* Cr = Il + sp;                      // c = sum(p * dp) / l
  float* Col = Cr + sp;                     // [3][warps][HD]
  int* Rt = reinterpret_cast<int*>(Col + 3 * warps * HD);  // row table

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row3 = 3 * (size_t)D;
  const UnitRows<Rows> row_of = unit_rows(rows, n, S, Rt, tid, warps * 32);

  mhsa_bwd_stage<HD>(qkv, dout, Qs, S, sp, D, h, row_of, tid, warps * 32);
  __syncthreads();

  float* S_w = Wbuf + warp * 2 * 16 * lds;
  float* DP_w = S_w + 16 * lds;
  bf16* P_w = reinterpret_cast<bf16*>(S_w);
  float col_q[cl];
#pragma unroll
  for (int j = 0; j < cl; ++j) col_q[j] = 0.f;

  // ---- phase A: query tiles -> row statistics, dov, dq ----
  for (int qt = warp; qt < tiles; qt += warps) {
    mhsa_bwd_scores<HD>(Qs, Ks, Vs, Ds, qt, tiles, S_w, DP_w, lds);
    for (int r = 0; r < 16; ++r) {
      const int row = qt * 16 + r;
      const BwdRow b = mhsa_bwd_row(S_w + r * lds, DP_w + r * lds, S, scale,
                                    lane);
      __syncwarp();  // every lane has read score row r before ds overwrites it
      bf16* dsrow = P_w + r * ldp;
#pragma unroll
      for (int i = 0; i < kBwdKeysPerLane; ++i) {
        const int j = lane + 32 * i;
        if (j < sp)
          dsrow[j] = __float2bfloat16((b.t[i] - b.p[i] * b.c) * b.invl);
      }
#pragma unroll
      for (int j = 0; j < cl; ++j) {
        const int col = lane + 32 * j;
        DOVs[row * ld + col] = __float2bfloat16(
            __bfloat162float(Ds[row * ld + col]) * b.invl);
      }
      if (lane == 0) {
        Mx[row] = b.m;
        Il[row] = b.invl;
        Cr[row] = b.c;
      }
    }
    __syncwarp();

    // dq[16, HD] = bf16(ds) @ k
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc[kf];
#pragma unroll
    for (int j = 0; j < kf; ++j) wmma::fill_fragment(oc[j], 0.f);
    for (int kt = 0; kt < tiles; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, P_w + kt * 16, ldp);
#pragma unroll
      for (int j = 0; j < kf; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kb;
        wmma::load_matrix_sync(kb, Ks + kt * 16 * ld + j * 16, ld);
        wmma::mma_sync(oc[j], pa, kb, oc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kf; ++j)
      wmma::store_matrix_sync(DP_w + j * 16, oc[j], lds, wmma::mem_row_major);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = qt * 16 + r;
      if (row < S) {
        bf16* dst = dqkv + row_of(row) * row3 + h * HD;
#pragma unroll
        for (int j = 0; j < cl; ++j) {
          const int col = lane + 32 * j;
          const float v = DP_w[r * lds + col] * scale;
          dst[col] = __float2bfloat16(v);
          col_q[j] += v;
        }
      }
    }
    __syncwarp();  // the next tile's scores overwrite S_w and DP_w
  }
#pragma unroll
  for (int j = 0; j < cl; ++j)
    Col[(0 * warps + warp) * HD + lane + 32 * j] = col_q[j];
  __syncthreads();  // dov and the row statistics of every row are in place

  // ---- phase B: key tiles -> dk, dv ----
  float* T1 = S_w;                                  // 16 x 20 fp32 scores
  float* T2 = T1 + 16 * 20;                         // 16 x 20 fp32 dp
  bf16* PB = reinterpret_cast<bf16*>(T2 + 16 * 20); // 16 x 24 bf16 p
  bf16* DSB = PB + 16 * 24;                         // 16 x 24 bf16 ds
  float* O1 = reinterpret_cast<float*>(DSB + 16 * 24);  // 16 x ldo fp32 dv
  float* O2 = O1 + 16 * ldo;                            // 16 x ldo fp32 dk
  float col_k[cl], col_v[cl];
#pragma unroll
  for (int j = 0; j < cl; ++j) col_k[j] = col_v[j] = 0.f;
  for (int kt = warp; kt < tiles; kt += warps) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb[kf],
        vb[kf];
#pragma unroll
    for (int kk = 0; kk < kf; ++kk) {
      wmma::load_matrix_sync(kb[kk], Ks + kt * 16 * ld + kk * 16, ld);
      wmma::load_matrix_sync(vb[kk], Vs + kt * 16 * ld + kk * 16, ld);
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dva[kf], dka[kf];
#pragma unroll
    for (int j = 0; j < kf; ++j) {
      wmma::fill_fragment(dva[j], 0.f);
      wmma::fill_fragment(dka[j], 0.f);
    }
    for (int qt = 0; qt < tiles; ++qt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc, dc;
      wmma::fill_fragment(sc, 0.f);
      wmma::fill_fragment(dc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kf; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa,
            da;
        wmma::load_matrix_sync(qa, Qs + qt * 16 * ld + kk * 16, ld);
        wmma::load_matrix_sync(da, Ds + qt * 16 * ld + kk * 16, ld);
        wmma::mma_sync(sc, qa, kb[kk], sc);
        wmma::mma_sync(dc, da, vb[kk], dc);
      }
      wmma::store_matrix_sync(T1, sc, 20, wmma::mem_row_major);
      wmma::store_matrix_sync(T2, dc, 20, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4;
        const int cc = e & 15;
        const int i = qt * 16 + r;
        const int j = kt * 16 + cc;
        float p = 0.f, ds = 0.f;
        if (i < S && j < S) {
          p = expf(T1[r * 20 + cc] * scale - Mx[i]);
          const float t = p * T2[r * 20 + cc];
          ds = (t - p * Cr[i]) * Il[i];
        }
        PB[r * 24 + cc] = __float2bfloat16(p);
        DSB[r * 24 + cc] = __float2bfloat16(ds);
      }
      __syncwarp();
      // col_major A = PB^T: element (key j, query i) at PB[i * 24 + j]
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pa,
          dsa;
      wmma::load_matrix_sync(pa, PB, 24);
      wmma::load_matrix_sync(dsa, DSB, 24);
#pragma unroll
      for (int j = 0; j < kf; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> ob,
            qb;
        wmma::load_matrix_sync(ob, DOVs + qt * 16 * ld + j * 16, ld);
        wmma::load_matrix_sync(qb, Qs + qt * 16 * ld + j * 16, ld);
        wmma::mma_sync(dva[j], pa, ob, dva[j]);
        wmma::mma_sync(dka[j], dsa, qb, dka[j]);
      }
      __syncwarp();  // T1, T2, PB and DSB are rewritten for the next tile
    }
#pragma unroll
    for (int j = 0; j < kf; ++j) {
      wmma::store_matrix_sync(O1 + j * 16, dva[j], ldo, wmma::mem_row_major);
      wmma::store_matrix_sync(O2 + j * 16, dka[j], ldo, wmma::mem_row_major);
    }
    __syncwarp();
    mhsa_bwd_store_kv<HD>(O1, O2, ldo, kt, S, dqkv, D, h, scale, row_of,
                          lane, col_k, col_v);
  }
#pragma unroll
  for (int j = 0; j < cl; ++j) {
    Col[(1 * warps + warp) * HD + lane + 32 * j] = col_k[j];
    Col[(2 * warps + warp) * HD + lane + 32 * j] = col_v[j];
  }
  __syncthreads();
  if (bpart != nullptr)
    mhsa_bwd_bias_parts<HD>(Col, bpart, n, D, h, warps, tid);
}

// Largest S the kernel's shared memory takes at head dim HD: 240 at
// HD = 32 (a row table does not change it).
template <int HD, class Rows>
inline int mhsa_bwd_max_seq() {
  int s = 16;
  while (s + 16 <= 256 && mhsa_bwd_smem_bytes<HD, Rows>(s + 16) <= 232448)
    s += 16;
  return s;
}

template <int HD, class Rows>
cudaError_t launch_mhsa_bwd(const bf16* qkv, const bf16* dout, bf16* dqkv,
                            float* bpart, int N, int S, int D, int H,
                            float scale, Rows rows, cudaStream_t stream) {
  if (N <= 0 || S <= 0 || S > mhsa_bwd_max_seq<HD, Rows>() || D != H * HD ||
      N > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = mhsa_bwd_smem_bytes<HD, Rows>(S);
  cudaError_t err = cudaFuncSetAttribute(
      mhsa_bwd_kernel<HD, Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  mhsa_bwd_kernel<HD, Rows><<<dim3(H, N), mhsa_bwd_warps<HD>() * 32, smem,
                              stream>>>(qkv, dout, dqkv, bpart, S, D, scale,
                                        rows);
  return cudaGetLastError();
}

}  // namespace vlp
