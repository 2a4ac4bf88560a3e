// Backward of ln_attention, y = x + OutProj(MHSA(LN(x))), over x [N, S, D].
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_block.py:_lnattn_bwd
// (body _attn_block_bwd_rows_unified, :395-423), the custom VJP of the
// public ln_attention. Returns all seven cotangents: dx bf16, dgamma, dbeta,
// dbqkv, dbout fp32 and dWqkv, dWout fp32-accumulated and cast to bf16 once.
//
// The TPU kernel recomputes LN, qkv and the softmax per sample in VMEM and
// carries the weight gradients across its sequential grid. On an H100 the
// blocks run in parallel and a block holds 227 KB, so the backward runs as
// launches of hand-written kernels on one stream, every product a wmma GEMM
// of gemm.cuh:
//
//   1. ln_rows:           ln  = bf16(LN(x) * gamma + beta)          [M, D]
//   2. gemm NT:           do  = bf16(dy @ Wout^T)                    [M, D]
//   3. mhsa_bwd_kernel:   dqkv = bf16([dq | dk | dv]) per head      [M, 3D]
//                         and per-sample fp32 column sums of dqkv
//   4. gemm TN, split-K:  dWout = o^T @ dy        (fp32 partials)
//   5. gemm TN, split-K:  dWqkv = ln^T @ dqkv     (fp32 partials)
//   6. gemm NT:           dln = dqkv @ Wqkv^T     fp32               [M, D]
//   7. ln_bwd_rows:       dx = bf16(dy + LN_bwd(dln * gamma)), partial sums
//                         of dln * x_hat, dln, dy per 256 rows
//   8. reduce_rows:       the partials in a fixed order -> dWout, dWqkv (bf16),
//                         dgamma, dbeta, dbout, dbqkv (fp32)
//
// (M = N * S.) qkv and o are not recomputed: the forward launch already
// writes them to device memory (ln_attention.cu), and the autograd Function
// keeps them for the backward: 4 * M * D bf16, 154 MB per level-0 block of
// NesT-Small at batch 64 (39 MB at level 1, 19 MB at level 2), 1.1 GB over
// the 24 blocks. They are the bf16 values the Pallas body recomputes. The
// workspace (ln, do, dqkv, dln and the partials) is 14 * M * D bytes plus
// the partials, 270 MB at level 0, reused by every block.
//
// The attention core (step 3) at S = 196, Dh = 32: one block per (sample,
// head) stages q, k, v and do (rows padded to 208 with zeros). Phase A: each
// of 4 warps takes 16-query tiles, computes the fp32 score and dp = do v^T
// rows with wmma into its own shared buffers, then per row p = exp(s - max),
// l, c = sum(p * dp) / l and ds = (p * dp - p * c) / l, written as bf16 over
// its own score row; dq = bf16(ds) @ k * scale, and dov = bf16(do / l). The
// row statistics (max, 1/l, c) stay in shared memory. Phase B: each warp
// takes 16-key tiles and, for every query tile, recomputes the 16x16 score
// and dp tiles (the same wmma sums as phase A, so the same p), forms p and
// ds for them, and accumulates dv += bf16(p)^T @ dov and dk += bf16(ds)^T @ q
// with col_major fragments, so no transpose is written. The rounding points
// are those of the Pallas body: bf16(p) with p unnormalised, bf16(do / l),
// bf16(ds), bf16(dqkv); dbqkv sums the fp32 dq, dk, dv. About 196 KB of
// shared memory at S = 196 (one block per SM); S <= 240.
//
// What bounds it on this card: the projection GEMMs' 16 * M * D^2 FLOPs
// (19 GFLOP at level 0 of NesT-Small at batch 64) and the core's 8 * S^2 *
// Dh FLOPs per (sample, head) are small; the launches stream qkv, o, dy, do,
// dqkv, dln and dx through device memory (about 40 bytes per element of x
// at D = 96), so the backward is bound by memory traffic and by the
// unpipelined GEMM's latency (gemm.cuh). Fusing the LN backward into the dln
// GEMM and keeping dqkv on chip are later work.
#include "bwd_rows.cuh"

namespace vlp {

constexpr int kBwdHeadDim = 32;
constexpr int kBwdWarps = 4;
constexpr int kBwdQkvLd = kBwdHeadDim + 8;  // bf16 pitch of a staged row
constexpr int kBwdMaxSeq = 240;
constexpr int kBwdKeysPerLane = 256 / 32;

// fp32 pitch of a warp's score and dp rows; at least 68 so that phase B's
// scratch (8,704 bytes) fits in a warp's two buffers.
__host__ __device__ inline int mhsa_bwd_lds(int S) {
  const int sp = (S + 15) / 16 * 16;
  return (sp > 64 ? sp : 64) + 4;
}

inline size_t mhsa_bwd_smem_bytes(int S) {
  const int sp = (S + 15) / 16 * 16;
  return 5 * (size_t)sp * kBwdQkvLd * sizeof(bf16) +
         (size_t)kBwdWarps * 2 * 16 * mhsa_bwd_lds(S) * sizeof(float) +
         3 * (size_t)sp * sizeof(float) +
         3 * (size_t)kBwdWarps * kBwdHeadDim * sizeof(float);
}

// grid (H, N); block kBwdWarps * 32 threads. qkv [N*S, 3D] and dout (do)
// [N*S, D] bf16 -> dqkv [N*S, 3D] bf16; bpart [N, 3D] fp32 column sums of
// this sample's fp32 dq, dk, dv.
__global__ void __launch_bounds__(kBwdWarps * 32)
    mhsa_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    bf16* __restrict__ dqkv, float* __restrict__ bpart, int S,
                    int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int tiles = (S + 15) / 16;
  const int sp = tiles * 16;
  const int lds = mhsa_bwd_lds(S);
  const int ldp = 2 * lds;  // bf16 pitch of ds rows written over score rows
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + sp * kBwdQkvLd;
  bf16* Vs = Ks + sp * kBwdQkvLd;
  bf16* Ds = Vs + sp * kBwdQkvLd;     // do
  bf16* DOVs = Ds + sp * kBwdQkvLd;   // bf16(do / l)
  float* Wbuf = reinterpret_cast<float*>(DOVs + sp * kBwdQkvLd);
  float* Mx = Wbuf + kBwdWarps * 2 * 16 * lds;  // row max of the scores
  float* Il = Mx + sp;                          // 1 / l
  float* Cr = Il + sp;                          // c = sum(p * dp) / l
  float* Col = Cr + sp;                         // [3][warps][32]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row3 = 3 * (size_t)D;
  const size_t row0 = (size_t)n * S;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // stage q, k, v and do of this (sample, head); rows S..sp-1 are zero
  constexpr int vecs = kBwdHeadDim / 8;
  for (int i = tid; i < 4 * sp * vecs; i += kBwdWarps * 32) {
    const int mat = i / (sp * vecs);
    const int rem = i % (sp * vecs);
    const int r = rem / vecs;
    const int c = (rem % vecs) * 8;
    uint4 v = zero;
    if (r < S) {
      const bf16* src = mat < 3
          ? qkv + (row0 + r) * row3 + mat * D + h * kBwdHeadDim + c
          : dout + (row0 + r) * D + h * kBwdHeadDim + c;
      v = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>(Qs + (size_t)mat * sp * kBwdQkvLd +
                              r * kBwdQkvLd + c) = v;
  }
  __syncthreads();

  float* S_w = Wbuf + warp * 2 * 16 * lds;
  float* DP_w = S_w + 16 * lds;
  bf16* P_w = reinterpret_cast<bf16*>(S_w);
  const float neg_inf = __int_as_float(0xff800000);
  float col_q = 0.f;

  // ---- phase A: query tiles -> row statistics, dov, dq ----
  for (int qt = warp; qt < tiles; qt += kBwdWarps) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[2],
        da[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wmma::load_matrix_sync(qa[kk], Qs + qt * 16 * kBwdQkvLd + kk * 16,
                             kBwdQkvLd);
      wmma::load_matrix_sync(da[kk], Ds + qt * 16 * kBwdQkvLd + kk * 16,
                             kBwdQkvLd);
    }
    for (int kt = 0; kt < tiles; ++kt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc, dc;
      wmma::fill_fragment(sc, 0.f);
      wmma::fill_fragment(dc, 0.f);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // col_major B: element (k, j) = K[kt*16 + j][kk*16 + k]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb,
            vb;
        wmma::load_matrix_sync(kb, Ks + kt * 16 * kBwdQkvLd + kk * 16,
                               kBwdQkvLd);
        wmma::load_matrix_sync(vb, Vs + kt * 16 * kBwdQkvLd + kk * 16,
                               kBwdQkvLd);
        wmma::mma_sync(sc, qa[kk], kb, sc);
        wmma::mma_sync(dc, da[kk], vb, dc);
      }
      wmma::store_matrix_sync(S_w + kt * 16, sc, lds, wmma::mem_row_major);
      wmma::store_matrix_sync(DP_w + kt * 16, dc, lds, wmma::mem_row_major);
    }
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const int row = qt * 16 + r;
      const float* srow = S_w + r * lds;
      const float* dprow = DP_w + r * lds;
      float p[kBwdKeysPerLane], t[kBwdKeysPerLane];
      float m = neg_inf;
#pragma unroll
      for (int i = 0; i < kBwdKeysPerLane; ++i) {
        const int j = lane + 32 * i;
        p[i] = j < S ? srow[j] * scale : neg_inf;
        m = fmaxf(m, p[i]);
      }
      m = warp_max(m);
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < kBwdKeysPerLane; ++i) {
        const int j = lane + 32 * i;
        p[i] = j < S ? expf(p[i] - m) : 0.f;
        l += p[i];
      }
      const float invl = 1.0f / warp_sum(l);
      float c = 0.f;
#pragma unroll
      for (int i = 0; i < kBwdKeysPerLane; ++i) {
        const int j = lane + 32 * i;
        t[i] = j < S ? p[i] * dprow[j] : 0.f;
        c += t[i];
      }
      c = warp_sum(c) * invl;
      __syncwarp();  // every lane has read score row r before ds overwrites it
      bf16* dsrow = P_w + r * ldp;
#pragma unroll
      for (int i = 0; i < kBwdKeysPerLane; ++i) {
        const int j = lane + 32 * i;
        if (j < sp) dsrow[j] = __float2bfloat16((t[i] - p[i] * c) * invl);
      }
      DOVs[row * kBwdQkvLd + lane] = __float2bfloat16(
          __bfloat162float(Ds[row * kBwdQkvLd + lane]) * invl);
      if (lane == 0) {
        Mx[row] = m;
        Il[row] = invl;
        Cr[row] = c;
      }
    }
    __syncwarp();

    // dq[16, Dh] = bf16(ds) @ k
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc[2];
    wmma::fill_fragment(oc[0], 0.f);
    wmma::fill_fragment(oc[1], 0.f);
    for (int kt = 0; kt < tiles; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, P_w + kt * 16, ldp);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kb;
        wmma::load_matrix_sync(kb, Ks + kt * 16 * kBwdQkvLd + j * 16,
                               kBwdQkvLd);
        wmma::mma_sync(oc[j], pa, kb, oc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(DP_w + j * 16, oc[j], lds, wmma::mem_row_major);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = qt * 16 + r;
      if (row < S) {
        const float v = DP_w[r * lds + lane] * scale;
        dqkv[(row0 + row) * row3 + h * kBwdHeadDim + lane] =
            __float2bfloat16(v);
        col_q += v;
      }
    }
    __syncwarp();  // the next tile's scores overwrite S_w and DP_w
  }
  Col[(0 * kBwdWarps + warp) * 32 + lane] = col_q;
  __syncthreads();  // dov and the row statistics of every row are in place

  // ---- phase B: key tiles -> dk, dv ----
  float* T1 = S_w;                                  // 16 x 20 fp32 scores
  float* T2 = T1 + 16 * 20;                         // 16 x 20 fp32 dp
  bf16* PB = reinterpret_cast<bf16*>(T2 + 16 * 20); // 16 x 24 bf16 p
  bf16* DSB = PB + 16 * 24;                         // 16 x 24 bf16 ds
  float* O1 = reinterpret_cast<float*>(DSB + 16 * 24);  // 16 x 36 fp32 dv
  float* O2 = O1 + 16 * 36;                             // 16 x 36 fp32 dk
  float col_k = 0.f, col_v = 0.f;
  for (int kt = warp; kt < tiles; kt += kBwdWarps) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb[2],
        vb[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      wmma::load_matrix_sync(kb[kk], Ks + kt * 16 * kBwdQkvLd + kk * 16,
                             kBwdQkvLd);
      wmma::load_matrix_sync(vb[kk], Vs + kt * 16 * kBwdQkvLd + kk * 16,
                             kBwdQkvLd);
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dva[2], dka[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(dva[j], 0.f);
      wmma::fill_fragment(dka[j], 0.f);
    }
    for (int qt = 0; qt < tiles; ++qt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc, dc;
      wmma::fill_fragment(sc, 0.f);
      wmma::fill_fragment(dc, 0.f);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa,
            da;
        wmma::load_matrix_sync(qa, Qs + qt * 16 * kBwdQkvLd + kk * 16,
                               kBwdQkvLd);
        wmma::load_matrix_sync(da, Ds + qt * 16 * kBwdQkvLd + kk * 16,
                               kBwdQkvLd);
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
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> ob,
            qb;
        wmma::load_matrix_sync(ob, DOVs + qt * 16 * kBwdQkvLd + j * 16,
                               kBwdQkvLd);
        wmma::load_matrix_sync(qb, Qs + qt * 16 * kBwdQkvLd + j * 16,
                               kBwdQkvLd);
        wmma::mma_sync(dva[j], pa, ob, dva[j]);
        wmma::mma_sync(dka[j], dsa, qb, dka[j]);
      }
      __syncwarp();  // T1, T2, PB and DSB are rewritten for the next tile
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(O1 + j * 16, dva[j], 36, wmma::mem_row_major);
      wmma::store_matrix_sync(O2 + j * 16, dka[j], 36, wmma::mem_row_major);
    }
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = kt * 16 + r;
      if (row < S) {
        const float dv = O1[r * 36 + lane];
        const float dk = O2[r * 36 + lane] * scale;
        bf16* dst = dqkv + (row0 + row) * row3 + h * kBwdHeadDim + lane;
        dst[D] = __float2bfloat16(dk);
        dst[2 * D] = __float2bfloat16(dv);
        col_k += dk;
        col_v += dv;
      }
    }
    __syncwarp();
  }
  Col[(1 * kBwdWarps + warp) * 32 + lane] = col_k;
  Col[(2 * kBwdWarps + warp) * 32 + lane] = col_v;
  __syncthreads();
  if (tid < 3 * 32) {
    const int part = tid >> 5;  // 0: q, 1: k, 2: v
    float s = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) s += Col[(part * kBwdWarps + w) * 32 + lane];
    bpart[(size_t)n * row3 + part * D + h * kBwdHeadDim + lane] = s;
  }
}

cudaError_t launch_mhsa_bwd(const bf16* qkv, const bf16* dout, bf16* dqkv,
                            float* bpart, int N, int S, int D, int H,
                            float scale, cudaStream_t stream) {
  if (N <= 0 || S <= 0 || S > kBwdMaxSeq || D != H * kBwdHeadDim ||
      N > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = mhsa_bwd_smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      mhsa_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mhsa_bwd_kernel<<<dim3(H, N), kBwdWarps * 32, smem, stream>>>(
      qkv, dout, dqkv, bpart, S, D, scale);
  return cudaGetLastError();
}

// Workspace pieces, in one order for the size query and the launch.
struct AttnBwdWs {
  bf16* ln;
  bf16* dout;
  bf16* dqkv;
  float* dln;
  float* bpart;   // [N, 3D]
  float* wpart;   // [splits, D, 3D] (dWout reuses it)
  float* rpart;   // [row blocks, 3, D]
  int s_out, s_qkv;
  size_t bytes;

  AttnBwdWs(void* base, int N, int S, int D) {
    const int M = N * S;
    s_out = weight_grad_splits(D, D, M);
    s_qkv = weight_grad_splits(D, 3 * D, M);
    const size_t wp = (size_t)D * D *
                      (s_out > 3 * s_qkv ? s_out : 3 * (size_t)s_qkv);
    Carver c{static_cast<char*>(base)};
    ln = c.take<bf16>((size_t)M * D);
    dout = c.take<bf16>((size_t)M * D);
    dqkv = c.take<bf16>((size_t)M * 3 * D);
    dln = c.take<float>((size_t)M * D);
    bpart = c.take<float>((size_t)N * 3 * D);
    wpart = c.take<float>(wp);
    rpart = c.take<float>((size_t)ln_bwd_row_blocks(M) * 3 * D);
    bytes = c.used;
  }
};

}  // namespace vlp

extern "C" size_t vlp_ln_attention_bwd_workspace(int N, int S, int D, int H) {
  (void)H;
  return vlp::AttnBwdWs(nullptr, N, S, D).bytes;
}

// x, dy, dx [N, S, D] bf16; wqkv [D, 3D], wout [D, D] bf16 ([in, out]);
// qkv [N, S, 3D] and o [N, S, D] bf16 from the forward launch; gamma, beta
// [D] fp32. Outputs: dgamma, dbeta, dbout [D] and dbqkv [3D] fp32; dwqkv,
// dwout bf16 like the weights. ws: vlp_ln_attention_bwd_workspace bytes.
// Returns the first failing cudaError_t.
extern "C" int vlp_ln_attention_bwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* wout, const void* qkv, const void* o, const void* dy,
    void* dx, void* dgamma, void* dbeta, void* dwqkv, void* dbqkv,
    void* dwout, void* dbout, void* ws, int N, int S, int D, int H,
    float scale, float eps, void* stream) {
  using vlp::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = N * S;
  const vlp::AttnBwdWs w(ws, N, S, D);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const float* g = static_cast<const float*>(gamma);
  cudaError_t err = vlp::launch_ln_rows(xb, g, static_cast<const float*>(beta),
                                        w.ln, M, D, eps, st);
  if (err != cudaSuccess) return (int)err;
  // do = dy @ Wout^T
  err = vlp::launch_gemm_ex<false, false, true, vlp::kEpiBf16>(
      dyb, nullptr, nullptr, static_cast<const bf16*>(wout), nullptr, nullptr,
      nullptr, w.dout, nullptr, M, D, D, 1, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_mhsa_bwd(static_cast<const bf16*>(qkv), w.dout, w.dqkv,
                             w.bpart, N, S, D, H, scale, st);
  if (err != cudaSuccess) return (int)err;
  // dWout = o^T @ dy
  err = vlp::launch_gemm_ex<false, true, false, vlp::kEpiF32>(
      static_cast<const bf16*>(o), nullptr, nullptr, dyb, nullptr, nullptr,
      nullptr, w.wpart, nullptr, D, D, M, w.s_out, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_reduce_rows(w.wpart, static_cast<bf16*>(dwout), w.s_out,
                                (size_t)D * D, (size_t)D * D, st);
  if (err != cudaSuccess) return (int)err;
  // dWqkv = ln^T @ dqkv
  err = vlp::launch_gemm_ex<false, true, false, vlp::kEpiF32>(
      w.ln, nullptr, nullptr, w.dqkv, nullptr, nullptr, nullptr, w.wpart,
      nullptr, D, 3 * D, M, w.s_qkv, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_reduce_rows(w.wpart, static_cast<bf16*>(dwqkv), w.s_qkv,
                                (size_t)D * 3 * D, (size_t)D * 3 * D, st);
  if (err != cudaSuccess) return (int)err;
  // dln = dqkv @ Wqkv^T
  err = vlp::launch_gemm_ex<false, false, true, vlp::kEpiF32>(
      w.dqkv, nullptr, nullptr, static_cast<const bf16*>(wqkv), nullptr,
      nullptr, nullptr, w.dln, nullptr, M, D, 3 * D, 1, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_ln_bwd_rows(xb, g, w.dln, dyb, static_cast<bf16*>(dx),
                                w.rpart, M, D, eps, st);
  if (err != cudaSuccess) return (int)err;
  const int rb = vlp::ln_bwd_row_blocks(M);
  float* outs[3] = {static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                    static_cast<float*>(dbout)};
  for (int k = 0; k < 3; ++k) {
    err = vlp::launch_reduce_rows(w.rpart + (size_t)k * D, outs[k], rb,
                                  (size_t)3 * D, (size_t)D, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = vlp::launch_reduce_rows(w.bpart, static_cast<float*>(dbqkv), N,
                                (size_t)3 * D, (size_t)3 * D, st);
  return (int)err;
}
