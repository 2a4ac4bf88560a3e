// mlp_tile_bwd: the backward of mlp_tile's full form, y = x + (h @ W2 + b2),
// h = bf16(gelu(LN(x) * gamma + beta) @ W1 + b1)), over x [M, D] rows.
// Returns dx bf16 and dgamma, dbeta, dW1, db1, dW2, db2 all fp32, each summed
// over every row.
//
// Replaces the Pallas TPU kernel benchmarks/mega_variants.py:make_mlp_bwd
// with the body mlp_bwd_kernel_v0 (:173), the schedule probe of the half
// block's MLP backward (rowpipe :213 and the production fsplit body are
// Mosaic interleavings of the same sums). Its rounding points (:185-210):
// ln = bf16(x_hat * gamma + beta), z = ln @ W1 + b1 in fp32,
// h = bf16(gelu(z)) and gelu'(z) separately (not the shipped #4's
// _gelu_and_grad form), dh = bf16((dy @ W2^T) * gelu'(z)), db1 from the fp32
// product, dln = dh @ W1^T in fp32, dx = bf16(dy + LN_bwd(dln * gamma)).
//
// The TPU kernel carries dW1 and dW2 (2 x 2.36 MB fp32 at the probe's
// D = 384, F = 1536) across its sequential grid in VMEM; no block here can
// hold them, and blocks run in no order. So:
//
//   1. mlp_tile_bwd_kernel, one block per TM-row tile (256 threads): stages
//      x and dy, normalises x in shared memory (keeping each row's mean and
//      1/sigma) and writes ln; walks F in slices of FS columns. Phase A of a
//      slice streams [64, FS] chunks of W1 and [FS, 64] chunks of W2 through
//      a cp.async ring and forms z = ln @ W1[:, s] and dy @ W2[s, :]^T side
//      by side in registers; they meet in shared memory, where each element
//      gets h, gelu'(z), dh32 and dh; h and dh go to device memory (for the
//      weight gradients), dh also to shared memory, and the tile's column
//      sums of dh32 (rows in order) to a db1 partial. Phase B streams
//      [D, 32] chunks of W1 and accumulates dln += dh_s @ W1[:, s]^T in
//      registers. After the walk dln goes through shared memory (over the
//      ln tile and the ring, no longer needed) and one warp per row forms
//      dx, with the tile's column sums of dln * x_hat, dln and dy (warps'
//      sums added in warp order) as partials of dgamma, dbeta and db2.
//   2. dW2 = h^T @ dy and dW1 = ln^T @ dh: gemm.cuh's split-K TN launches
//      into fp32 partials, each reduced in a fixed order.
//   3. the partials of dgamma, dbeta, db2 and db1 reduced in tile order.
//
// No float atomics: reruns agree bit for bit. Like the shipped #4
// (ln_mlp_bwd.cu, whose dual tile keeps gelu'(z) in registers) it never
// stores gelu'(z); beyond #4 it also drops the fp32 dln round trip
// (8 * M * D bytes) and the separate ln, dln and LN backward launches,
// which fold into step 1.
//
// Budget at TM = 64, FS = 64, D = 384: registers hold dln (64 x 384 fp32,
// 96 a thread) and the slice's z and dy W2^T fragments (32 a thread).
// Shared memory: ln and dy tiles 2 x 64 x 392 bf16 (100 KB), the ring
// 2 x 384 x 40 bf16 (61 KB, the larger of phase A's 18 KB and phase B's
// 30 KB stage), z and dy W2^T 2 x 64 x 68 fp32 (35 KB), dh 64 x 72 bf16
// (9 KB), row statistics: 206 KB of the 227 KB a block may have. dln
// (64 x 388 fp32, 99 KB) later takes the ln tile and the ring (111 KB).
// TM = 64 with FS = 128 needs 257 KB, so the instances are (64, 64),
// (32, 64) and (32, 128).
//
// What bounds it on this card: 10 * M * D * F operations in five products
// (148 GFLOP at the probe's shape, 0.150 ms at 989 TFLOP/s) against
// 6 * M * D bytes of x, dy and dx plus the weights: the tensor cores. The
// kernel writes ln, h and dh (2 * M * (D + 2F) bytes, 173 MB at the probe)
// for the two weight-gradient GEMMs, which read them back, and the
// unpipelined split-K GEMM of gemm.cuh runs far below the bf16 peak.
#include "bwd_rows.cuh"
#include "mlp_tile.cuh"

namespace vlp {
namespace mlpt {

constexpr int kBKA = 64;  // D per phase-A step
constexpr int kBKB = 32;  // F per phase-B step
constexpr int kBwdStages = 2;

__host__ __device__ inline int bwd_stage_elems(int FS, int D) {
  const int a = kBKA * (FS + 8) + FS * (kBKA + 8);
  const int b = D * (kBKB + 8);
  return a > b ? a : b;
}

// bytes of (the ln tile and the ring, the rest), dln takes the first part
inline size_t bwd_head_bytes(int TM, int FS, int D) {
  return (size_t)TM * (D + 8) * sizeof(bf16) +
         (size_t)kBwdStages * bwd_stage_elems(FS, D) * sizeof(bf16);
}

inline size_t bwd_smem_bytes(int TM, int FS, int D) {
  return bwd_head_bytes(TM, FS, D) + (size_t)TM * (D + 8) * sizeof(bf16) +
         2 * (size_t)TM * (FS + 4) * sizeof(float) +
         (size_t)TM * (FS + 8) * sizeof(bf16) + 2 * (size_t)TM * sizeof(float);
}

template <int TM, int FS>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_tile_bwd_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const bf16* __restrict__ w1,
                        const float* __restrict__ b1,
                        const bf16* __restrict__ w2,
                        const bf16* __restrict__ dy, bf16* __restrict__ dx,
                        bf16* __restrict__ ln_out, bf16* __restrict__ h_out,
                        bf16* __restrict__ dh_out, float* __restrict__ b1part,
                        float* __restrict__ rpart, int M, int D, int F,
                        float eps) {
  static_assert(TM == 32 || TM == 64, "two row groups of 1 or 2 fragments");
  static_assert(FS == 64 || FS == 128, "four column groups of 16 or 32");
  constexpr int MF = TM / 32;
  constexpr int NF1 = FS / 64;
  constexpr int LDA = FS + 8;    // W1 chunk [kBKA][FS]
  constexpr int LDB = kBKA + 8;  // W2 chunk [FS][kBKA]
  constexpr int LDC = kBKB + 8;  // W1 chunk [D][kBKB]
  constexpr int LDZ = FS + 4;    // zS, rS [TM][FS] fp32
  constexpr int LDH = FS + 8;    // dhS [TM][FS] bf16
  constexpr int PL = kMaxD / 32;
  const int ldx = D + 8;  // ln and dy tiles
  const int ldl = D + 4;  // dln [TM][D] fp32
  const int nf2 = D / 64;
  const int stage = bwd_stage_elems(FS, D);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* lnS = reinterpret_cast<bf16*>(smem);
  bf16* ring = lnS + TM * ldx;
  bf16* dyS = ring + kBwdStages * stage;
  float* zS = reinterpret_cast<float*>(dyS + TM * ldx);
  float* rS = zS + TM * LDZ;
  bf16* dhS = reinterpret_cast<bf16*>(rS + TM * LDZ);
  float* stats = reinterpret_cast<float*>(dhS + TM * LDH);
  float* dlnS = reinterpret_cast<float*>(smem);  // after the walk

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = (warp >> 2) * (TM / 2);
  const int wc = warp & 3;
  const int m0 = blockIdx.x * TM;

  load_tile_rows(lnS, ldx, x, m0, M, D, TM);
  load_tile_rows(dyS, ldx, dy, m0, M, D, TM);
  cp_async_commit();
  const int ka = D / kBKA;
  const int per = ka + FS / kBKB;
  const int steps = F / FS * per;
  auto load = [&](int t) {
    bf16* st = ring + (t % kBwdStages) * stage;
    const int u = t % per;
    const int f0 = t / per * FS;
    if (u < ka) {
      const int d0 = u * kBKA;
      for (int i = tid; i < kBKA * (FS / 8); i += kThreads) {
        const int r = i / (FS / 8);
        const int c = (i % (FS / 8)) * 8;
        cp_async16(st + r * LDA + c, w1 + (size_t)(d0 + r) * F + f0 + c,
                   true);
      }
      bf16* stb = st + kBKA * LDA;
      for (int i = tid; i < FS * (kBKA / 8); i += kThreads) {
        const int r = i / (kBKA / 8);
        const int c = (i % (kBKA / 8)) * 8;
        cp_async16(stb + r * LDB + c, w2 + (size_t)(f0 + r) * D + d0 + c,
                   true);
      }
    } else {
      const int c0 = f0 + (u - ka) * kBKB;
      for (int i = tid; i < D * (kBKB / 8); i += kThreads) {
        const int r = i / (kBKB / 8);
        const int c = (i % (kBKB / 8)) * 8;
        cp_async16(st + r * LDC + c, w1 + (size_t)r * F + c0 + c, true);
      }
    }
  };
  for (int i = 0; i < kBwdStages - 1; ++i) {
    if (i < steps) load(i);
    cp_async_commit();
  }
  cp_async_wait<kBwdStages - 1>();  // x and dy have arrived
  __syncthreads();
  ln_tile(lnS, ldx, gamma, beta, TM, D, eps, stats);
  __syncthreads();
  for (int i = tid; i < TM * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(ln_out + (size_t)(m0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(lnS + r * ldx + c);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> zf[MF][NF1];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> rf[MF][NF1];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dln[MF][kMaxNF];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNF; ++j) wmma::fill_fragment(dln[i][j], 0.f);

  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kBwdStages - 2>();
    __syncthreads();
    if (t + kBwdStages - 1 < steps) load(t + kBwdStages - 1);
    cp_async_commit();
    const bf16* st = ring + (t % kBwdStages) * stage;
    const int u = t % per;
    const int f0 = t / per * FS;
    if (u < ka) {  // phase A: z and dy @ W2^T over this D chunk
      if (u == 0) {
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF1; ++j) {
            wmma::fill_fragment(zf[i][j], 0.f);
            wmma::fill_fragment(rf[i][j], 0.f);
          }
      }
      const bf16* stb = st + kBKA * LDA;
#pragma unroll
      for (int kk = 0; kk < kBKA; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fl[MF], fd[MF];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            f1[NF1];
        // element (d, f) of W2[s, :]^T at stb[f * LDB + d]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
            f2[NF1];
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          const int off = (row0 + 16 * i) * ldx + u * kBKA + kk;
          wmma::load_matrix_sync(fl[i], lnS + off, ldx);
          wmma::load_matrix_sync(fd[i], dyS + off, ldx);
        }
#pragma unroll
        for (int j = 0; j < NF1; ++j) {
          const int n = wc * (FS / 4) + 16 * j;
          wmma::load_matrix_sync(f1[j], st + kk * LDA + n, LDA);
          wmma::load_matrix_sync(f2[j], stb + n * LDB + kk, LDB);
        }
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF1; ++j) {
            wmma::mma_sync(zf[i][j], fl[i], f1[j], zf[i][j]);
            wmma::mma_sync(rf[i][j], fd[i], f2[j], rf[i][j]);
          }
      }
      if (u == ka - 1) {  // the slice's z and dy W2^T are complete
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF1; ++j) {
            const int off = (row0 + 16 * i) * LDZ + wc * (FS / 4) + 16 * j;
            wmma::store_matrix_sync(zS + off, zf[i][j], LDZ,
                                    wmma::mem_row_major);
            wmma::store_matrix_sync(rS + off, rf[i][j], LDZ,
                                    wmma::mem_row_major);
          }
        __syncthreads();
        for (int i = tid; i < TM * (FS / 8); i += kThreads) {
          const int r = i / (FS / 8);
          const int c = (i % (FS / 8)) * 8;
          float h[8], d32[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float z = zS[r * LDZ + c + e] + b1[f0 + c + e];
            h[e] = gelu_erf(z);
            d32[e] = rS[r * LDZ + c + e] * gelu_grad_erf(z);
            zS[r * LDZ + c + e] = d32[e];
          }
          const uint4 dh = pack8(d32);
          *reinterpret_cast<uint4*>(dhS + r * LDH + c) = dh;
          if (m0 + r < M) {
            const size_t o = (size_t)(m0 + r) * F + f0 + c;
            *reinterpret_cast<uint4*>(h_out + o) = pack8(h);
            *reinterpret_cast<uint4*>(dh_out + o) = dh;
          }
        }
        __syncthreads();
        // rows past M hold dh32 = 0 (dy was zero-filled there)
        for (int c = tid; c < FS; c += kThreads) {
          float s = 0.f;
          for (int r = 0; r < TM; ++r) s += zS[r * LDZ + c];
          b1part[(size_t)blockIdx.x * F + f0 + c] = s;
        }
        // the next step's barrier makes dhS visible to phase B
      }
    } else {  // phase B: dln += dh_s @ W1[:, s]^T over this F chunk
      const int kc = (u - ka) * kBKB;
#pragma unroll
      for (int kk = 0; kk < kBKB; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
            fa[MF];
#pragma unroll
        for (int i = 0; i < MF; ++i)
          wmma::load_matrix_sync(fa[i], dhS + (row0 + 16 * i) * LDH + kc + kk,
                                 LDH);
#pragma unroll
        for (int j = 0; j < kMaxNF; ++j) {
          if (j < nf2) {
            // element (f, d) of W1[:, s]^T at st[d * LDC + f]
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
                fb;
            wmma::load_matrix_sync(fb, st + (wc * (D / 4) + 16 * j) * LDC + kk,
                                   LDC);
#pragma unroll
            for (int i = 0; i < MF; ++i)
              wmma::mma_sync(dln[i][j], fa[i], fb, dln[i][j]);
          }
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the ln tile and the ring are free: dln takes them
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNF; ++j)
      if (j < nf2)
        wmma::store_matrix_sync(
            dlnS + (row0 + 16 * i) * ldl + wc * (D / 4) + 16 * j, dln[i][j],
            ldl, wmma::mem_row_major);
  __syncthreads();
  float ag[PL], ab[PL], ay[PL];
#pragma unroll
  for (int j = 0; j < PL; ++j) ag[j] = ab[j] = ay[j] = 0.f;
  const int per_lane = D / 32;
  for (int r = warp; r < TM && m0 + r < M; r += kWarps) {
    const float mu = stats[2 * r];
    const float inv = stats[2 * r + 1];
    const bf16* xr = x + (size_t)(m0 + r) * D;
    float xh[PL], g[PL];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < PL; ++j)
      if (j < per_lane) {
        const int c = lane + 32 * j;
        const float d = dlnS[r * ldl + c];
        xh[j] = (__bfloat162float(xr[c]) - mu) * inv;
        g[j] = d * gamma[c];
        m1 += g[j];
        m2 += g[j] * xh[j];
        ag[j] += d * xh[j];
        ab[j] += d;
      }
    m1 = warp_sum(m1) / (float)D;
    m2 = warp_sum(m2) / (float)D;
#pragma unroll
    for (int j = 0; j < PL; ++j)
      if (j < per_lane) {
        const int c = lane + 32 * j;
        const float y = __bfloat162float(dyS[r * ldx + c]);
        ay[j] += y;
        dx[(size_t)(m0 + r) * D + c] =
            __float2bfloat16(y + inv * (g[j] - m1 - xh[j] * m2));
      }
  }
  __syncthreads();  // dln is read: its space takes the warps' sums
  float* red = dlnS;  // [kWarps][3][D]
#pragma unroll
  for (int j = 0; j < PL; ++j)
    if (j < per_lane) {
      const int c = lane + 32 * j;
      red[(warp * 3 + 0) * D + c] = ag[j];
      red[(warp * 3 + 1) * D + c] = ab[j];
      red[(warp * 3 + 2) * D + c] = ay[j];
    }
  __syncthreads();
  for (int i = tid; i < 3 * D; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * 3 * D + i];
    rpart[(size_t)blockIdx.x * 3 * D + i] = s;
  }
}

template <int TM, int FS>
cudaError_t launch_mlp_tile_bwd(const bf16* x, const float* gamma,
                                const float* beta, const bf16* w1,
                                const float* b1, const bf16* w2,
                                const bf16* dy, bf16* dx, bf16* ln, bf16* h,
                                bf16* dh, float* b1part, float* rpart, int M,
                                int D, int F, float eps, cudaStream_t st) {
  const size_t dln_bytes = (size_t)TM * (D + 4) * sizeof(float);
  const size_t red_bytes = (size_t)kWarps * 3 * D * sizeof(float);
  const size_t head = bwd_head_bytes(TM, FS, D);
  if (dln_bytes > head || red_bytes > head) return cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(TM, FS, D);
  auto kernel = mlp_tile_bwd_kernel<TM, FS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(M + TM - 1) / TM, kThreads, smem, st>>>(
      x, gamma, beta, w1, b1, w2, dy, dx, ln, h, dh, b1part, rpart, M, D, F,
      eps);
  return cudaGetLastError();
}

struct TileBwdWs {
  bf16* ln;
  bf16* h;
  bf16* dh;
  float* b1part;  // [tiles, F]
  float* rpart;   // [tiles, 3, D]
  float* wpart;   // [splits, D, F] (dW2 reuses it)
  int tiles, s_w1, s_w2;
  size_t bytes;

  TileBwdWs(void* base, int M, int D, int F, int tm) {
    tiles = (M + tm - 1) / tm;
    s_w2 = weight_grad_splits(F, D, M);
    s_w1 = weight_grad_splits(D, F, M);
    Carver c{static_cast<char*>(base)};
    ln = c.take<bf16>((size_t)M * D);
    h = c.take<bf16>((size_t)M * F);
    dh = c.take<bf16>((size_t)M * F);
    b1part = c.take<float>((size_t)tiles * F);
    rpart = c.take<float>((size_t)tiles * 3 * D);
    wpart = c.take<float>((size_t)D * F * (s_w1 > s_w2 ? s_w1 : s_w2));
    bytes = c.used;
  }
};

}  // namespace mlpt
}  // namespace vlp

extern "C" size_t vlp_mlp_tile_bwd_workspace(int M, int D, int F, int tm) {
  if (M <= 0 || tm <= 0) return 0;
  return vlp::mlpt::TileBwdWs(nullptr, M, D, F, tm).bytes;
}

// x, dy, dx [M, D] bf16; w1 [D, F], w2 [F, D] bf16 ([in, out]); gamma, beta
// [D] and b1 [F] fp32. Outputs, all fp32: dgamma, dbeta, db2 [D], db1 [F],
// dw1 [D, F], dw2 [F, D]. ws: vlp_mlp_tile_bwd_workspace(M, D, F, tm)
// bytes. tm, fs: one of (64, 64), (32, 64), (32, 128). Returns the first
// failing cudaError_t.
extern "C" int vlp_mlp_tile_bwd(const void* x, const void* gamma,
                                const void* beta, const void* w1,
                                const void* b1, const void* w2,
                                const void* dy, void* dx, void* dgamma,
                                void* dbeta, void* dw1, void* db1, void* dw2,
                                void* db2, void* ws, int M, int D, int F,
                                int tm, int fs, float eps, void* stream) {
  using vlp::bf16;
  namespace mt = vlp::mlpt;
  if (M <= 0 || D <= 0 || D % 64 || D > mt::kMaxD || F <= 0 || F % fs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const mt::TileBwdWs w(ws, M, D, F, tm);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  bf16* dxb = static_cast<bf16*>(dx);
  cudaError_t err;
  if (tm == 64 && fs == 64)
    err = mt::launch_mlp_tile_bwd<64, 64>(xb, g, bt, w1b, b1f, w2b, dyb, dxb,
                                          w.ln, w.h, w.dh, w.b1part, w.rpart,
                                          M, D, F, eps, st);
  else if (tm == 32 && fs == 64)
    err = mt::launch_mlp_tile_bwd<32, 64>(xb, g, bt, w1b, b1f, w2b, dyb, dxb,
                                          w.ln, w.h, w.dh, w.b1part, w.rpart,
                                          M, D, F, eps, st);
  else if (tm == 32 && fs == 128)
    err = mt::launch_mlp_tile_bwd<32, 128>(xb, g, bt, w1b, b1f, w2b, dyb,
                                           dxb, w.ln, w.h, w.dh, w.b1part,
                                           w.rpart, M, D, F, eps, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  // dW2 = h^T @ dy
  err = vlp::launch_gemm_ex<false, true, false, vlp::kEpiF32>(
      w.h, nullptr, nullptr, dyb, nullptr, nullptr, w.wpart, F, D, M, w.s_w2,
      0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_reduce_rows(w.wpart, static_cast<float*>(dw2), w.s_w2,
                                (size_t)F * D, (size_t)F * D, st);
  if (err != cudaSuccess) return (int)err;
  // dW1 = ln^T @ dh
  err = vlp::launch_gemm_ex<false, true, false, vlp::kEpiF32>(
      w.ln, nullptr, nullptr, w.dh, nullptr, nullptr, w.wpart, D, F, M,
      w.s_w1, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_reduce_rows(w.wpart, static_cast<float*>(dw1), w.s_w1,
                                (size_t)D * F, (size_t)D * F, st);
  if (err != cudaSuccess) return (int)err;
  float* outs[3] = {static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                    static_cast<float*>(db2)};
  for (int k = 0; k < 3; ++k) {
    err = vlp::launch_reduce_rows(w.rpart + (size_t)k * D, outs[k], w.tiles,
                                  (size_t)3 * D, (size_t)D, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = vlp::launch_reduce_rows(w.b1part, static_cast<float*>(db1), w.tiles,
                                (size_t)F, (size_t)F, st);
  return (int)err;
}
