// The launch sequence of the MLP backwards, shared by ln_mlp_bwd.cu (#4,
// a = ln = bf16(LN(x) * gamma + beta)) and fused_mlp_bwd.cu (#10, a = x),
// over a [M, D] rows, F the hidden width:
//
//   1. dual tile (wgmma_gemm.cuh, form DualMlp): over one 128 x BN tile of
//      [M, F], acc = a @ W1 and acc2 = dy @ W2^T in one K loop over D; in
//      registers z = acc + b1, h = bf16(z * cdf) (gelu.cuh, the forwards'
//      own h), dh32 = acc2 * gelu'(z) with gelu'(z) = cdf + z * phi
//      (fused_mlp.py:_gelu_and_grad, the Pallas backward's association),
//      dh = bf16(dh32); stores h and dh
//      [M, F] and the fp32 column sums of dh32 over the tile's 128 rows
//   2. ColsTN, split-K:  dW2 = h^T @ dy   (fp32 partials)
//   3. ColsTN, split-K:  dW1 = a^T @ dh   (fp32 partials)
//   4. RowsNT:           da = dh @ W1^T, fp32 (#4's dln) or bf16 (#10's dx)
//   5. reduce_rows:      the partials in a fixed order -> dW2, dW1 (bf16)
//                        and db1 = the tiles' column sums in tile order
//
// The Pallas bodies compute z and dy @ W2^T for one row tile in the same
// grid step, so gelu'(z) lives only in VMEM. On Hopper both products have
// depth D and an [M-tile x F-tile] output, and their wgmma accumulators have
// the same fragment layout whatever B's transpose bit, so z, gelu'(z), h and
// dh32 are formed element by element in registers: gelu' is never stored,
// and the first step moves a, dy in and h, dh out (about 2 * M * (D + 2 F)
// bytes). A's rows past M arrive as zeros, so their dh32 is 0; they are
// masked all the same. The column sums run in a fixed order (a thread's two
// rows, the 8 lanes of a column by halving exchanges, then the 8 warps in
// order through shared memory) and no float atomics are used, so reruns
// agree bit for bit.
//
// What bounds it on this card: 10 * M * D * F operations (74 GFLOP a call
// at every level of NesT-Small at batch 64, 0.075 ms at 989 TFLOP/s)
// against the bytes of the five products: 1.0 GB a call at level 0 (M * D
// = 19.3 M elements), 0.50 at level 1 and 0.25 at level 2 (0.30, 0.15 and
// 0.075 ms at 3.35 TB/s). So the products are bound by bytes. The dual
// tile also does ~25 fp32 operations per element of [M, F] in its
// epilogue, and each of its blocks reads its 128 rows of a and dy from L2
// again for every BN columns of F (at level 2, D = 384 and F = 1536, that
// is several times the bytes it stores). BN = 64 (kDualBN) runs two blocks
// an SM (~99 KB of shared memory each, two stages: D is 2-6 steps deep), so
// one block's epilogue overlaps the other's loads; BN = 128 (half the
// re-reads, one block an SM) was slower at all three levels on an H100
// (PERF.md).
#pragma once

#include "bwd_rows.cuh"
#include "gelu.cuh"
#include "wgmma_gemm.cuh"

namespace vlp {
namespace wg {

// The dual form: acc = a @ W1 with a [M, D] K-major and W1 [D, F] N-major
// through the transpose bit (as DenseRows reads B), acc2 = dy @ W2^T with
// dy [M, D] K-major and W2 [F, D] K-major as it lies (as RowsNT reads B);
// K = D. The epilogue writes h (the kernel's out) and dh [M, F] bf16 and
// colsum [ceil(M / 128), F] fp32.
struct DualMlp {
  static constexpr int kProducts = 2;
  static constexpr int kTnspA = 0, kTnspB = 1, kTnspA2 = 0, kTnspB2 = 0;
  CUtensorMap map_a2, map_b2;  // dy, W2
  const float* b1;             // [F]
  bf16* dh;
  float* colsum;
  int K;

  __device__ int steps() const { return (K + kBK - 1) / kBK; }
  __device__ void load_a(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int step, int m0) const {
    tma_load_2d(dst, map, bar, step * kBK, m0);
  }
  __device__ void load_b(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int step, int n) const {
    tma_load_2d(dst, map, bar, n, step * kBK);
  }
  __device__ void load_a2(uint32_t dst, uint32_t bar, int step,
                          int m0) const {
    tma_load_2d(dst, &map_a2, bar, step * kBK, m0);
  }
  __device__ void load_b2(uint32_t dst, uint32_t bar, int step, int n) const {
    tma_load_2d(dst, &map_b2, bar, step * kBK, n);
  }

  template <int BN>
  __device__ __forceinline__ void epilogue(float (&z)[BN / 2],
                                           float (&g)[BN / 2], bf16* h,
                                           int M, int N, int m0, int n0,
                                           int row, int warp, int lane,
                                           float* sums) const {
#pragma unroll
    for (int c4 = 0; c4 < BN / 32; ++c4) {
      float part[8];  // this 32-column group's sums of the thread's rows
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 4 * c4 + jj;
          const int col = n0 + 8 * j + 2 * (lane & 3) + e;
          const float bias = col < N ? b1[col] : 0.f;
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = 4 * j + 2 * r + e;
            const float zz = z[i] + bias;
            float cdf, phi;
            gelu_cdf_pdf(zz, cdf, phi);
            z[i] = zz * cdf;          // h, rounded at the store
            g[i] *= cdf + zz * phi;   // dh32
            if (row + 8 * r < M) s += g[i];
          }
          part[2 * jj + e] = s;
        }
      }
      store_group<BN>(z, c4, h, row, n0, M, N, lane);
      store_group<BN>(g, c4, dh, row, n0, M, N, lane);
      // The 8 lanes of a column quad (lane % 4) add their 8 column sums
      // by halving exchanges over lane bits 4, 3, 2 (7 shuffles, not 24):
      // each keeps the half of its columns that matches its bit, so lane
      // ends with column k = lane / 4 of the 8, summed over the warp's 16
      // rows in a fixed order.
#pragma unroll
      for (int half = 4; half > 0; half >>= 1) {
        const bool up = lane & (4 * half);  // keeps columns [half, 2 half)
#pragma unroll
        for (int q = 0; q < half; ++q) {
          const float mine = up ? part[q + half] : part[q];
          const float other = __shfl_xor_sync(
              0xffffffffu, up ? part[q] : part[q + half], 4 * half);
          part[q] = mine + other;
        }
      }
      const int k = lane >> 2;
      sums[warp * BN + 32 * c4 + 8 * (k >> 1) + 2 * (lane & 3) + (k & 1)] =
          part[0];
    }
    consumers_sync();
    const int t = threadIdx.x;
    if (t < BN && n0 + t < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) s += sums[w * BN + t];
      colsum[(size_t)(m0 / kBM) * N + n0 + t] = s;
    }
  }
};

// The dual tile's width: 64 columns of F a block.
constexpr int kDualBN = 64;

// Encodes the dual tile's four tensor maps on the host and launches it: one
// block per 128 x kDualBN tile of [M, F], two stages, two blocks an SM. D
// and F multiples of 8, 16-byte aligned bf16 operands. Returns the first
// failing cudaError_t.
inline cudaError_t launch_mlp_dual(const bf16* a, const bf16* w1,
                                   const float* b1, const bf16* dy,
                                   const bf16* w2, bf16* h, bf16* dh,
                                   float* colsum, int M, int D, int F,
                                   cudaStream_t st) {
  if (M <= 0 || D <= 0 || F <= 0 || D % 8 || F % 8 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(w1) |
       reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(w2) |
       reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(dh)) %
          16)
    return cudaErrorInvalidValue;
  DualMlp src{};
  CUtensorMap map_a, map_w1;
  cudaError_t err = DenseRows::encode(&map_a, &map_w1, a, w1, M, F, D);
  if (err == cudaSuccess)
    err = RowsNT::encode(&src.map_a2, &src.map_b2, dy, w2, M, F, D);
  if (err != cudaSuccess) return err;
  src.b1 = b1;
  src.dh = dh;
  src.colsum = colsum;
  src.K = D;
  return launch_wgmma_gemm<DualMlp, kDualBN, 2, 2>(
      map_a, map_w1, src, h, M, F, st);
}

}  // namespace wg

// Workspace pieces of steps 1-5, in one order for the size query and the
// launch.
struct MlpGradWs {
  bf16* h = nullptr;
  bf16* dh = nullptr;
  float* b1part = nullptr;  // [m tiles, F]
  float* wpart = nullptr;   // [splits, D, F] (dW2 reuses it)
  int s_w1 = 0, s_w2 = 0, m_tiles = 0;

  MlpGradWs() = default;
  MlpGradWs(Carver& c, int M, int D, int F)
      : s_w1(wg::split_count(D, F, M)),
        s_w2(wg::split_count(F, D, M)),
        m_tiles((M + wg::kBM - 1) / wg::kBM) {
    h = c.take<bf16>((size_t)M * F);
    dh = c.take<bf16>((size_t)M * F);
    b1part = c.take<float>((size_t)m_tiles * F);
    wpart = c.take<float>((size_t)D * F * (s_w1 > s_w2 ? s_w1 : s_w2));
  }
};

// Steps 1-5 on one stream: dW1, dW2 (bf16), db1 (fp32) and da (DA = float:
// #4's dln; bf16: #10's dx) from a, dy, the weights and b1. At most 65535
// 256-row blocks (the row passes' partials that follow). Returns the first
// failing cudaError_t.
template <class DA>
cudaError_t mlp_bwd_products(const bf16* a, const bf16* w1, const float* b1,
                             const bf16* w2, const bf16* dy,
                             const MlpGradWs& w, DA* da, bf16* dw1,
                             float* db1, bf16* dw2, int M, int D, int F,
                             cudaStream_t st) {
  if (M <= 0 || col_row_blocks(M) > 65535) return cudaErrorInvalidValue;
  cudaError_t err = wg::launch_mlp_dual(
      a, w1, b1, dy, w2, w.h, w.dh, w.b1part, M, D, F, st);
  if (err != cudaSuccess) return err;
  // dW2 = h^T @ dy
  err = wg::launch_dense<wg::ColsTN>(w.h, dy, w.wpart, F, D, M, w.s_w2, st);
  if (err != cudaSuccess) return err;
  err = launch_reduce_rows(w.wpart, dw2, w.s_w2, (size_t)F * D,
                           (size_t)F * D, st);
  if (err != cudaSuccess) return err;
  // dW1 = a^T @ dh
  err = wg::launch_dense<wg::ColsTN>(a, w.dh, w.wpart, D, F, M, w.s_w1, st);
  if (err != cudaSuccess) return err;
  err = launch_reduce_rows(w.wpart, dw1, w.s_w1, (size_t)D * F,
                           (size_t)D * F, st);
  if (err != cudaSuccess) return err;
  // da = dh @ W1^T (W1 [D, F] is K-major for this product)
  err = wg::launch_dense<wg::RowsNT>(w.dh, w1, da, M, D, F, 1, st);
  if (err != cudaSuccess) return err;
  return launch_reduce_rows(w.b1part, db1, w.m_tiles, (size_t)F, (size_t)F,
                            st);
}

}  // namespace vlp
