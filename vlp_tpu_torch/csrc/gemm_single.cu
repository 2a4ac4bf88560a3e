// gemm_single: the MLP probe's single product,
//
//   z[M, N] = bf16( x[M, K] @ w[K, N] )
//
// x and w bf16 row-major (w is [in, out], so N-contiguous), fp32
// accumulation rounded once. Replaces the Pallas TPU kernel
// benchmarks/mlp_probe.py:make_single (body single_mm_kernel, :86), the
// probe of what the MLP's first product costs alone, at NesT-Small level 3
// ([25088, 384] @ [384, 1536] at batch 128).
//
// The TPU kernel takes a row tile of x and all of w per grid step. Here
// both operands arrive by TMA into the wgmma mainloop (wgmma_gemm.cuh): A =
// x is K-major, B = w is read N-major as it lies, one block per 128 x BN
// output tile, the blocks of one row tile launched together so that its x
// tile is read from device memory once.
//
// What bounds it on this card: at the probe's shape 2 M K N = 2.96e10
// operations (0.0299 ms at 989 TFLOP/s) against 2 (M K + K N + M N) bytes
// = 97.5 MB (0.0291 ms at 3.35 TB/s): it sits on the ridge, and the 77 MB
// store of z costs as much as the products. So the store must overlap
// other tiles' products: blocks of 128 x 128 with three stages, two to an
// SM (~97 KB of shared memory each), so one block's epilogue runs under the
// other's wgmma. (Tiles 64 wide at three blocks an SM, and 256 wide at one
// with four stages, were slower at the probe's shape on an H100; a
// persistent grid is the other way to overlap the store.)
#include "wgmma_gemm.cuh"

namespace {

using vlp::wg::kBK;

// A [M, K] by TMA; B [K, N] in 64 x 64 boxes at (n, k)
struct DenseRows {
  int K;

  __device__ int steps() const { return (K + kBK - 1) / kBK; }

  __device__ void load_a(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int step, int m0) const {
    vlp::wg::tma_load_2d(dst, map, bar, step * kBK, m0);
  }

  __device__ void load_b(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int step, int n) const {
    vlp::wg::tma_load_2d(dst, map, bar, n, step * kBK);
  }
};

}  // namespace

// x [M, K], w [K, N], z [M, N], bf16, 16-byte aligned; K and N multiples of
// 8 (16-byte rows for TMA), any M. Returns the launch's cudaError_t.
extern "C" int vlp_gemm_single(const void* x, const void* w, void* z, int M,
                               int K, int N, void* stream) {
  namespace wg = vlp::wg;
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 || N % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(z)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  const uint64_t x_dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint32_t x_box[2] = {kBK, wg::kBM};
  const uint64_t w_dims[2] = {(uint64_t)N, (uint64_t)K};
  const uint32_t w_box[2] = {64, kBK};
  cudaError_t err = wg::encode_bf16(&map_x, x, 2, x_dims, x_box);
  if (err == cudaSuccess) err = wg::encode_bf16(&map_w, w, 2, w_dims, w_box);
  if (err != cudaSuccess) return (int)err;
  return (int)wg::launch_wgmma_gemm<DenseRows, 128, 3, 2>(
      map_x, map_w, DenseRows{K}, static_cast<wg::bf16*>(z), M, N,
      static_cast<cudaStream_t>(stream));
}
