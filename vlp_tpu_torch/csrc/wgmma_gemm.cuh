// A bf16 GEMM mainloop for Hopper, written by hand: TMA into a ring of
// 128-byte-swizzled shared-memory stages, one producer warp, and two
// consumer warpgroups running wgmma out of shared memory:
//
//   out[M, N] = bf16( sum over k of A[M, k] * B[k, N] )
//
// with fp32 accumulation, rounded once. Shared by the probe kernels
// gemm_single.cu (#19b, benchmarks/mlp_probe.py:make_single: A = x [M, K]
// by a tiled TMA map) and conv3x3.cu (#17,
// benchmarks/conv_probe.py:pallas_conv3x3: A = the 3x3 taps of an NHWC
// map by an im2col TMA map); B, the weights, by a tiled map in both.
//
// What bounds a GEMM on this card: the bf16 tensor cores (989 TFLOP/s) once
// a tile does ~300 operations per byte it brings from device memory, and
// only wgmma reaches that rate (wmma compiles to mma.sync, which the older
// engines implicit_gemm.cuh and mlp_tile.cuh run at 100-150 TFLOP/s). The
// tensor cores idle whenever a warpgroup waits for its operands, so the
// loads have to run ahead of the products without costing the consumers
// instructions or registers, and the epilogue has to overlap another
// tile's loads.
//
// Design:
// - A block of 288 threads owns one 128 x BN output tile: warps 0-7 are
//   two consumer warpgroups of 64 rows each, warp 8 is the producer. The K
//   loop walks the policy's steps, each a 64-deep slice (128 bytes of bf16,
//   the swizzle span).
// - Ring: STAGES stages of [128 x 64] A and [64 x BN] B in shared memory,
//   each stage with a full and an empty mbarrier. One producer thread
//   waits for a stage's empty barrier, announces the bytes TMA will bring
//   on its full barrier and issues the loads (cp.async.bulk.tensor, 128-byte
//   swizzle, out-of-range elements filled with zeros, so ragged M, N and K
//   and a convolution's halo need no masking); the consumers wait for the
//   full barrier, issue four wgmma.mma_async m64nBNk16 per stage with both
//   operands read by descriptor, keep one stage's group in flight, and
//   release the previous stage on its empty barrier once its group has
//   completed (wgmma.wait_group 1). No thread writes the ring, so no proxy
//   fence is needed.
// - A is K-major; B is [K, N] row-major, i.e. N-major, and is read as it
//   lies through wgmma's transpose bit: each 64-column box of a stage is a
//   column of 8-row swizzle atoms (LBO = the box's 8 KB, SBO = 1 KB), so
//   the weights are never copied into a transposed buffer.
// - Epilogue in registers: fp32 -> bf16 pairs, transposed within each quad
//   of lanes by shuffles so that every thread stores 16-byte vectors
//   (64 contiguous bytes a row per quad), masked at M and N. Two blocks
//   share an SM at BN = 128 (~97 KB of shared memory each), so one block's
//   epilogue and prologue overlap the other's products; BN = 256 runs one
//   block with four stages.
//
// Requirements: N a multiple of 8 (16-byte rows for TMA and the vector
// stores); the policy's tensor maps describe its operands; 16-byte aligned
// pointers. Not done here (later steps): a persistent grid whose producer
// runs on into the next tile (at K = 384 a tile's six steps leave the ring's
// latency exposed), clusters with multicast of B, setmaxnreg, a TMA store.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through
                   // the runtime's driver entry point, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace vlp {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;                       // K per stage (128 bytes)
constexpr int kConsumerWarps = 8;             // two warpgroups
constexpr int kBM = 16 * kConsumerWarps;      // 128 rows a block
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + the producer warp
constexpr int kABytes = kBM * kBK * 2;        // 16 KB a stage
constexpr int kBoxBytes = kBK * 64 * 2;       // one 64 x 64 box of B: 8 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival that also raises the barrier's expected transaction bytes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// spins until the barrier's phase of the given parity has completed; a
// wait that never ends (a fault in the ring's protocol) traps after 2^24
// tries, so it fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (tries == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// a [64 channels x 128 pixels] im2col box of an NHWC map at pixel
// coordinates (w, h, n), each pixel shifted by (dw, dh)
__device__ __forceinline__ void tma_load_im2col(uint32_t dst,
                                                const CUtensorMap* map,
                                                uint32_t bar, int c, int w,
                                                int h, int n, uint16_t dw,
                                                uint16_t dh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h),
      "r"(n), "h"(dw), "h"(dh)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address `addr`
// (1024-byte aligned atoms): leading and stride byte offsets in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from touching the accumulators across an asynchronous
// wgmma (the registers are the instruction's until its group completes)
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x N] += A[64 x 16] (K-major, descriptor da) * B[16 x N] (N-major,
// descriptor db, transpose bit set); scale_d 0 ignores d
template <int N>
struct Mma;

template <>
struct Mma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Mma<256> {
  __device__ __forceinline__ static void run(float (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// Lane q of a quad holds w[j] = columns 2q, 2q + 1 of 8-column chunk j of
// one row; returns the whole chunk q (8 bf16) of that row.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&w)[4],
                                                int lane) {
  const int q = lane & 3;
  uint32_t r[4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    r[s] = __shfl_sync(0xffffffffu, pick4(w, (q - s) & 3),
                       (lane & ~3) | ((q + s) & 3));
  return make_uint4(pick4(r, (0 - q) & 3), pick4(r, (1 - q) & 3),
                    pick4(r, (2 - q) & 3), pick4(r, (3 - q) & 3));
}

template <int BN, int STAGES>
struct Layout {
  static constexpr int kBBytes = (BN / 64) * kBoxBytes;
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int kBars = STAGES * kStage;  // offset of the barriers
  // + 1024 for aligning the ring to the 128-byte swizzle's 1 KB atoms
  static constexpr size_t kBytes = 1024 + kBars + 16 * STAGES;
};

// Policy (a struct passed by value), its loads issued by one thread:
//   int steps() const;                  // 64-deep K slices
//   void load_a(uint32_t dst, const CUtensorMap*, uint32_t bar, int step,
//               int m0) const;          // the [128 x 64] A tile by TMA
//   void load_b(uint32_t dst, const CUtensorMap*, uint32_t bar, int step,
//               int n) const;           // one 64 x 64 box of B by TMA
template <class Src, int BN, int STAGES, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const Src src, bf16* __restrict__ out, int M, int N) {
  using L = Layout<BN, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = ring + L::kBars;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int steps = src.steps();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: one thread issues
    if (lane != 0) return;
    const int left = (N - n0 + 63) / 64;
    const int boxes = left < BN / 64 ? left : BN / 64;  // B boxes inside N
    const uint32_t tx = kABytes + boxes * kBoxBytes;
    for (int t = 0; t < steps; ++t) {
      const int s = t % STAGES;
      const uint32_t a_st = ring + s * L::kStage;
      if (t >= STAGES) mbar_wait(empty0 + 8 * s, ((t / STAGES) + 1) & 1);
      mbar_arrive_expect_tx(full0 + 8 * s, tx);
      src.load_a(a_st, &map_a, full0 + 8 * s, t, m0);
      for (int j = 0; j < boxes; ++j)
        src.load_b(a_st + kABytes + j * kBoxBytes, &map_b, full0 + 8 * s, t,
                   n0 + 64 * j);
    }
    return;
  }

  // the consumers: warpgroup g owns rows [64 g, 64 g + 64) of the tile
  const int g = warp >> 2;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int t = 0; t < steps; ++t) {
    const int s = t % STAGES;
    const uint32_t a_st = ring + s * L::kStage + g * (64 * 128);
    const uint32_t b_st = ring + s * L::kStage + kABytes;
    mbar_wait(full0 + 8 * s, (t / STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Mma<BN>::run(acc, desc_sw128(a_st + 32 * kk, 16, 1024),
                   desc_sw128(b_st + 2048 * kk, kBoxBytes, 1024), 1);
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();  // step t - 1's products are done: free its stage
    fence_acc(acc);
    if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((t - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // acc[4j + {0, 1}]: row lane / 4, columns 8j + 2 (lane % 4) + {0, 1};
  // acc[4j + {2, 3}]: the same columns 8 rows lower
  const int row = m0 + 64 * g + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int c4 = 0; c4 < BN / 32; ++c4) {
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * (4 * c4 + j);
      lo[j] = pack_bf16x2(acc[i], acc[i + 1]);
      hi[j] = pack_bf16x2(acc[i + 2], acc[i + 3]);
    }
    const uint4 vlo = quad_transpose(lo, lane);
    const uint4 vhi = quad_transpose(hi, lane);
    const int col = n0 + 32 * c4 + 8 * (lane & 3);
    if (col < N) {
      if (row < M)
        *reinterpret_cast<uint4*>(out + (size_t)row * N + col) = vlo;
      if (row + 8 < M)
        *reinterpret_cast<uint4*>(out + (size_t)(row + 8) * N + col) = vhi;
    }
  }
}

// Launches wgmma_gemm_kernel on `stream`, one block per output tile; returns
// the launch's cudaError_t.
template <class Src, int BN, int STAGES, int MINB>
cudaError_t launch_wgmma_gemm(const CUtensorMap& map_a,
                              const CUtensorMap& map_b, const Src& src,
                              bf16* out, int M, int N, cudaStream_t stream) {
  static_assert(BN == 128 || BN == 256, "the Mma instances");
  auto kernel = wgmma_gemm_kernel<Src, BN, STAGES, MINB>;
  constexpr size_t smem = Layout<BN, STAGES>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  if (M <= 0 || N <= 0 || N % 8 || tiles > INT_MAX)
    return cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, kThreads, smem, stream>>>(map_a, map_b, src, out,
                                                      M, N);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, a driver-API function, through the runtime's
// entry-point query (the library is linked without -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? p
                                                                      : nullptr;
}

inline EncodeTiled encode_tiled() {
  static const auto fn =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// An im2col map of an NHWC bf16 map [n, h, w, c] for a 3x3 SAME
// convolution: boxes of 64 channels x 128 pixels, the pixels walked in NHW
// order over the window corners (-1 ... w - 2, -1 ... h - 2), each read at
// the corner plus the tap's offset; pixels outside the map arrive as zeros.
inline cudaError_t encode_im2col_bf16(CUtensorMap* map, const void* base,
                                      int n, int h, int w, int c) {
  static const auto fn =
      reinterpret_cast<EncodeIm2col>(driver_entry("cuTensorMapEncodeIm2col"));
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t gdim[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)n};
  const cuuint64_t gstride[3] = {(cuuint64_t)c * 2, (cuuint64_t)c * w * 2,
                                 (cuuint64_t)c * w * h * 2};
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), gdim, gstride, lower, upper,
                        kBK, kBM, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map of a dense bf16 tensor of `rank` dimensions (dims[0] innermost)
// read in boxes of box[0] x ... elements, box[0] = 64 (one 128-byte swizzle
// span); out-of-range elements arrive as zeros. Returns cudaSuccess or the
// reason it cannot be made.
inline cudaError_t encode_bf16(CUtensorMap* map, const void* base, int rank,
                               const uint64_t* dims, const uint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t gbox[3], estride[3] = {1, 1, 1};
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    gbox[i] = box[i];
    if (i > 0) gstride[i - 1] = stride;
    stride *= dims[i];
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(base), gdim, gstride, gbox, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace vlp
