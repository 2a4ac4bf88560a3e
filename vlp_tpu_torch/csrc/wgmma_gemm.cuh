// A bf16 GEMM mainloop for Hopper, written by hand: TMA into a ring of
// 128-byte-swizzled shared-memory stages, one producer warp, and two
// consumer warpgroups running wgmma out of shared memory:
//
//   out[M, N] = sum over k of A[M, k] * B[k, N]
//
// with fp32 accumulation, rounded once to bf16 or stored as fp32 (whole,
// or as split-K partials). Shared by the probe kernels gemm_single.cu
// (#19b, benchmarks/mlp_probe.py:make_single: DenseRows, x @ w) and
// conv3x3.cu (#17, benchmarks/conv_probe.py:pallas_conv3x3: A = the 3x3
// taps of an NHWC map by an im2col TMA map), by the half-block attention
// backwards #3 and #6 (ln_attention.cuh: RowsNT, dy @ Wout^T to bf16 and
// dqkv @ Wqkv^T to fp32; ColsTN, o^T @ dy and ln^T @ dqkv to split-K fp32
// partials) and by the MLP backwards #4 and #10 (mlp_bwd.cuh: the dual
// form DualMlp, two products of one output tile in one K loop with an
// epilogue of its own; ColsTN for dW1 and dW2; RowsNT for dln to fp32 and
// dx to bf16) and forwards #2 and #9 (mlp_fwd.cuh: DenseEpi, x @ w with an
// epilogue of its own, bias + GELU, or bias and a residual). Every operand
// is read by a TMA map as it lies.
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
// - Operand forms, set by the policy: a K-major operand (A [M, K], or B
//   stored [N, K], as the weights of dy @ W^T lie) is read without a
//   transpose bit, 128-byte rows of 8-row swizzle atoms (SBO = 1 KB); an
//   M-major A (stored [K, M], the activations of X^T dY) or N-major B
//   (stored [K, N]) is read through wgmma's transpose bit: each 64-wide box
//   of a stage is a column of 8-row swizzle atoms (LBO = the box's 8 KB,
//   SBO = 1 KB), so nothing is copied into a transposed buffer.
// - Split-K: block (tile, z) walks its own range of the K steps and stores
//   its fp32 sum as partial z; the caller reduces the partials in a fixed
//   order (no float atomics, so reruns are bit-identical).
// - Epilogue in registers: fp32 -> bf16 pairs, transposed within each quad
//   of lanes by shuffles so that every thread stores 16-byte vectors
//   (64 contiguous bytes a row per quad); fp32 pairs swapped between the
//   two lanes of a quad's halves into float4s (64 contiguous bytes a row
//   per quad as well); masked at M and N. Two blocks share an SM at BN =
//   128 (~97 KB of shared memory each), so one block's epilogue and
//   prologue overlap the other's products; BN = 256 runs one block with
//   four stages.
// - Two products (a policy with kProducts = 2): each stage also holds a
//   second A tile and its B boxes, all four loads complete one full
//   barrier, and a second accumulator of the same m64nBNk16 shape takes
//   the second product, so element i of one lies at element i of the
//   other whatever the transpose bits; the policy's epilogue gets both,
//   and an [8 warps x BN] fp32 scratch in shared memory, in place of the
//   store.
// - One product with an epilogue of its own (a policy with kEpilogue):
//   the policy gets the accumulator in place of the store, in the fragment
//   layout, and finishes it element by element (bias, GELU, a residual
//   read as bf16 pairs) before it calls store_group. The policies without
//   it (DenseRows, RowsNT, ColsTN, ConvTaps) take the store as before.
//
// Requirements: N and every operand's row a multiple of 8 elements
// (16-byte rows for TMA and the vector stores); the policy's tensor maps
// describe its operands; 16-byte aligned pointers. Not done here (later steps): a persistent grid whose producer
// runs on into the next tile (at K = 384 a tile's six steps leave the ring's
// latency exposed), clusters with multicast of B, setmaxnreg, a TMA store.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through
                   // the runtime's driver entry point, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

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

// d[64 x N] += A[64 x 16] (descriptor da; TA = 1: M-major, read through
// the transpose bit) * B[16 x N] (descriptor db; TB = 1: N-major, read
// through the transpose bit); scale_d 0 ignores d
template <int N, int TA, int TB>
struct Mma;

template <int TA, int TB>
struct Mma<64, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<128, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
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
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<256, TA, TB> {
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
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
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

// Stores columns [n0 + 32 c4, n0 + 32 c4 + 32) of a thread's two rows (row,
// row + 8) of a consumer warp's accumulators, masked at M and N.
// acc[4j + {0, 1}]: row lane / 4, columns 8j + 2 (lane % 4) + {0, 1};
// acc[4j + {2, 3}]: the same columns 8 rows lower.
template <int BN, class Out>
__device__ __forceinline__ void store_group(const float (&acc)[BN / 2],
                                            int c4, Out* __restrict__ out,
                                            int row, int n0, int M, int N,
                                            int lane) {
  if constexpr (sizeof(Out) == 2) {
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
  } else {
    // fp32: lanes 2p and 2p + 1 of a quad swap pairs, so that the even
    // lane holds columns 4p..4p+3 of chunk j and the odd one those of
    // chunk j + 1, one float4 each (64 contiguous bytes a row per quad)
    const bool odd = lane & 1;
#pragma unroll
    for (int j = 4 * c4; j < 4 * c4 + 4; j += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a = 4 * j + 2 * h;  // chunk j's pair; chunk j + 1's at a + 4
        const float r0 =
            __shfl_xor_sync(0xffffffffu, odd ? acc[a] : acc[a + 4], 1);
        const float r1 =
            __shfl_xor_sync(0xffffffffu, odd ? acc[a + 1] : acc[a + 5], 1);
        const float4 v = odd ? make_float4(r0, r1, acc[a + 4], acc[a + 5])
                             : make_float4(acc[a], acc[a + 1], r0, r1);
        const int col = n0 + 8 * (j + odd) + 4 * ((lane & 3) >> 1);
        const int r = row + 8 * h;
        if (col < N && r < M)
          *reinterpret_cast<float4*>(out + (size_t)r * N + col) = v;
      }
    }
  }
}

// The 256 consumer threads wait for each other (named barrier 1; the
// producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
}

template <int BN, int STAGES, int PRODUCTS>
struct Layout {
  static constexpr int kBBytes = (BN / 64) * kBoxBytes;
  static constexpr int kHalf = kABytes + kBBytes;  // one product's share
  static constexpr int kStage = PRODUCTS * kHalf;
  static constexpr int kBars = STAGES * kStage;  // offset of the barriers
  // the two-product epilogue's [warps][BN] fp32 scratch, after the barriers
  static constexpr int kSums = kBars + 16 * STAGES;
  static constexpr int kSumBytes = PRODUCTS > 1 ? kConsumerWarps * BN * 4 : 0;
  // + 1024 for aligning the ring to the 128-byte swizzle's 1 KB atoms
  static constexpr size_t kBytes = 1024 + kSums + kSumBytes;
};

// Whether a single-product policy finishes its tile itself: it declares
// kEpilogue = true (a policy without kEpilogue, or with it false, gets the
// store of the raw accumulator).
template <class Src, class = void>
struct OwnEpilogue : std::false_type {};
template <class Src>
struct OwnEpilogue<Src, std::void_t<decltype(Src::kEpilogue)>>
    : std::bool_constant<Src::kEpilogue> {};

// Policy (a struct passed by value), its loads issued by one thread:
//   kProducts                           // 1, or 2 (below)
//   kTnspA                              // 0: A K-major; 1: M-major
//   kTnspB                              // 0: B K-major; 1: N-major
//   int steps() const;                  // 64-deep K slices
//   void load_a(uint32_t dst, const CUtensorMap*, uint32_t bar, int step,
//               int m0) const;          // the 128 x 64 A tile (16 KB)
//   void load_b(uint32_t dst, const CUtensorMap*, uint32_t bar, int step,
//               int n) const;           // B's 64 columns from n (8 KB)
// A K-major tile is 128 rows of 128 bytes; an M-major one two 64 x 64
// boxes, [64 k][64 m] each, one per warpgroup. B's boxes lie in column
// order: K-major they are the tile's BN rows of 128 bytes, N-major [64 k]
// [64 n] each. With kProducts = 2 also kTnspA2, kTnspB2 and
//   void load_a2(uint32_t dst, uint32_t bar, int step, int m0) const;
//   void load_b2(uint32_t dst, uint32_t bar, int step, int n) const;
// (the second product's tiles, from tensor maps the policy holds), and
//   template <int BN> void epilogue(float (&acc)[BN / 2],
//       float (&acc2)[BN / 2], Out* out, int M, int N, int m0, int n0,
//       int row, int warp, int lane, float* sums) const;
// which every consumer thread calls once in place of the store. A
// single-product policy may declare kEpilogue (any value) and
//   template <int BN> void epilogue(float (&acc)[BN / 2], Out* out, int M,
//       int N, int n0, int row, int lane) const;
// which every consumer thread calls once in place of the store; no split.
//
// Block (x, z) owns output tile x and K steps [z * split_steps, (z + 1) *
// split_steps); with gridDim.y > 1 its fp32 sum goes to its own partial,
// out + z * M * N.
template <class Src, int BN, int STAGES, int MINB, class Out>
__global__ void __launch_bounds__(kThreads, MINB)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b,
                      const __grid_constant__ Src src,
                      Out* __restrict__ out, int M, int N, int split_steps) {
  constexpr int P = Src::kProducts;
  using L = Layout<BN, STAGES, P>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = ring + L::kBars;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int n_tiles = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int t0 = blockIdx.y * split_steps;
  const int t1 = min(src.steps(), t0 + split_steps);
  const int steps = t1 > t0 ? t1 - t0 : 0;
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
    const uint32_t tx = P * (kABytes + boxes * kBoxBytes);
    for (int t = 0; t < steps; ++t) {
      const int s = t % STAGES;
      const uint32_t a_st = ring + s * L::kStage;
      if (t >= STAGES) mbar_wait(empty0 + 8 * s, ((t / STAGES) + 1) & 1);
      mbar_arrive_expect_tx(full0 + 8 * s, tx);
      src.load_a(a_st, &map_a, full0 + 8 * s, t0 + t, m0);
      for (int j = 0; j < boxes; ++j)
        src.load_b(a_st + kABytes + j * kBoxBytes, &map_b, full0 + 8 * s,
                   t0 + t, n0 + 64 * j);
      if constexpr (P == 2) {
        const uint32_t a2_st = a_st + L::kHalf;
        src.load_a2(a2_st, full0 + 8 * s, t0 + t, m0);
        for (int j = 0; j < boxes; ++j)
          src.load_b2(a2_st + kABytes + j * kBoxBytes, full0 + 8 * s, t0 + t,
                      n0 + 64 * j);
      }
    }
    return;
  }

  // the consumers: warpgroup g owns rows [64 g, 64 g + 64) of the tile.
  // A k16 slice of a K-major operand lies 32 bytes on within each 128-byte
  // row (SBO = 1 KB between 8-row swizzle atoms); of an M- or N-major one
  // 16 rows of 128 bytes on, 2 KB (LBO = the 8 KB between 64-wide boxes,
  // SBO = 1 KB between 8-row atoms along K).
  constexpr uint32_t kStepA = Src::kTnspA ? 2048 : 32;
  constexpr uint32_t kLboA = Src::kTnspA ? kBoxBytes : 16;
  constexpr uint32_t kStepB = Src::kTnspB ? 2048 : 32;
  constexpr uint32_t kLboB = Src::kTnspB ? kBoxBytes : 16;
  const int g = warp >> 2;
  float acc[BN / 2];
  float acc2[P == 2 ? BN / 2 : 1];  // the second product's
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if constexpr (P == 2) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc2[i] = 0.f;
  }
  for (int t = 0; t < steps; ++t) {
    const int s = t % STAGES;
    const uint32_t a_st = ring + s * L::kStage + g * (64 * 128);
    const uint32_t b_st = ring + s * L::kStage + kABytes;
    mbar_wait(full0 + 8 * s, (t / STAGES) & 1);
    fence_acc(acc);
    if constexpr (P == 2) fence_acc(acc2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Mma<BN, Src::kTnspA, Src::kTnspB>::run(
          acc, desc_sw128(a_st + kStepA * kk, kLboA, 1024),
          desc_sw128(b_st + kStepB * kk, kLboB, 1024), 1);
    if constexpr (P == 2) {
      constexpr uint32_t kStepA2 = Src::kTnspA2 ? 2048 : 32;
      constexpr uint32_t kLboA2 = Src::kTnspA2 ? kBoxBytes : 16;
      constexpr uint32_t kStepB2 = Src::kTnspB2 ? 2048 : 32;
      constexpr uint32_t kLboB2 = Src::kTnspB2 ? kBoxBytes : 16;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        Mma<BN, Src::kTnspA2, Src::kTnspB2>::run(
            acc2, desc_sw128(a_st + L::kHalf + kStepA2 * kk, kLboA2, 1024),
            desc_sw128(b_st + L::kHalf + kStepB2 * kk, kLboB2, 1024), 1);
    }
    wgmma_commit();
    fence_acc(acc);
    if constexpr (P == 2) fence_acc(acc2);
    wgmma_wait<1>();  // step t - 1's products are done: free its stage
    fence_acc(acc);
    if constexpr (P == 2) fence_acc(acc2);
    if (t > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((t - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  const int row = m0 + 64 * g + 16 * (warp & 3) + (lane >> 2);
  if constexpr (P == 2) {
    fence_acc(acc2);
    float* sums = reinterpret_cast<float*>(
        smem_raw + (ring - smem_u32(smem_raw)) + L::kSums);
    src.template epilogue<BN>(acc, acc2, out, M, N, m0, n0, row, warp, lane,
                              sums);
  } else if constexpr (OwnEpilogue<Src>::value) {
    src.template epilogue<BN>(acc, out, M, N, n0, row, lane);
  } else {
    out += (size_t)blockIdx.y * M * N;
#pragma unroll
    for (int c4 = 0; c4 < BN / 32; ++c4)
      store_group<BN>(acc, c4, out, row, n0, M, N, lane);
  }
}

// Launches wgmma_gemm_kernel on `stream`, one block per output tile and
// split; returns the launch's cudaError_t. splits > 1 (fp32 partials
// only): split z takes K steps [z * split_steps, (z + 1) * split_steps).
template <class Src, int BN, int STAGES, int MINB, class Out>
cudaError_t launch_wgmma_gemm(const CUtensorMap& map_a,
                              const CUtensorMap& map_b, const Src& src,
                              Out* out, int M, int N, cudaStream_t stream,
                              int splits = 1, int split_steps = INT_MAX) {
  static_assert(BN == 64 || BN == 128 || BN == 256, "the Mma instances");
  static_assert(sizeof(Out) == 2 || sizeof(Out) == 4, "bf16 or fp32 out");
  if (splits > 1 && OwnEpilogue<Src>::value) return cudaErrorInvalidValue;
  auto kernel = wgmma_gemm_kernel<Src, BN, STAGES, MINB, Out>;
  constexpr size_t smem = Layout<BN, STAGES, Src::kProducts>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  if (M <= 0 || N <= 0 || N % 8 || tiles > INT_MAX || splits < 1 ||
      splits > 65535 || split_steps < 1 || (splits > 1 && sizeof(Out) != 4))
    return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)tiles, splits), kThreads, smem, stream>>>(
      map_a, map_b, src, out, M, N, split_steps);
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

// The three dense forms, all operands row-major bf16 and read by tiled
// maps as they lie. Each gives its loads and its tensor maps for
// out[M, N] = sum over k < K of A(m, k) * B(k, n).

// x @ w: A = x [M, K] K-major, B = w [K, N] N-major (#19b).
struct DenseRows {
  static constexpr int kProducts = 1;
  static constexpr int kTnspA = 0, kTnspB = 1;
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
  static cudaError_t encode(CUtensorMap* ma, CUtensorMap* mb, const void* a,
                            const void* b, int M, int N, int K) {
    const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t b_dims[2] = {(uint64_t)N, (uint64_t)K};
    const uint32_t a_box[2] = {kBK, kBM}, b_box[2] = {64, kBK};
    const cudaError_t err = encode_bf16(ma, a, 2, a_dims, a_box);
    return err != cudaSuccess ? err : encode_bf16(mb, b, 2, b_dims, b_box);
  }
};

// a @ w^T: A = a [M, K] K-major, B = w [N, K] K-major, the weights read as
// they lie (the input gradients dy @ W^T).
struct RowsNT {
  static constexpr int kProducts = 1;
  static constexpr int kTnspA = 0, kTnspB = 0;
  int K;

  __device__ int steps() const { return (K + kBK - 1) / kBK; }
  __device__ void load_a(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int step, int m0) const {
    tma_load_2d(dst, map, bar, step * kBK, m0);
  }
  __device__ void load_b(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int step, int n) const {
    tma_load_2d(dst, map, bar, step * kBK, n);
  }
  static cudaError_t encode(CUtensorMap* ma, CUtensorMap* mb, const void* a,
                            const void* b, int M, int N, int K) {
    const uint64_t a_dims[2] = {(uint64_t)K, (uint64_t)M};
    const uint64_t b_dims[2] = {(uint64_t)K, (uint64_t)N};
    const uint32_t a_box[2] = {kBK, kBM}, b_box[2] = {kBK, 64};
    const cudaError_t err = encode_bf16(ma, a, 2, a_dims, a_box);
    return err != cudaSuccess ? err : encode_bf16(mb, b, 2, b_dims, b_box);
  }
};

// a^T @ b over K rows: A = a [K, M] M-major, B = b [K, N] N-major (the
// weight gradients X^T dY, K = the activation rows).
struct ColsTN {
  static constexpr int kProducts = 1;
  static constexpr int kTnspA = 1, kTnspB = 1;
  int K;

  __device__ int steps() const { return (K + kBK - 1) / kBK; }
  __device__ void load_a(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int step, int m0) const {
    tma_load_2d(dst, map, bar, m0, step * kBK);
    tma_load_2d(dst + kBoxBytes, map, bar, m0 + 64, step * kBK);
  }
  __device__ void load_b(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int step, int n) const {
    tma_load_2d(dst, map, bar, n, step * kBK);
  }
  static cudaError_t encode(CUtensorMap* ma, CUtensorMap* mb, const void* a,
                            const void* b, int M, int N, int K) {
    const uint64_t a_dims[2] = {(uint64_t)M, (uint64_t)K};
    const uint64_t b_dims[2] = {(uint64_t)N, (uint64_t)K};
    const uint32_t box[2] = {64, kBK};
    const cudaError_t err = encode_bf16(ma, a, 2, a_dims, box);
    return err != cudaSuccess ? err : encode_bf16(mb, b, 2, b_dims, box);
  }
};

// Split count of a split-K product [M, N] over K: about two blocks per SM
// of the 132 in all, at least eight 64-deep steps a split, and no split
// empty (so launch_dense with this count writes every partial).
inline int split_count(int M, int N, int K) {
  const int steps = (K + kBK - 1) / kBK;
  const int tiles = ((M + kBM - 1) / kBM) * ((N + 127) / 128);
  int s = (2 * 132 + tiles - 1) / tiles;
  if (s > steps / 8) s = steps / 8;
  if (s < 1) s = 1;
  const int per = (steps + s - 1) / s;
  return (steps + per - 1) / per;
}

// out = the product of form Src (DenseRows, RowsNT, ColsTN) on 128 x 128
// tiles, three stages, two blocks an SM. Out bf16 or fp32; splits > 1
// (fp32 only): `splits` partials [M, N] from out on, split z summing the
// K steps [z * per, (z + 1) * per), per = ceil(steps / splits). N and the
// row strides multiples of 8 elements (16 bytes for TMA and the vector
// stores), 16-byte aligned operands. Encodes the two tensor maps on the
// host and launches once; returns the first failing cudaError_t.
template <class Src, class Out>
cudaError_t launch_dense(const bf16* a, const bf16* b, Out* out, int M,
                         int N, int K, int splits, cudaStream_t stream) {
  const int a_row = Src::kTnspA ? M : K;
  const int b_row = Src::kTnspB ? N : K;
  if (M <= 0 || N <= 0 || K <= 0 || splits < 1 || N % 8 || a_row % 8 ||
      b_row % 8 ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  const cudaError_t err = Src::encode(&map_a, &map_b, a, b, M, N, K);
  if (err != cudaSuccess) return err;
  const int steps = (K + kBK - 1) / kBK;
  const int per = (steps + splits - 1) / splits;
  return launch_wgmma_gemm<Src, 128, 3, 2>(map_a, map_b, Src{K}, out, M, N,
                                           stream, splits, per);
}

}  // namespace wg
}  // namespace vlp
