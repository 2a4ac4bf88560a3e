// shear_rows: per-line fractional shift with edge clamping, fp32, the inner
// op of the 3-shear affine warp.
//
//   out[b, y, x] = lerp(img[b, y, c(k - pad + x)], img[b, y, c(k - pad + x + 1)],
//                       frac),   s = clip(shift[b, y], +-max_shift) + pad,
//   k = floor(s), frac = s - k, pad = max_shift + 1, c = clamp to [0, W - 1]
//
// (axis 1; with axis 0 the lines are columns: shift [B, W] and the index
// runs along y.) Replaces the Pallas TPU kernel
// vlp_tpu/ops/pallas_shear.py:shear_rows (wrapper shear_axis1_batched).
//
// The TPU kernel edge-pads each row to a lane-aligned width and turns the
// per-row variable shift into log2(max_shift) fixed lane rotations selected
// by the shift's bits, because a TPU has no cheap per-lane gather. Here
// clamping the two taps' indices is the edge padding (every index the TPU
// kernel reads lies inside its padded row, and a padded element is the
// clamped image element), so no padded copy is made, and the y-shear reads
// columns in place instead of transposing.
//
// What bounds it on this card: 8 bytes moved per pixel (the image read once
// and written once) against 3 flops: memory. [128, 224, 224] moves 51.4 MB,
// 15.3 us at 3.35 TB/s. The design keeps each pixel's device-memory
// traffic at that: a block stages its lines in shared memory, and both taps
// of every output come from there, never from L1 or L2 again.
//   - Axis 1 (rows): a warp owns a row. It stages the row with 16-byte
//     loads (when W % 4 == 0 and both pointers are 16-byte aligned, else
//     4-byte ones), then each lane forms four neighbouring outputs from the
//     five taps they share and writes them with one 16-byte store. The row
//     lies in shared memory XOR-swizzled (word e at e ^ ((e >> 5) & 3)), so
//     that lane j's taps 4j + d + q fall in 32 distinct banks for every
//     shift d, and the staging stores too.
//   - Axis 0 (columns): a block stages a strip of 32 columns x H rows, read
//     as 128-byte row segments and padded to 33 words a row; a lane owns a
//     column, reads its two taps from the strip and writes back row
//     segments.
// A line's shift is read once and its clip, + pad, floor and fraction
// computed once. All index arithmetic is 32-bit: the wrapper refuses
// B * H * W >= 2^31.
//
// The lerp is written with __fmul_rn/__fadd_rn so that nvcc does not
// contract a * (1 - f) + c * f into an FMA: each product and the sum round
// separately, as in the plain PyTorch version, and the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowWarps = 8;   // rows of an axis-1 block, one a warp
constexpr int kStrip = 32;     // columns of an axis-0 block, one a lane
constexpr int kColWarps = 8;   // warps of an axis-0 block
constexpr int kMaxSmem = 227 * 1024;

// the line's tap offset d = k - pad and fraction f
__device__ __forceinline__ void line_shift(float sh, int max_shift, int& d,
                                           float& f) {
  const float ms = (float)max_shift;
  const float s =
      __fadd_rn(fminf(fmaxf(sh, -ms), ms), (float)(max_shift + 1));
  const float k = floorf(s);
  f = __fsub_rn(s, k);
  d = (int)k - (max_shift + 1);
}

__device__ __forceinline__ float lerp(float a, float c, float f) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(c, f));
}

__device__ __forceinline__ int clampi(int i, int n) {
  return min(max(i, 0), n - 1);
}

// where word e of a staged row lies: its two low bits XOR the bits 5-6
__device__ __forceinline__ int swz(int e) { return e ^ ((e >> 5) & 3); }

// one row of a staged line: W rounded up to 4 words, as swz keeps a word
// inside its aligned four
__host__ __device__ __forceinline__ int row_words(int W) {
  return (W + 3) & ~3;
}

template <bool kVec>
__global__ void __launch_bounds__(kRowWarps * 32)
    shear_rows_kernel(const float* __restrict__ img,
                      const float* __restrict__ shift,
                      float* __restrict__ out, int H, int W, int max_shift) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = blockIdx.x * kRowWarps + warp;
  if (y >= H) return;  // the warps share nothing: no block barrier below
  float* row = smem + warp * row_words(W);
  const int line = blockIdx.y * H + y;
  const float* src = img + line * W;
  float* dst = out + line * W;
  int d;
  float f;
  line_shift(shift[line], max_shift, d, f);
  if (kVec) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int j = lane; j < W / 4; j += 32) {
      const float4 v = src4[j];
      const int e = 4 * j;
      row[swz(e)] = v.x;
      row[swz(e + 1)] = v.y;
      row[swz(e + 2)] = v.z;
      row[swz(e + 3)] = v.w;
    }
  } else {
    for (int e = lane; e < W; e += 32) row[swz(e)] = src[e];
  }
  __syncwarp();
  if (kVec) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int j = lane; j < W / 4; j += 32) {
      const int i0 = 4 * j + d;
      float t[5];
#pragma unroll
      for (int q = 0; q < 5; ++q) t[q] = row[swz(clampi(i0 + q, W))];
      dst4[j] = make_float4(lerp(t[0], t[1], f), lerp(t[1], t[2], f),
                            lerp(t[2], t[3], f), lerp(t[3], t[4], f));
    }
  } else {
    for (int x = lane; x < W; x += 32) {
      const int i0 = x + d;
      dst[x] =
          lerp(row[swz(clampi(i0, W))], row[swz(clampi(i0 + 1, W))], f);
    }
  }
}

__global__ void __launch_bounds__(kColWarps * 32)
    shear_cols_kernel(const float* __restrict__ img,
                      const float* __restrict__ shift,
                      float* __restrict__ out, int H, int W, int max_shift) {
  extern __shared__ float strip[];  // [H][kStrip + 1]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int x = blockIdx.x * kStrip + lane;
  const bool inside = x < W;
  const int base = b * H * W + x;
  constexpr int ld = kStrip + 1;
  if (inside) {
    // each warp reads rows warp, warp + 8, ...: 128-byte segments, four
    // loads in flight before their shared-memory stores
    int y = warp;
    for (; y + 3 * kColWarps < H; y += 4 * kColWarps) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = img[base + (y + u * kColWarps) * W];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        strip[(y + u * kColWarps) * ld + lane] = v[u];
    }
    for (; y < H; y += kColWarps)
      strip[y * ld + lane] = img[base + y * W];
  }
  int d = 0;
  float f = 0.0f;
  if (inside) line_shift(shift[b * W + x], max_shift, d, f);
  __syncthreads();
  if (!inside) return;
  for (int y = warp; y < H; y += kColWarps) {
    const int i0 = y + d;
    out[base + y * W] = lerp(strip[clampi(i0, H) * ld + lane],
                             strip[clampi(i0 + 1, H) * ld + lane], f);
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, const float* img, const float* shift,
           float* out, int H, int W, int max_shift) {
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(img, shift, out, H, W, max_shift);
  return (int)cudaGetLastError();
}

}  // namespace

// img, out [B, H, W] fp32; shift [B, H] (axis 1) or [B, W] (axis 0) fp32.
// Returns the launch's cudaError_t; cudaErrorInvalidValue for B * H * W >=
// 2^31, B > 65535, or a line longer than shared memory holds (axis 1: W >
// 7264; axis 0: H > 1760).
extern "C" int vlp_shear_rows(const void* img, const void* shift, void* out,
                              int B, int H, int W, int max_shift, int axis,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || max_shift < 0 || B > 65535 ||
      (axis != 0 && axis != 1) || (int64_t)B * H * W >= (int64_t(1) << 31))
    return (int)cudaErrorInvalidValue;
  const float* src = static_cast<const float*>(img);
  const float* sh = static_cast<const float*>(shift);
  float* dst = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (axis == 0) {
    const size_t smem = (size_t)H * (kStrip + 1) * sizeof(float);
    return launch(shear_cols_kernel, dim3((W + kStrip - 1) / kStrip, B),
                  kColWarps * 32, smem, st, src, sh, dst, H, W, max_shift);
  }
  const dim3 grid((H + kRowWarps - 1) / kRowWarps, B);
  const size_t smem = (size_t)kRowWarps * row_words(W) * sizeof(float);
  const bool vec = W % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(img) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return vec ? launch(shear_rows_kernel<true>, grid, kRowWarps * 32, smem, st,
                      src, sh, dst, H, W, max_shift)
             : launch(shear_rows_kernel<false>, grid, kRowWarps * 32, smem,
                      st, src, sh, dst, H, W, max_shift);
}
