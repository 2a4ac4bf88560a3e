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
// by the shift's bits, because a TPU has no cheap per-lane gather. An H100
// gathers from L1/L2 at no extra cost, so one thread computes one output
// pixel with two clamped reads: clamping is the edge padding (every index
// the TPU kernel reads lies inside its padded row, and a padded element is
// the clamped image element), so no padded copy is made and the y-shear
// reads columns in place instead of transposing.
//
// The lerp is written with __fmul_rn/__fadd_rn so that nvcc does not
// contract a * (1 - f) + b * f into an FMA: each product and the sum round
// separately, as in the plain PyTorch version, and the two agree bit for bit.
//
// What bounds it on this card: 8 bytes moved per output pixel (one 4-byte
// read, usually an L1 hit for the neighbour, and one 4-byte write) and a few
// flops: memory-bound. [64, 224, 224] is 12.8 MB each way, about 8 us at
// 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

__global__ void shear_kernel(const float* __restrict__ img,
                             const float* __restrict__ shift,
                             float* __restrict__ out, int B, int H, int W,
                             int max_shift, int axis) {
  const size_t total = (size_t)B * H * W;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % W);
  const int y = (int)((i / W) % H);
  const int b = (int)(i / ((size_t)W * H));
  const int line = axis == 1 ? y : x;     // which shift
  const int pos = axis == 1 ? x : y;      // position along the line
  const int len = axis == 1 ? W : H;
  const float ms = (float)max_shift;
  const float sh = shift[(size_t)b * (axis == 1 ? H : W) + line];
  const float s = __fadd_rn(fminf(fmaxf(sh, -ms), ms), (float)(max_shift + 1));
  const float k = floorf(s);
  const float f = __fsub_rn(s, k);
  const int i0 = (int)k - (max_shift + 1) + pos;
  const int lo = min(max(i0, 0), len - 1);
  const int hi = min(max(i0 + 1, 0), len - 1);
  const size_t base = (size_t)b * H * W;
  const float a = axis == 1 ? img[base + (size_t)y * W + lo]
                            : img[base + (size_t)lo * W + x];
  const float c = axis == 1 ? img[base + (size_t)y * W + hi]
                            : img[base + (size_t)hi * W + x];
  out[i] = __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(c, f));
}

}  // namespace

// img, out [B, H, W] fp32; shift [B, H] (axis 1) or [B, W] (axis 0) fp32.
// Returns the launch's cudaError_t.
extern "C" int vlp_shear_rows(const void* img, const void* shift, void* out,
                              int B, int H, int W, int max_shift, int axis,
                              void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || max_shift < 0 || (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * H * W;
  const int threads = 256;
  shear_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(shift),
      static_cast<float*>(out), B, H, W, max_shift, axis);
  return (int)cudaGetLastError();
}
