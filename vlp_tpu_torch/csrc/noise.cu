// add_gaussian_noise: out = x + sigma[b] * N(0, 1) per sample, fp32, with a
// Philox4x32-10 stream per sample and Box-Muller over 16-bit halves.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/pallas_noise.py:add_gaussian_noise,
// which draws its words from the TPU's hardware PRNG
// (pltpu.prng_random_bits); an H100 has none, so a counter-based generator
// written into the kernel takes its place, keyed by the sample's two seed
// words. Counter layout (vlp_tpu_torch/ops/noise.py says the same): word
// w = y * (W/2) + x of sample b is output w mod 4 of Philox4x32-10 at
// counter (w / 4, 0, 0, 0) under key (seeds[b, 0], seeds[b, 1]) read as
// uint32. Each word gives one Box-Muller pair, exactly the JAX formula
// (bits_to_gaussian_pair): u1 = lo16 * 2^-16 + 2^-17, u2 = hi16 * 2^-16,
// r = sqrt(-2 log u1), cos branch at (y, x), sin branch at (y, x + W/2).
// logf, sqrtf, cosf and sinf are the accurate library forms (no fast-math
// intrinsics); x + sigma * z is written with __fmul_rn/__fadd_rn so that it
// rounds as the plain PyTorch version does.
//
// What bounds it on this card: 8 bytes of x and out per pixel, and per word
// 10 Philox rounds (20 32x32 multiplies) plus log, sqrt, sin and cos for two
// pixels: roughly 60 instructions per pixel against 8 bytes, so near the
// H100's compute-to-bandwidth balance; one thread per Philox call (four
// words, eight pixels) amortises the rounds. [64, 224, 224] moves 25.7 MB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += W0;
      k.y += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ void box_muller(uint32_t bits, float& zc,
                                           float& zs) {
  const float u1 = (float)(bits & 0xFFFFu) * 1.52587890625e-05f +
                   7.62939453125e-06f;  // * 2^-16 + 2^-17, both exact
  const float u2 = (float)(bits >> 16) * 1.52587890625e-05f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float t = 6.283185307179586f * u2;
  zc = r * cosf(t);
  zs = r * sinf(t);
}

// grid (ceil(groups / 256), B), groups = ceil(H * W / 2 / 4).
__global__ void noise_kernel(const float* __restrict__ x,
                             const int32_t* __restrict__ seeds,
                             const float* __restrict__ sigma,
                             float* __restrict__ out, int H, int W) {
  const int b = blockIdx.y;
  const int half = W / 2;
  const int nwords = H * half;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * g >= nwords) return;
  const uint2 key = make_uint2((uint32_t)seeds[2 * b], (uint32_t)seeds[2 * b + 1]);
  const uint4 w4 = philox4x32_10(make_uint4((uint32_t)g, 0u, 0u, 0u), key);
  const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
  const float s = sigma[b];
  const size_t base = (size_t)b * H * W;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int w = 4 * g + q;
    if (w >= nwords) break;
    const int y = w / half;
    const int xx = w % half;
    float zc, zs;
    box_muller(words[q], zc, zs);
    const size_t lo = base + (size_t)y * W + xx;
    out[lo] = __fadd_rn(x[lo], __fmul_rn(s, zc));
    out[lo + half] = __fadd_rn(x[lo + half], __fmul_rn(s, zs));
  }
}

__global__ void philox_kernel(const int32_t* __restrict__ ctr,
                              const int32_t* __restrict__ key,
                              int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 c = make_uint4((uint32_t)ctr[4 * i], (uint32_t)ctr[4 * i + 1],
                             (uint32_t)ctr[4 * i + 2], (uint32_t)ctr[4 * i + 3]);
  const uint4 r = philox4x32_10(
      c, make_uint2((uint32_t)key[2 * i], (uint32_t)key[2 * i + 1]));
  out[4 * i] = (int32_t)r.x;
  out[4 * i + 1] = (int32_t)r.y;
  out[4 * i + 2] = (int32_t)r.z;
  out[4 * i + 3] = (int32_t)r.w;
}

}  // namespace

// x, out [B, H, W] fp32 (W even); seeds [B, 2] int32; sigma [B] fp32.
// Returns the launch's cudaError_t.
extern "C" int vlp_add_gaussian_noise(const void* x, const void* seeds,
                                      const void* sigma, void* out, int B,
                                      int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || W % 2 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int groups = (H * (W / 2) + 3) / 4;
  const int threads = 256;
  noise_kernel<<<dim3((groups + threads - 1) / threads, B), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(seeds),
      static_cast<const float*>(sigma), static_cast<float*>(out), H, W);
  return (int)cudaGetLastError();
}

// The same Philox4x32-10 on n counters [n, 4] and keys [n, 2] (int32 bit
// patterns) -> out [n, 4], for the known-answer vectors and for holding the
// noise kernel's words to the plain version's.
extern "C" int vlp_philox4x32(const void* ctr, const void* key, void* out,
                              int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  philox_kernel<<<(n + threads - 1) / threads, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ctr), static_cast<const int32_t*>(key),
      static_cast<int32_t*>(out), n);
  return (int)cudaGetLastError();
}
