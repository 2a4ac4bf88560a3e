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
// logf, sqrtf and sincosf are the accurate library forms (no fast-math
// intrinsics; sincosf's sine and cosine are within 2 ulps, as sinf and cosf
// are); x + sigma * z is written with __fmul_rn/__fadd_rn so that it rounds
// as the plain PyTorch version does.
//
// What bounds it on this card: 8 bytes of x and out per pixel, and per word
// 10 Philox rounds (20 32x32 multiplies) plus log, sqrt and a sine-cosine
// pair for two pixels: near the H100's compute-to-bandwidth balance.
// [128, 224, 224] moves 51.4 MB, 15.3 us at 3.35 TB/s. One thread takes one
// Philox call (four words, eight pixels), which amortises the rounds; one
// sincosf shares the range reduction of both branches. Where W/2 % 4 == 0
// (W = 224: 112 words a row) a thread's four words are four neighbouring
// columns of one row, so it reads the cos half and the sin half of x as two
// 16-byte loads and writes two 16-byte stores; other even widths (226: 113
// words a row, so four words may cross a row's end) take a scalar path of
// eight 4-byte accesses.
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
  float sn, cs;
  sincosf(6.283185307179586f * u2, &sn, &cs);
  zc = r * cs;
  zs = r * sn;
}

__device__ __forceinline__ uint32_t word(uint4 w4, int q) {
  return q == 0 ? w4.x : q == 1 ? w4.y : q == 2 ? w4.z : w4.w;
}

__device__ __forceinline__ float add_noise(float x, float s, float z) {
  return __fadd_rn(x, __fmul_rn(s, z));
}

// grid (ceil(groups / 256), B), groups = ceil(H * W / 2 / 4); kVec needs
// W/2 % 4 == 0 and 16-byte aligned x and out.
template <bool kVec>
__global__ void __launch_bounds__(256)
    noise_kernel(const float* __restrict__ x, const int32_t* __restrict__ seeds,
                 const float* __restrict__ sigma, float* __restrict__ out,
                 int H, int W) {
  const int b = blockIdx.y;
  const int half = W / 2;
  const int nwords = H * half;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * g >= nwords) return;
  const uint2 key =
      make_uint2((uint32_t)seeds[2 * b], (uint32_t)seeds[2 * b + 1]);
  const uint4 w4 = philox4x32_10(make_uint4((uint32_t)g, 0u, 0u, 0u), key);
  const float s = sigma[b];
  const int base = b * H * W;
  if (kVec) {
    const int y = 4 * g / half;
    const int lo = base + y * W + (4 * g - y * half);
    const float4 xc = *reinterpret_cast<const float4*>(x + lo);
    const float4 xs = *reinterpret_cast<const float4*>(x + lo + half);
    float zc[4], zs[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) box_muller(word(w4, q), zc[q], zs[q]);
    *reinterpret_cast<float4*>(out + lo) =
        make_float4(add_noise(xc.x, s, zc[0]), add_noise(xc.y, s, zc[1]),
                    add_noise(xc.z, s, zc[2]), add_noise(xc.w, s, zc[3]));
    *reinterpret_cast<float4*>(out + lo + half) =
        make_float4(add_noise(xs.x, s, zs[0]), add_noise(xs.y, s, zs[1]),
                    add_noise(xs.z, s, zs[2]), add_noise(xs.w, s, zs[3]));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int w = 4 * g + q;
      if (w < nwords) {
        const int y = w / half;
        const int lo = base + y * W + (w - y * half);
        float zc, zs;
        box_muller(word(w4, q), zc, zs);
        out[lo] = add_noise(x[lo], s, zc);
        out[lo + half] = add_noise(x[lo + half], s, zs);
      }
    }
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
// Returns the launch's cudaError_t; cudaErrorInvalidValue for B * H * W >=
// 2^31 (the kernel's index arithmetic is 32-bit) or B > 65535.
extern "C" int vlp_add_gaussian_noise(const void* x, const void* seeds,
                                      const void* sigma, void* out, int B,
                                      int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || W % 2 || B > 65535 ||
      (int64_t)B * H * W >= (int64_t(1) << 31))
    return (int)cudaErrorInvalidValue;
  const int groups = (H * (W / 2) + 3) / 4;
  const int threads = 256;
  const dim3 grid((groups + threads - 1) / threads, B);
  const bool vec = (W / 2) % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const auto kernel = vec ? &noise_kernel<true> : &noise_kernel<false>;
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
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
