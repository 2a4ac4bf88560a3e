// bn_relu_gemm: a GEMM with a folded BatchNorm affine and ReLU as its
// prologue:
//
//   out[M, K] = bf16( bf16(relu(x * a + b)) @ W )
//
// x [M, C] bf16, a and b [C] fp32 (the BatchNorm folded to one scale and
// shift per channel), W [C, K] bf16, fp32 accumulation rounded once.
// x * a + b rounds the product and the sum separately (__fmul_rn/__fadd_rn,
// no FMA contraction), as the plain PyTorch version's two tensor ops do, so
// the normalised operand is the same to the bit. Replaces the Pallas TPU
// kernel benchmarks/bn_gemm_probe.py:make_pallas (_bn_gemm_kernel), the
// probe of the ResNet50 bottleneck boundary relu(bn(x)) @ W.
//
// The TPU kernel takes a row tile of x and the whole W per grid step and
// normalises the tile in VMEM. Here a block owns 128 rows x 128 columns of
// the output (implicit_gemm.cuh); each 128x32 slice of x arrives in shared
// memory through cp.async and every thread rewrites the two 8-element
// vectors it loaded (affine, ReLU, bf16) before the block's barrier, so the
// normalised map never goes to device memory: a prologue on the A tile with
// a per-column affine and no row statistics.
//
// What bounds it on this card: at the probe's shapes (batch 128:
// [401408, 256] -> 64, [100352, 512] -> 128, [401408, 64] -> 256) it moves
// 256.9 / 128.5 / 256.9 MB for 2mCK = 1.3e10 / 1.3e10 / 1.3e10 operations,
// so the memory bounds it: 0.077 / 0.038 / 0.077 ms at 3.35 TB/s. x is read
// once per 128 output columns: once at K <= 128, twice at K = 256 (the
// second read mostly from L2).
#include "implicit_gemm.cuh"

namespace {

using vlp::igemm::bf16;
using vlp::igemm::kBK;

struct AffineRows {
  const bf16* x;
  const float* a;
  const float* b;
  const bf16* w;
  int M, C, K, slices;  // slices = ceil(C / 32)

  struct Row {
    int m;
    bool in;
  };

  __device__ Row row(int m) const { return Row{m, m < M}; }

  __device__ int steps() const { return slices; }

  __device__ const bf16* a_src(const Row& r, int step, int col,
                               bool* ok) const {
    const int c = step * kBK + col;
    *ok = r.in && c < C;
    return *ok ? x + (size_t)r.m * C + c : x;
  }

  __device__ const bf16* b_src(int step, int k, int n, bool* ok) const {
    const int c = step * kBK + k;
    *ok = c < C && n < K;
    return *ok ? w + (size_t)c * K + n : w;
  }

  static constexpr bool kTransform = true;

  // relu(x * a + b) -> bf16 on the 8 channels at step * 32 + col; channels
  // past C stay the zeros cp.async filled in
  __device__ void transform(int step, int col, uint4* v) const {
    const int c = step * kBK + col;
    if (c >= C) return;
    bf16* e = reinterpret_cast<bf16*>(v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float t = __fadd_rn(__fmul_rn(__bfloat162float(e[i]), a[c + i]),
                                b[c + i]);
      e[i] = __float2bfloat16(fmaxf(t, 0.f));
    }
  }
};

}  // namespace

// x [M, C] bf16, a and b [C] fp32, w [C, K] bf16, out [M, K] bf16; C and K
// multiples of 16. Returns the launch's cudaError_t.
extern "C" int vlp_bn_relu_gemm(const void* x, const void* a, const void* b,
                                const void* w, void* out, int M, int C, int K,
                                void* stream) {
  if (M <= 0 || C <= 0 || K <= 0 || C % 16 || K % 16)
    return (int)cudaErrorInvalidValue;
  AffineRows src;
  src.x = static_cast<const bf16*>(x);
  src.a = static_cast<const float*>(a);
  src.b = static_cast<const float*>(b);
  src.w = static_cast<const bf16*>(w);
  src.M = M;
  src.C = C;
  src.K = K;
  src.slices = (C + kBK - 1) / kBK;
  return (int)vlp::igemm::launch_igemm(src, static_cast<bf16*>(out), M, K,
                                       static_cast<cudaStream_t>(stream));
}
