// conv3x3: a 3x3 convolution, stride 1, SAME padding, as an implicit GEMM:
//
//   y[b*H*W + h*W + w, k] = bf16( sum over (dy, dx) in 3x3, c in C of
//       x[b, h + dy - 1, w + dx - 1, c] * wt[dy, dx, c, k] )   (0 outside)
//
// x [B, H, W, C] bf16, wt [3, 3, C, K] bf16, y [B*H*W, K] bf16, fp32
// accumulation rounded once. Replaces the Pallas TPU kernel
// benchmarks/conv_probe.py:pallas_conv3x3 (_conv_kernel), the probe of an
// implicit-GEMM conv at ResNet34's stage-2/3 shapes.
//
// The TPU kernel reads a jnp.pad-ed map, holds a group of padded samples in
// VMEM and forms the 9 shifted [g*H*W, C] @ [C, K] products. Here a block
// owns 128 output pixels x 128 output channels (implicit_gemm.cuh) and walks
// the 9 taps x C in slices of 32 channels; for each slice every thread works
// out the shifted source pixel of its two rows and cp.async zero-fills the
// ones that fall outside the map, so the halo is masked in flight and no
// padded copy is made in device memory.
//
// What bounds it on this card: at the probe's shapes (batch 128, 28x28x128
// and 14x14x256) 2.96e10 operations each against 51.7 MB and 26.9 MB moved,
// so the bf16 tensor cores bound it (0.030 ms at 989 TFLOP/s) and not the
// memory (0.015 / 0.008 ms at 3.35 TB/s). This simple form (wmma, two
// cp.async stages, no TMA or wgmma) runs well below that.
#include "implicit_gemm.cuh"

namespace {

using vlp::igemm::bf16;
using vlp::igemm::kBK;

struct ConvTaps {
  const bf16* x;
  const bf16* w;
  int M, H, W, C, K, slices;  // slices = ceil(C / 32) per tap

  struct Row {
    int b, y, x;
    bool in;
  };

  __device__ Row row(int m) const {
    Row r;
    r.in = m < M;
    const int mm = r.in ? m : 0;
    r.x = mm % W;
    r.y = (mm / W) % H;
    r.b = mm / (W * H);
    return r;
  }

  __device__ int steps() const { return 9 * slices; }

  __device__ const bf16* a_src(const Row& r, int step, int col,
                               bool* ok) const {
    const int tap = step / slices;
    const int c = (step - tap * slices) * kBK + col;
    const int yy = r.y + tap / 3 - 1;
    const int xx = r.x + tap % 3 - 1;
    *ok = r.in && c < C && yy >= 0 && yy < H && xx >= 0 && xx < W;
    return *ok ? x + (((size_t)r.b * H + yy) * W + xx) * C + c : x;
  }

  __device__ const bf16* b_src(int step, int k, int n, bool* ok) const {
    const int tap = step / slices;
    const int c = (step - tap * slices) * kBK + k;
    *ok = c < C && n < K;
    return *ok ? w + ((size_t)tap * C + c) * K + n : w;
  }

  static constexpr bool kTransform = false;
  __device__ void transform(int, int, uint4*) const {}
};

}  // namespace

// x [B, H, W, C], wt [3, 3, C, K], y [B*H*W, K], all bf16; C and K multiples
// of 16. Returns the launch's cudaError_t.
extern "C" int vlp_conv3x3(const void* x, const void* wt, void* y, int B,
                           int H, int W, int C, int K, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0 || C % 16 || K % 16 ||
      (long long)B * H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ConvTaps src;
  src.x = static_cast<const bf16*>(x);
  src.w = static_cast<const bf16*>(wt);
  src.M = B * H * W;
  src.H = H;
  src.W = W;
  src.C = C;
  src.K = K;
  src.slices = (C + kBK - 1) / kBK;
  return (int)vlp::igemm::launch_igemm(src, static_cast<bf16*>(y), src.M, K,
                                       static_cast<cudaStream_t>(stream));
}
