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
// VMEM and forms the 9 shifted [g*H*W, C] @ [C, K] products. Here it runs
// on the wgmma mainloop (wgmma_gemm.cuh): a block owns 128 consecutive
// output pixels (in NHW order, across rows and images) x BN output channels
// and walks the 9 taps x ceil(C / 64) channel slices. Both operands arrive
// by TMA:
// - A, the shifted map, through an im2col tensor map of x: one load brings
//   64 channels of the 128 pixels, each read at its window corner (h - 1,
//   w - 1) plus the tap's offset (dy, dx), and a pixel outside the map (the
//   halo) or a channel past C arrives as zeros, so nothing is padded in
//   device memory and no thread computes an address.
// - B, the weights seen as [9, C, K], one 64 x 64 box per step of a tiled
//   map (channels past C arrive as zeros).
// A first version had the producer warp gather A itself with cp.async 16
// bytes at a time, zero-filling the halo as the previous engine did; on
// an H100 it ran several times slower than the im2col loads at both probe
// shapes, so the loads are TMA's alone.
//
// What bounds it on this card: at the probe's shapes (batch 128, 28x28x128
// and 14x14x256) 2.96e10 operations each against 51.7 MB and 26.9 MB moved,
// so the bf16 tensor cores bound it (0.030 ms at 989 TFLOP/s) and not the
// memory (0.015 / 0.008 ms at 3.35 TB/s); A is read 9 times, once per tap,
// mostly from L2. BN is 256 where it pads N no more than 128 does (K = 256:
// each A tile serves twice the columns), else 128.
#include "wgmma_gemm.cuh"

namespace {

using vlp::wg::bf16;
using vlp::wg::kBK;

struct ConvTaps {
  static constexpr int kProducts = 1;
  static constexpr int kTnspA = 0, kTnspB = 1;  // A K-major, B N-major
  int H, W, slices;  // slices = ceil(C / 64) per tap

  __device__ int steps() const { return 9 * slices; }

  // the 128 pixels from m0 on at tap t's offset, channels of its slice
  __device__ void load_a(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int t, int m0) const {
    const int tap = t / slices;
    const int img = m0 / (H * W);
    const int rem = m0 - img * H * W;
    const int y = rem / W;
    vlp::wg::tma_load_im2col(dst, map, bar, (t - tap * slices) * kBK,
                             rem - y * W - 1, y - 1, img,
                             static_cast<uint16_t>(tap % 3),
                             static_cast<uint16_t>(tap / 3));
  }

  __device__ void load_b(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int t, int n) const {
    const int tap = t / slices;
    vlp::wg::tma_load_3d(dst, map, bar, n, (t - tap * slices) * kBK, tap);
  }
};

}  // namespace

// x [B, H, W, C], wt [3, 3, C, K], y [B*H*W, K], all bf16, 16-byte aligned;
// C and K multiples of 16. Returns the launch's cudaError_t.
extern "C" int vlp_conv3x3(const void* x, const void* wt, void* y, int B,
                           int H, int W, int C, int K, void* stream) {
  namespace wg = vlp::wg;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || K <= 0 || C % 16 || K % 16 ||
      (long long)B * H * W > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  const uint64_t w_dims[3] = {(uint64_t)K, (uint64_t)C, 9};
  const uint32_t w_box[3] = {64, kBK, 1};
  cudaError_t err = wg::encode_im2col_bf16(&map_x, x, B, H, W, C);
  if (err == cudaSuccess) err = wg::encode_bf16(&map_w, wt, 3, w_dims, w_box);
  if (err != cudaSuccess) return (int)err;
  const ConvTaps src{H, W, (C + kBK - 1) / kBK};
  auto* out = static_cast<bf16*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  if ((K + 255) / 256 * 256 <= (K + 127) / 128 * 128)
    return (int)wg::launch_wgmma_gemm<ConvTaps, 256, 4, 1>(map_x, map_w, src,
                                                            out, M, K, s);
  return (int)wg::launch_wgmma_gemm<ConvTaps, 128, 3, 2>(map_x, map_w, src,
                                                          out, M, K, s);
}
