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
// normalises the tile in VMEM. Here it runs on the wgmma + TMA mainloop
// (wgmma_gemm.cuh) in its register-A form, AffineReluRows: TMA brings x
// and W into the swizzled ring as for any dense product, each consumer
// warp reads its 16 rows of a stage's x with ldmatrix, applies the affine
// and the ReLU to those registers and hands them to wgmma as A, so the
// normalised map never reaches shared or device memory: a prologue on the
// A tile with a per-column affine and no row statistics.
//
// What bounds it on this card: at the probe's shapes (batch 128:
// [401408, 256] -> 64, [100352, 512] -> 128, [401408, 64] -> 256) it moves
// 256.9 / 128.5 / 256.9 MB for 2mCK = 1.3e10 / 1.3e10 / 1.3e10 operations,
// so the memory bounds it: 0.077 / 0.038 / 0.077 ms at 3.35 TB/s (the
// tensor cores need 0.013). So a tile spans the whole output row where K
// <= 128 (BN = 64 or 128), and x is read from device memory once; at K =
// 256 two 128-wide tiles of a row block run side by side, the second read
// of x mostly from L2. On an H100 at the probe's 64 -> 256 that took
// 0.134 ms where one 256-wide tile a block (one block an SM, x read once)
// took 0.159 and four 64-wide ones 0.178 (scripts/bn_gemm_widths.py).
#include "wgmma_gemm.cuh"

// x [M, C] bf16, a and b [C] fp32, w [C, K] bf16, out [M, K] bf16; C and K
// multiples of 16, C <= 1024 (wgmma_gemm.cuh's kMaxAffineChannels), x, w
// and out 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int vlp_bn_relu_gemm(const void* x, const void* a, const void* b,
                                const void* w, void* out, int M, int C, int K,
                                void* stream) {
  namespace wg = vlp::wg;
  if (M <= 0 || C <= 0 || K <= 0 || C % 16 || K % 16)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const wg::bf16*>(x);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  const auto* wb = static_cast<const wg::bf16*>(w);
  auto* ob = static_cast<wg::bf16*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  return (int)(K <= 64 ? wg::launch_affine_relu<64>(xb, af, bf, wb, ob, M, C,
                                                    K, st)
                      : wg::launch_affine_relu<128>(xb, af, bf, wb, ob, M,
                                                    C, K, st));
}
