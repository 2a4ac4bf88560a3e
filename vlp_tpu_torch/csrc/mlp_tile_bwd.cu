// mlp_tile_bwd: the backward of mlp_tile's full form, y = x + (h @ W2 + b2),
// h = bf16(gelu(LN(x) * gamma + beta) @ W1 + b1)), over x [M, D] rows.
// Returns dx bf16 and dgamma, dbeta, dW1, db1, dW2, db2 all fp32, each summed
// over every row.
//
// Replaces the Pallas TPU kernel benchmarks/mega_variants.py:make_mlp_bwd
// with the body mlp_bwd_kernel_v0 (:173), the schedule probe of the half
// block's MLP backward (rowpipe :213 and the production fsplit body are
// Mosaic interleavings of the same sums). Its rounding points (:185-210):
// ln = bf16(x_hat * gamma + beta), z = ln @ W1 + b1 in fp32,
// h = bf16(gelu(z)) and gelu'(z) separately (not the shipped #4's
// _gelu_and_grad form), dh = bf16((dy @ W2^T) * gelu'(z)), db1 from the fp32
// product, dln = dh @ W1^T in fp32, dx = bf16(dy + LN_bwd(dln * gamma)).
//
// The TPU kernel carries dW1 and dW2 (2 x 2.36 MB fp32 at the probe's
// D = 384, F = 1536) across its sequential grid in VMEM; no block here can
// hold them, and blocks run in no order. So #14 is the launch sequence of
// the shipped #4 (ln_mlp_bwd.cu, mlp_bwd.cuh's ln_mlp_backward) with the
// probe's two differences, on one stream:
//
//   1. ln_rows:      ln = bf16(LN(x) * gamma + beta)                  [M, D]
//   2-5. mlp_bwd.cuh's products on wgmma_gemm.cuh: the dual tile
//        DualMlp<true> (z = ln @ W1 + b1 and dy @ W2^T in one K loop,
//        h = bf16(gelu(z)) and gelu'(z) from one accurate erf in registers,
//        dh and the fp32 column sums of dh32 per 128-row tile), dW2 = h^T @
//        dy and dW1 = ln^T @ dh (split-K fp32 partials, reduced in a fixed
//        order into fp32 here, bf16 for #4), dln = dh @ W1^T fp32 [M, D]
//   6. ln_bwd_rows:  dx = bf16(dy + LN_bwd(dln * gamma)), partial sums of
//                    dln * x_hat, dln, dy per 256 rows
//   7. reduce_rows:  the partials in a fixed order -> dgamma, dbeta, db2
//
// No float atomics: reruns agree bit for bit. gelu'(z) never leaves the
// dual tile's registers.
//
// The instances (tm, fs) are the dual tile's rows and columns of [M, F]: tm
// = 128 (two consumer warpgroups of 64 rows, the wgmma tile), fs = 64 (two
// blocks an SM) or 128 (one; half the re-reads of ln and dy). The Pallas
// probe's tm rows a grid step map to tm, its fsplit slices of F / parts
// columns to fs (F / fs = 24 or 12 slices at F = 1536, each a block of its
// own rather than a step of one core's loop), and rowpipe's row sub-tiles
// to the two warpgroups, which the card interleaves by itself.
//
// What bounds it on this card: 10 * M * D * F operations in five products
// (148 GFLOP at the probe's shape, 0.150 ms at 989 TFLOP/s) against
// 6 * M * D bytes of x, dy and dx plus the weights: the tensor cores. This
// sequence also moves ln, h, dh and dln through device memory (about
// 2 * M * (D + 2 F) + 8 * M * D bytes between the launches, 0.25 GB at the
// probe), and the dual tile's epilogue evaluates two accurate expf and a
// division per element of [M, F].
#include "mlp_bwd.cuh"

namespace {

// the (tm, fs) instances: (kBM, 64) and (kBM, 128)
bool mlp_tile_bwd_instance(int tm, int fs) {
  return tm == vlp::wg::kBM && (fs == 64 || fs == 128);
}

}  // namespace

extern "C" size_t vlp_mlp_tile_bwd_workspace(int M, int D, int F, int tm) {
  if (M <= 0 || tm != vlp::wg::kBM) return 0;
  return vlp::MlpBwdWs(nullptr, M, D, F).bytes;
}

// x, dy, dx [M, D] bf16; w1 [D, F], w2 [F, D] bf16 ([in, out]); gamma, beta
// [D] and b1 [F] fp32. Outputs, all fp32: dgamma, dbeta, db2 [D], db1 [F],
// dw1 [D, F], dw2 [F, D]. ws: vlp_mlp_tile_bwd_workspace(M, D, F, tm)
// bytes. tm, fs: (128, 64) or (128, 128). Returns the first failing
// cudaError_t.
extern "C" int vlp_mlp_tile_bwd(const void* x, const void* gamma,
                                const void* beta, const void* w1,
                                const void* b1, const void* w2,
                                const void* dy, void* dx, void* dgamma,
                                void* dbeta, void* dw1, void* db1, void* dw2,
                                void* db2, void* ws, int M, int D, int F,
                                int tm, int fs, float eps, void* stream) {
  using vlp::bf16;
  if (!mlp_tile_bwd_instance(tm, fs)) return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* g = static_cast<const float*>(gamma);
  const auto* bt = static_cast<const float*>(beta);
  const auto* w1b = static_cast<const bf16*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* w2b = static_cast<const bf16*>(w2);
  const auto* dyb = static_cast<const bf16*>(dy);
  auto* dxb = static_cast<bf16*>(dx);
  auto* dg = static_cast<float*>(dgamma);
  auto* db = static_cast<float*>(dbeta);
  auto* dw1f = static_cast<float*>(dw1);
  auto* db1f = static_cast<float*>(db1);
  auto* dw2f = static_cast<float*>(dw2);
  auto* db2f = static_cast<float*>(db2);
  const auto st = static_cast<cudaStream_t>(stream);
  if (fs == 64)
    return (int)vlp::ln_mlp_backward<true, 64>(
        xb, g, bt, w1b, b1f, w2b, dyb, dxb, dg, db, dw1f, db1f, dw2f, db2f,
        ws, M, D, F, eps, st);
  return (int)vlp::ln_mlp_backward<true, 128>(
      xb, g, bt, w1b, b1f, w2b, dyb, dxb, dg, db, dw1f, db1f, dw2f, db2f, ws,
      M, D, F, eps, st);
}
