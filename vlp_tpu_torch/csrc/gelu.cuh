// The exact-erf GELU of the Pallas bodies, gelu(z) = z * Phi(z) with Phi by
// the Abramowitz & Stegun erf (7.1.26, |error| <= 1.5e-7) of
// vlp_tpu/ops/fused_mlp.py:_erf, in the two forms the kernels evaluate:
//
//   gelu_cdf_pdf: Phi(z) and phi(z) from one hardware exp and the hardware
//                 reciprocal; the epilogues of the shipped MLP kernels, the
//                 forwards' h = bf16(z * Phi) (mlp_fwd.cuh, #2 and #9) and
//                 the backwards' recompute of h and gelu'(z) (mlp_bwd.cuh,
//                 #4 and #10), so both sides form h from one function
//   erf_abs_nr:   the accurate form: one expf, and the hardware reciprocal
//                 refined by one Newton step (within an fp32 ulp of a
//                 division); gelu_erf_h, h = gelu(z) from it, the fc1
//                 epilogue of the probes #13 and #19a (mlp_tile.cu on
//                 mlp_fwd.cuh's sequence), and gelu_erf_grad, h and
//                 gelu'(z) from one such erf and exp, the epilogue of the
//                 probe #14's dual tile (mlp_bwd.cuh)
//   erf_as:       the accurate form with a division, the yardstick of
//                 scripts/gelu_epilogue_gap.py
//
// The hardware exp and reciprocal err by a few fp32 ulps, far below the
// bf16 rounding of h and dh (scripts/gelu_epilogue_gap.py measures the gap
// on the card), and cost about half of what two accurate expf and a
// division do per element.
#pragma once

#include <cuda_runtime.h>

namespace vlp {

// cdf = Phi(z) and phi = the normal density, from one exp: the erf's
// exp(-(z / sqrt 2)^2) is phi's exp(-z^2 / 2).
__device__ __forceinline__ void gelu_cdf_pdf(float z, float& cdf,
                                             float& phi) {
  const float e = __expf(-0.5f * z * z);
  const float t =
      __fdividef(1.0f, 1.0f + 0.3275911f * (fabsf(z) * 0.7071067811865476f));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  cdf = 0.5f + copysignf(0.5f - 0.5f * poly * e, z);
  phi = e * 0.3989422804014327f;
}

// erf by A&S 7.1.26 with expf and a division, as fused_mlp.py:_erf
__device__ __forceinline__ float erf_as(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return s * (1.0f - poly * expf(-a * a));
}

// |erf(x)| = 1 - poly(t) * e for a = |x| by erf_as's A&S 7.1.26 with one
// accurate expf, e = exp(-a^2), and t = 1 / (1 + p a) by the hardware's
// reciprocal refined by one Newton step (within an fp32 ulp of the
// division: with the division's slow-path call the dual tile's epilogue
// spilled 8 bytes at 64 columns; without it ptxas gives 96 registers at 64
// columns and 168 at 128, no spill)
__device__ __forceinline__ float erf_abs_nr(float a, float& e) {
  const float y = 1.0f + 0.3275911f * a;
  const float r = __fdividef(1.0f, y);
  const float t = fmaf(r, fmaf(-y, r, 1.0f), r);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  e = expf(-a * a);
  return 1.0f - poly * e;
}

// h = gelu(z) = 0.5 z (1 + erf(z / sqrt 2)), the accurate form alone
// (vlp_tpu/ops/fused_mlp.py:_gelu, benchmarks/mega_variants.py:83's h).
// erf's sign is a select, not gelu_erf_grad's product: the two differ only
// in the sign of a zero erf, which 1 + erf does not see, and with the
// product ptxas spilled 4 bytes in DenseEpi<true, true> at 128 columns.
__device__ __forceinline__ float gelu_erf_h(float z) {
  const float x = z * 0.7071067811865476f;
  float e;
  const float v = erf_abs_nr(fabsf(x), e);
  return 0.5f * z * (1.0f + (x > 0.f ? v : (x < 0.f ? -v : 0.f)));
}

// h = gelu(z) and gelu'(z) = Phi(z) + z * phi(z) in the association of
// vlp_tpu/ops/fused_mlp.py:_gelu_grad, formed apart as
// benchmarks/mega_variants.py:185-210 forms them, from one erf_abs_nr: its
// exp(-z^2 / 2) is phi's as well
__device__ __forceinline__ void gelu_erf_grad(float z, float& h, float& d) {
  const float x = z * 0.7071067811865476f;
  float e;
  const float v = erf_abs_nr(fabsf(x), e);
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float erf = s * v;
  h = 0.5f * z * (1.0f + erf);
  d = 0.5f * (1.0f + erf) + z * (e * 0.3989422804014327f);
}

}  // namespace vlp
