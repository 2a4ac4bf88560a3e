// The exact-erf GELU of the Pallas bodies, gelu(z) = z * Phi(z) with Phi by
// the Abramowitz & Stegun erf (7.1.26, |error| <= 1.5e-7) of
// vlp_tpu/ops/fused_mlp.py:_erf, in the two forms the kernels evaluate:
//
//   gelu_cdf_pdf: Phi(z) and phi(z) from one hardware exp and the hardware
//                 reciprocal; the epilogues of the shipped MLP kernels, the
//                 forwards' h = bf16(z * Phi) (mlp_fwd.cuh, #2 and #9) and
//                 the backwards' recompute of h and gelu'(z) (mlp_bwd.cuh,
//                 #4 and #10), so both sides form h from one function
//   erf_as, gelu_erf: the accurate form (expf and a division), which the
//                 probes' tile engine (mlp_tile.cuh, #13, #14, #19a) runs
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

__device__ __forceinline__ float gelu_erf(float z) {
  return 0.5f * z * (1.0f + erf_as(z * 0.7071067811865476f));
}

}  // namespace vlp
