// The helpers that the kernels' headers share: the bf16 type and a warp's
// sum (bwd_rows.cuh's LayerNorm rows, mhsa_reg.cuh's cores).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vlp {

using bf16 = __nv_bfloat16;

// The sum over the 32 lanes of a warp, every lane getting the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace vlp
