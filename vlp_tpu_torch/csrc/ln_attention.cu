// ln_attention: y = x + OutProj(MHSA(LN(x))) over x [N, S, D], bf16.
//
// Replaces the Pallas TPU kernel vlp_tpu/ops/fused_block.py:_lnattn_fwd
// (body _lnattn_fwd_kernel), the forward of the public ln_attention.
//
// The TPU kernel keeps one sample's LN, packed qkv [S, 3D] and all heads'
// scores in VMEM. On an H100 one block has 227 KB of shared memory, and one
// NesT level-2 sample's qkv alone is 196 x 1152 bf16 = 451 KB, so the half
// block runs as three launches of hand-written kernels on one stream:
//
//   1. gemm_kernel<LN, bias>:     qkv = bf16(LN(x) @ Wqkv + bqkv)  [N*S, 3D]
//   2. mhsa_kernel:               o   = bf16((bf16(p) @ v) / l)    [N*S, D]
//                                 with s = (q @ k^T) * Dh^-0.5 in fp32,
//                                 p = exp(s - rowmax(s)), l = sum(p)
//   3. gemm_kernel<residual>:     y   = bf16(x + o @ Wout + bout)
//
// qkv and o go through device memory; LN(x) and the scores do not. The
// rounding points are those of the Pallas body (fused_block.py:313-323).
//
// What bounds it on this card: at NesT-Small's shapes (S = 196, Dh = 32)
// the attention core does 4*S^2*Dh FLOPs per (sample, head) on 8*S*Dh bytes
// of q, k, v and o, S/2 = 98 FLOP/byte, below the bf16 ridge (~295), and the
// projections stream qkv (3x the activation) through device memory, so the
// half block is bound by memory traffic first. The simple form below is
// latency-bound: one block per (sample, head) stages q, k and v in shared
// memory, and each of its 4 warps takes 16-query tiles, computes the 16 x S
// score rows with wmma, does the softmax from shared memory and multiplies
// P by V with wmma. P overwrites the fp32 scores in place, so a block needs
// about 102 KB and two blocks fit on an SM. Fusing the three launches back
// into one persistent kernel (with the projections) is later work.
#include "gemm.cuh"

namespace vlp {

constexpr int kHeadDim = 32;
constexpr int kAttnWarps = 4;
constexpr int kQkvLd = kHeadDim + 8;  // bf16 pitch of the staged q, k, v rows
constexpr int kMaxSeq = 256;          // keys held per lane: kMaxSeq / 32
constexpr int kKeysPerLane = kMaxSeq / 32;

inline size_t mhsa_smem_bytes(int S) {
  const int sp = (S + 15) / 16 * 16;
  return 3 * (size_t)sp * kQkvLd * sizeof(bf16) +
         (size_t)kAttnWarps * 16 * (sp + 4) * sizeof(float) +
         (size_t)kAttnWarps * 16 * sizeof(float);
}

// grid (H, N); block kAttnWarps * 32 threads.
__global__ void __launch_bounds__(kAttnWarps * 32)
    mhsa_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o, int S,
                int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int h = blockIdx.x;
  const int n = blockIdx.y;
  const int tiles = (S + 15) / 16;
  const int sp = tiles * 16;
  const int lds = sp + 4;       // fp32 pitch of a score row
  const int ldp = 2 * lds;      // bf16 pitch of P: row r of P starts where
                                // row r of the scores starts
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + sp * kQkvLd;
  bf16* Vs = Ks + sp * kQkvLd;
  float* Ss = reinterpret_cast<float*>(Vs + sp * kQkvLd);
  float* Ls = Ss + kAttnWarps * 16 * lds;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)n * S * row_stride + h * kHeadDim;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // stage q, k, v of this (sample, head); rows S..sp-1 are zero
  constexpr int vecs = kHeadDim / 8;
  for (int i = tid; i < 3 * sp * vecs; i += kAttnWarps * 32) {
    const int mat = i / (sp * vecs);
    const int rem = i % (sp * vecs);
    const int r = rem / vecs;
    const int c = (rem % vecs) * 8;
    uint4 v = zero;
    if (r < S)
      v = *reinterpret_cast<const uint4*>(base + (size_t)r * row_stride +
                                          mat * D + c);
    *reinterpret_cast<uint4*>(Qs + (size_t)mat * sp * kQkvLd + r * kQkvLd +
                              c) = v;
  }
  __syncthreads();

  float* S_w = Ss + warp * 16 * lds;
  bf16* P_w = reinterpret_cast<bf16*>(S_w);
  float* L_w = Ls + warp * 16;
  const float neg_inf = __int_as_float(0xff800000);

  for (int qt = warp; qt < tiles; qt += kAttnWarps) {
    // scores: S_w[16, sp] = Q[qt] @ K^T, fp32
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wmma::load_matrix_sync(qa[kk], Qs + qt * 16 * kQkvLd + kk * 16, kQkvLd);
    for (int kt = 0; kt < tiles; ++kt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        // col_major B: element (k, j) = K[kt*16 + j][kk*16 + k] = (K^T)[k][j]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + kt * 16 * kQkvLd + kk * 16, kQkvLd);
        wmma::mma_sync(sc, qa[kk], kb, sc);
      }
      wmma::store_matrix_sync(S_w + kt * 16, sc, lds, wmma::mem_row_major);
    }
    __syncwarp();

    // softmax rows; p = exp(s - max) kept unnormalised, l = sum(p) in fp32
    for (int r = 0; r < 16; ++r) {
      const float* srow = S_w + r * lds;
      float v[kKeysPerLane];
      float m = neg_inf;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int j = lane + 32 * i;
        v[i] = j < S ? srow[j] * scale : neg_inf;
        m = fmaxf(m, v[i]);
      }
      m = warp_max(m);
      float l = 0.f;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int j = lane + 32 * i;
        v[i] = j < S ? expf(v[i] - m) : 0.f;
        l += v[i];
      }
      l = warp_sum(l);
      __syncwarp();  // every lane has read score row r before P overwrites it
      bf16* prow = P_w + r * ldp;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int j = lane + 32 * i;
        if (j < sp) prow[j] = __float2bfloat16(v[i]);
      }
      if (lane == 0) L_w[r] = l;
    }
    __syncwarp();

    // o[16, Dh] = P @ V
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc[2];
    wmma::fill_fragment(oc[0], 0.f);
    wmma::fill_fragment(oc[1], 0.f);
    for (int kt = 0; kt < tiles; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, P_w + kt * 16, ldp);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + kt * 16 * kQkvLd + j * 16, kQkvLd);
        wmma::mma_sync(oc[j], pa, vb, oc[j]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(S_w + j * 16, oc[j], lds, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * kHeadDim; i += 32) {
      const int r = i / kHeadDim;
      const int c = i % kHeadDim;
      const int row = qt * 16 + r;
      if (row < S)
        o[((size_t)n * S + row) * D + h * kHeadDim + c] =
            __float2bfloat16(S_w[r * lds + c] / L_w[r]);
    }
    __syncwarp();  // the next tile's scores overwrite S_w
  }
}

cudaError_t launch_mhsa(const bf16* qkv, bf16* o, int N, int S, int D, int H,
                        float scale, cudaStream_t stream) {
  if (N <= 0 || S <= 0 || S > kMaxSeq || D != H * kHeadDim || N > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = mhsa_smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      mhsa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mhsa_kernel<<<dim3(H, N), kAttnWarps * 32, smem, stream>>>(qkv, o, S, D,
                                                             scale);
  return cudaGetLastError();
}

}  // namespace vlp

// x, y [N, S, D]; wqkv [D, 3D]; wout [D, D] (bf16, row-major, [in, out]);
// gamma, beta, bout [D], bqkv [3D] (fp32). qkv [N, S, 3D] and o [N, S, D]
// are scratch the caller allocates. Returns the first failing cudaError_t.
extern "C" int vlp_ln_attention(const void* x, const void* gamma,
                                const void* beta, const void* wqkv,
                                const void* bqkv, const void* wout,
                                const void* bout, void* qkv, void* o, void* y,
                                int N, int S, int D, int H, float scale,
                                float eps, void* stream) {
  using vlp::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = N * S;
  cudaError_t err = vlp::launch_gemm<true, vlp::kEpiBias>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), nullptr, static_cast<bf16*>(qkv), M,
      3 * D, D, eps, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_mhsa(static_cast<const bf16*>(qkv), static_cast<bf16*>(o),
                         N, S, D, H, scale, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_gemm<false, vlp::kEpiBiasResidual>(
      static_cast<const bf16*>(o), nullptr, nullptr,
      static_cast<const bf16*>(wout), static_cast<const float*>(bout),
      static_cast<const bf16*>(x), static_cast<bf16*>(y), M, D, D, 0.f, st);
  return (int)err;
}

extern "C" const char* vlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
