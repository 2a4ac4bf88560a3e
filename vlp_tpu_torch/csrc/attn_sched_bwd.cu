// Backward of attn_sched, from x and dy alone, in the schedule lab's modes.
//
// Replaces the Pallas TPU probe kernel
// benchmarks/mega_variants.py:make_attn_bwd (body attn_bwd_kernel,
// :410-586): one sample per grid step recomputes LN, qkv and the softmax and
// returns all seven cotangents, the weight gradients in fp32 (:603-609).
// Modes: v0 (two passes over the heads, each with its own softmax
// recompute), stage2 (the same, each pass grouped by stage), uni (the
// softmax computed once). On an H100 every mode runs #3's sequence as it
// stood before #3's core moved to mhsa_reg_bwd.cuh (its own cores below;
// #3's tail) plus the recompute that the probe's signature forces, on one
// stream:
//
//   1. ln_rows:             ln  = bf16(LN(x) * gamma + beta)
//   2. gemm <LN, bias>:     qkv = bf16(LN(x) @ Wqkv + bqkv) (the forward's)
//   3. gemm NT:             do  = bf16(dy @ Wout^T)
//   4. the core, per mode:  o = bf16((bf16(p) @ v) * (1/l)), dqkv, and
//                           per-sample fp32 column sums of dqkv
//        v0      pass 1 mhsa_sched_kernel<v0, recip>, pass 2 mhsa_bwd.cuh
//        stage2  pass 1 mhsa_sched_kernel<stage, recip>, pass 2 mhsa_bwd.cuh
//                in its tile order: a stage-grouped pass 2 would hold the
//                fp32 scores and dp of all 13 query tiles at S = 196, two
//                buffers of 176 KB, more than a block has; so on this card
//                stage2 differs from v0 in pass 1 only
//        uni     mhsa_uni_bwd_kernel: the scores once per (sample, head)
//   5-8. ln_attention.cuh's attn_bwd_tail, shared with #3: dWout = o^T dy,
//        dWqkv = ln^T dqkv (wgmma_gemm.cuh, split-K, reduced in a fixed
//        order into fp32), dln, the LN backward, the vector gradients
//
// The Pallas body's dov = bf16(do * (1/l)) rounds the fp32 do; the kernels
// stage do in bf16 (step 3, as #3 does), one bf16 rounding of do apart.
// Every sum runs in a fixed order (no atomics), so reruns are bit-identical.
//
// mhsa_uni_bwd_kernel, grid min(N * H, the blocks resident on the card),
// each block walking (sample, head) units: it stages q, k, v and do
// (rows padded to sp with zeros). Phase A, per 16-query tile of a warp: the
// fp32 scores and dp = do v^T with wmma, then per row p = exp(s - max),
// 1/l, c = sum(p * dp) / l, ds = (p * dp - p * c) / l; bf16(p) and bf16(ds)
// go over the score and dp rows and to the block's scratch in device
// memory, dov = bf16(do / l) to shared memory; then o = bf16((bf16(p) @ v) *
// (1/l)) and dq = bf16(ds) @ k * scale. Phase B, per 16-key tile: dv +=
// bf16(p)^T dov and dk += bf16(ds)^T q, the p and ds tiles read back from
// the scratch as col_major fragments: no score is recomputed. (bf16 p and ds
// of a unit, 2 * sp^2 bf16 = 173 KB at S = 196, do not fit beside the staged
// rows: 83 KB of q, k, v, do and dov, 106 KB of score and dp rows.) The
// scratch is sized to the resident blocks, one slot each (about 23 MB on
// 132 SMs), so it stays in the 50 MB L2 rather than 266 MB for every unit
// at batch 128. The rounding points are those of mega_variants.py:456-497.
//
// What bounds it on this card: 104 GFLOP at the probe's batch 128 (uni's
// products; the two-pass modes recompute QK and PV once more), 0.105 ms at
// the bf16 peak, against 61 MB that must move: operations in the ideal;
// these forms are bound by the wmma cores' and the unpipelined wmma GEMMs'
// (steps 2 and 3) latency.
#include "attn_sched.cuh"
#include "ln_attention.cuh"
#include "mhsa_bwd.cuh"

namespace vlp {

enum BwdMode { kBwdV0 = 0, kBwdStage2 = 1, kBwdUni = 2 };

constexpr int kUniWarps = 4;

template <int HD>
inline size_t uni_smem_bytes(int S) {
  const int sp = (S + 15) / 16 * 16;
  return 5 * (size_t)sp * (HD + 8) * sizeof(bf16) +
         (size_t)kUniWarps * 2 * 16 * mhsa_bwd_lds<HD>(S) * sizeof(float) +
         (size_t)sp * sizeof(float) +
         3 * (size_t)kUniWarps * HD * sizeof(float);
}

// bf16 elements of one block's scratch: its unit's p and ds, [sp, sp] each.
__host__ __device__ inline size_t uni_slot_elems(int S) {
  const size_t sp = (S + 15) / 16 * 16;
  return 2 * sp * sp;
}

// grid (units); block kUniWarps * 32 threads. qkv [N*S, 3D], dout (do)
// [N*S, D] -> o [N*S, D], dqkv [N*S, 3D] bf16; bpart [N, 3D] fp32 column
// sums of this sample's fp32 dq, dk, dv, unless null; scratch: gridDim.x
// slots of uni_slot_elems(S).
template <int HD>
__global__ void __launch_bounds__(kUniWarps * 32)
    mhsa_uni_bwd_kernel(const bf16* __restrict__ qkv,
                        const bf16* __restrict__ dout, bf16* __restrict__ o,
                        bf16* __restrict__ dqkv, float* __restrict__ bpart,
                        bf16* __restrict__ scratch, int N, int H, int S,
                        int D, float scale) {
  constexpr int warps = kUniWarps;
  constexpr int ld = HD + 8;   // bf16 pitch of a staged row
  constexpr int kf = HD / 16;  // wmma fragments across the head dim
  constexpr int cl = HD / 32;  // head-dim columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles = (S + 15) / 16;
  const int sp = tiles * 16;
  const int lds = mhsa_bwd_lds<HD>(S);
  const int ldp = 2 * lds;  // bf16 pitch of p and ds over the fp32 rows
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + sp * ld;
  bf16* Vs = Ks + sp * ld;
  bf16* Ds = Vs + sp * ld;     // do
  bf16* DOVs = Ds + sp * ld;   // bf16(do / l)
  float* Wbuf = reinterpret_cast<float*>(DOVs + sp * ld);
  float* Il = Wbuf + warps * 2 * 16 * lds;  // 1 / l
  float* Col = Il + sp;                     // [3][warps][HD]
  bf16* PB = scratch + (size_t)blockIdx.x * uni_slot_elems(S);  // [sp, sp]
  bf16* DSB = PB + (size_t)sp * sp;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row3 = 3 * (size_t)D;
  const bf16 bzero = __float2bfloat16(0.f);
  float* S_w = Wbuf + warp * 2 * 16 * lds;
  float* DP_w = S_w + 16 * lds;
  bf16* P_w = reinterpret_cast<bf16*>(S_w);
  bf16* DS_w = reinterpret_cast<bf16*>(DP_w);

  for (int unit = blockIdx.x; unit < N * H; unit += gridDim.x) {
    const int h = unit % H;
    const int n = unit / H;
    const UnitRows<IdentityRows> row_of =
        unit_rows(IdentityRows{S}, n, S, nullptr, tid, warps * 32);
    mhsa_bwd_stage<HD>(qkv, dout, Qs, S, sp, D, h, row_of, tid, warps * 32);
    __syncthreads();

    // ---- phase A: query tiles -> p, ds (kept), dov, o, dq ----
    float col_q[cl];
#pragma unroll
    for (int j = 0; j < cl; ++j) col_q[j] = 0.f;
    for (int qt = warp; qt < tiles; qt += warps) {
      mhsa_bwd_scores<HD>(Qs, Ks, Vs, Ds, qt, tiles, S_w, DP_w, lds);
      for (int r = 0; r < 16; ++r) {
        const int row = qt * 16 + r;
        const BwdRow b = mhsa_bwd_row(S_w + r * lds, DP_w + r * lds, S,
                                      scale, lane);
        __syncwarp();  // every lane has read row r before p, ds overwrite it
        bf16* prow = P_w + r * ldp;
        bf16* dsrow = DS_w + r * ldp;
        bf16* pg = PB + (size_t)row * sp;
        bf16* dsg = DSB + (size_t)row * sp;
#pragma unroll
        for (int i = 0; i < kBwdKeysPerLane; ++i) {
          const int j = lane + 32 * i;
          if (j < sp) {
            const bf16 pb = __float2bfloat16(b.p[i]);
            const bf16 ds =
                __float2bfloat16((b.t[i] - b.p[i] * b.c) * b.invl);
            prow[j] = pb;
            dsrow[j] = ds;
            // padded query rows add nothing to dk and dv
            pg[j] = row < S ? pb : bzero;
            dsg[j] = row < S ? ds : bzero;
          }
        }
#pragma unroll
        for (int j = 0; j < cl; ++j) {
          const int col = lane + 32 * j;
          DOVs[row * ld + col] = __float2bfloat16(
              __bfloat162float(Ds[row * ld + col]) * b.invl);
        }
        if (lane == 0) Il[row] = b.invl;
      }
      __syncwarp();

      // o[16, HD] = bf16(p) @ v, dq[16, HD] = bf16(ds) @ k
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc[kf], qc[kf];
#pragma unroll
      for (int j = 0; j < kf; ++j) {
        wmma::fill_fragment(oc[j], 0.f);
        wmma::fill_fragment(qc[j], 0.f);
      }
      for (int kt = 0; kt < tiles; ++kt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa,
            dsa;
        wmma::load_matrix_sync(pa, P_w + kt * 16, ldp);
        wmma::load_matrix_sync(dsa, DS_w + kt * 16, ldp);
#pragma unroll
        for (int j = 0; j < kf; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb,
              kb;
          wmma::load_matrix_sync(vb, Vs + kt * 16 * ld + j * 16, ld);
          wmma::load_matrix_sync(kb, Ks + kt * 16 * ld + j * 16, ld);
          wmma::mma_sync(oc[j], pa, vb, oc[j]);
          wmma::mma_sync(qc[j], dsa, kb, qc[j]);
        }
      }
      __syncwarp();  // every lane has read p and ds before the staging
#pragma unroll
      for (int j = 0; j < kf; ++j) {
        wmma::store_matrix_sync(S_w + j * 16, oc[j], lds, wmma::mem_row_major);
        wmma::store_matrix_sync(DP_w + j * 16, qc[j], lds,
                                wmma::mem_row_major);
      }
      __syncwarp();
      for (int r = 0; r < 16; ++r) {
        const int row = qt * 16 + r;
        if (row < S) {
          const size_t g = row_of(row);
#pragma unroll
          for (int j = 0; j < cl; ++j) {
            const int col = lane + 32 * j;
            o[g * D + h * HD + col] =
                __float2bfloat16(S_w[r * lds + col] * Il[row]);
            const float v = DP_w[r * lds + col] * scale;
            dqkv[g * row3 + h * HD + col] = __float2bfloat16(v);
            col_q[j] += v;
          }
        }
      }
      __syncwarp();  // the next tile's scores overwrite S_w and DP_w
    }
#pragma unroll
    for (int j = 0; j < cl; ++j)
      Col[(0 * warps + warp) * HD + lane + 32 * j] = col_q[j];
    __syncthreads();  // p, ds and dov of every row are in place

    // ---- phase B: key tiles -> dk, dv from the kept p and ds ----
    float col_k[cl], col_v[cl];
#pragma unroll
    for (int j = 0; j < cl; ++j) col_k[j] = col_v[j] = 0.f;
    for (int kt = warp; kt < tiles; kt += warps) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> dva[kf], dka[kf];
#pragma unroll
      for (int j = 0; j < kf; ++j) {
        wmma::fill_fragment(dva[j], 0.f);
        wmma::fill_fragment(dka[j], 0.f);
      }
      for (int qt = 0; qt < tiles; ++qt) {
        // col_major A = P^T: element (key j, query i) at PB[i * sp + j]
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> pa,
            dsa;
        const size_t at = (size_t)qt * 16 * sp + kt * 16;
        wmma::load_matrix_sync(pa, PB + at, sp);
        wmma::load_matrix_sync(dsa, DSB + at, sp);
#pragma unroll
        for (int j = 0; j < kf; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> ob,
              qb;
          wmma::load_matrix_sync(ob, DOVs + qt * 16 * ld + j * 16, ld);
          wmma::load_matrix_sync(qb, Qs + qt * 16 * ld + j * 16, ld);
          wmma::mma_sync(dva[j], pa, ob, dva[j]);
          wmma::mma_sync(dka[j], dsa, qb, dka[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kf; ++j) {
        wmma::store_matrix_sync(S_w + j * 16, dva[j], lds,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(DP_w + j * 16, dka[j], lds,
                                wmma::mem_row_major);
      }
      __syncwarp();
      mhsa_bwd_store_kv<HD>(S_w, DP_w, lds, kt, S, dqkv, D, h, scale, row_of,
                            lane, col_k, col_v);
    }
#pragma unroll
    for (int j = 0; j < cl; ++j) {
      Col[(1 * warps + warp) * HD + lane + 32 * j] = col_k[j];
      Col[(2 * warps + warp) * HD + lane + 32 * j] = col_v[j];
    }
    __syncthreads();
    if (bpart != nullptr)
      mhsa_bwd_bias_parts<HD>(Col, bpart, n, D, h, warps, tid);
    __syncthreads();  // the next unit restages and rewrites the scratch
  }
}

// Blocks of the uni kernel: every unit, or as many as are resident on the
// card at once (one scratch slot each), whichever is fewer; 0 on error.
template <int HD>
inline int uni_grid(int units, int S) {
  const size_t smem = uni_smem_bytes<HD>(S);
  int dev = 0, sms = 0, per_sm = 0;
  if (smem > kMaxBlockSmem || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(mhsa_uni_bwd_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mhsa_uni_bwd_kernel<HD>, kUniWarps * 32, smem) !=
          cudaSuccess)
    return 0;
  const int resident = sms * (per_sm > 0 ? per_sm : 1);
  return units < resident ? units : resident;
}

inline size_t uni_scratch_bytes(int N, int S, int H) {
  return (size_t)uni_grid<32>(N * H, S) * uni_slot_elems(S) * sizeof(bf16);
}

// The attention core of the backward in `mode` (BwdMode): o and dqkv (and
// bpart unless null) from qkv and do; scratch: uni_scratch_bytes for uni.
inline cudaError_t attn_sched_bwd_core(const bf16* qkv, const bf16* dout,
                                       bf16* o, bf16* dqkv, float* bpart,
                                       bf16* scratch, int N, int S, int D,
                                       int H, float scale, int mode,
                                       cudaStream_t st) {
  if (N <= 0 || S <= 0 || D != H * 32 || N > 65535)
    return cudaErrorInvalidValue;
  if (mode == kBwdUni) {
    const int grid = uni_grid<32>(N * H, S);  // sets the smem attribute
    if (grid <= 0 || S > 256) return cudaErrorInvalidValue;
    mhsa_uni_bwd_kernel<32><<<grid, kUniWarps * 32, uni_smem_bytes<32>(S),
                              st>>>(qkv, dout, o, dqkv, bpart, scratch, N, H,
                                    S, D, scale);
    return cudaGetLastError();
  }
  if (mode != kBwdV0 && mode != kBwdStage2) return cudaErrorInvalidValue;
  cudaError_t err = launch_mhsa_sched(
      qkv, o, N, S, D, H, scale, mode == kBwdV0 ? kSchedV0 : kSchedStage,
      true, st);
  if (err != cudaSuccess) return err;
  return launch_mhsa_bwd<32>(qkv, dout, dqkv, bpart, N, S, D, H, scale,
                             IdentityRows{S}, st);
}

// #3's workspace, then qkv, o and uni's scratch.
struct SchedBwdWs {
  AttnBwdWs base;
  bf16* qkv;
  bf16* o;
  bf16* scratch;
  size_t bytes;

  SchedBwdWs(void* p, int N, int S, int D, int H, int mode)
      : base(p, N, S, D) {
    const size_t M = (size_t)N * S;
    Carver c{p ? static_cast<char*>(p) + base.bytes : nullptr};
    qkv = c.take<bf16>(M * 3 * D);
    o = c.take<bf16>(M * D);
    scratch = reinterpret_cast<bf16*>(
        c.take<char>(mode == kBwdUni ? uni_scratch_bytes(N, S, H) : 0));
    bytes = base.bytes + c.used;
  }
};

}  // namespace vlp

extern "C" size_t vlp_attn_sched_bwd_workspace(int N, int S, int D, int H,
                                               int mode) {
  return vlp::SchedBwdWs(nullptr, N, S, D, H, mode).bytes;
}

// x, dy, dx [N, S, D] bf16; wqkv [D, 3D], wout [D, D] bf16 ([in, out]);
// gamma, beta [D], bqkv [3D] fp32. Outputs: dgamma, dbeta, dbout [D] and
// dbqkv [3D] fp32; dwqkv [D, 3D] and dwout [D, D] fp32. ws:
// vlp_attn_sched_bwd_workspace bytes. mode: 0 v0, 1 stage2, 2 uni. Returns
// the first failing cudaError_t.
extern "C" int vlp_attn_sched_bwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* bqkv, const void* wout, const void* dy, void* dx,
    void* dgamma, void* dbeta, void* dwqkv, void* dbqkv, void* dwout,
    void* dbout, void* ws, int N, int S, int D, int H, float scale,
    float eps, int mode, void* stream) {
  using vlp::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const vlp::SchedBwdWs w(ws, N, S, D, H, mode);
  const bf16* xb = static_cast<const bf16*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const int M = N * S;
  cudaError_t err = vlp::launch_ln_rows(xb, g, b, w.base.ln, M, D, eps, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::launch_gemm<true, vlp::kEpiBias>(
      xb, g, b, static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bqkv), nullptr, w.qkv, M, 3 * D, D, eps, st);
  if (err != cudaSuccess) return (int)err;
  // do = dy @ Wout^T
  err = vlp::launch_gemm_ex<false, false, true, vlp::kEpiBf16>(
      dyb, nullptr, nullptr, static_cast<const bf16*>(wout), nullptr,
      nullptr, w.base.dout, M, D, D, 1, 0.f, st);
  if (err != cudaSuccess) return (int)err;
  err = vlp::attn_sched_bwd_core(w.qkv, w.base.dout, w.o, w.base.dqkv,
                                 w.base.bpart, w.scratch, N, S, D, H, scale,
                                 mode, st);
  if (err != cudaSuccess) return (int)err;
  return (int)vlp::attn_bwd_tail(
      xb, g, static_cast<const bf16*>(wqkv), w.o, dyb, w.base,
      static_cast<bf16*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<float*>(dwqkv),
      static_cast<float*>(dbqkv), static_cast<float*>(dwout),
      static_cast<float*>(dbout), N, S, D, eps, st);
}

extern "C" size_t vlp_attn_sched_bwd_core_workspace(int N, int S, int H,
                                                    int mode) {
  return mode == vlp::kBwdUni ? vlp::uni_scratch_bytes(N, S, H) : 0;
}

// The backward's attention core alone: qkv [N, S, 3D] and do [N, S, D]
// bf16 -> o [N, S, D] and dqkv [N, S, 3D] bf16. ws:
// vlp_attn_sched_bwd_core_workspace bytes.
extern "C" int vlp_attn_sched_bwd_core(const void* qkv, const void* dout,
                                       void* o, void* dqkv, void* ws, int N,
                                       int S, int D, int H, float scale,
                                       int mode, void* stream) {
  using vlp::bf16;
  return (int)vlp::attn_sched_bwd_core(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<bf16*>(o), static_cast<bf16*>(dqkv), nullptr,
      static_cast<bf16*>(ws), N, S, D, H, scale, mode,
      static_cast<cudaStream_t>(stream));
}
