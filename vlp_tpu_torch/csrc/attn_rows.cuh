// Row maps of the attention cores (mhsa.cuh, mhsa_bwd.cuh, mhsa_reg.cuh,
// mhsa_reg_bwd.cuh): where token r of attention unit n lies among the rows
// of qkv [M, 3D], o and do [M, D] and dqkv [M, 3D].
//
//   IdentityRows  unit n is sample n of [N, S, *]: row n * S + r (kernels
//                 #1, #3, #7, #8).
//   WindowRows    unit n is a block x block window of a NesT token map
//                 [B, H, W, *], numbered in blockify order (image b, then
//                 the window row bh, then the window column bw); token
//                 r = (i, j) of the window is map row
//                 (b * H + bh * block + i) * W + bw * block + j (kernels
//                 #5, #6).
//
// A core reads and writes one head's 64-byte slice of each row either way,
// so the window gather costs no coarser access than the identity. What it
// does cost is integer division: a window row takes five, and the cores ask
// for a row at every staged 16-byte vector and every output element. So a
// map with kTable set is worked out once per block (unit) into a table of S
// ints in shared memory, which the loops then read (unit_rows below); the
// identity, one multiply-add, is computed at each use as before.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace vlp {

struct IdentityRows {
  static constexpr bool kTable = false;
  int S;
  __device__ __forceinline__ size_t operator()(int n, int r) const {
    return (size_t)n * S + r;
  }
};

struct WindowRows {
  static constexpr bool kTable = true;
  int H, W, block;
  __device__ __forceinline__ size_t operator()(int n, int r) const {
    const int gw = W / block;
    const int per_image = (H / block) * gw;
    const int b = n / per_image;
    const int win = n - b * per_image;
    const int bh = win / gw;
    const int bw = win - bh * gw;
    const int i = r / block;
    const int j = r - i * block;
    return ((size_t)b * H + bh * block + i) * W + bw * block + j;
  }
};

// Shared-memory bytes of a unit's row table (0 without kTable).
template <class Rows>
inline size_t row_table_bytes(int S) {
  return Rows::kTable ? (size_t)S * sizeof(int) : 0;
}

// The rows of one unit as a core reads them.
template <class Rows>
struct UnitRows {
  Rows rows;
  int n;
  const int* table;
  __device__ __forceinline__ size_t operator()(int r) const {
    return Rows::kTable ? (size_t)table[r] : rows(n, r);
  }
};

// Fills unit n's row table (S ints of shared memory, row indices < 2^31)
// when Rows has one, with a barrier after it; every thread of the block
// calls this.
template <class Rows>
__device__ __forceinline__ UnitRows<Rows> unit_rows(Rows rows, int n, int S,
                                                    int* table, int tid,
                                                    int threads) {
  if (Rows::kTable) {
    for (int r = tid; r < S; r += threads) table[r] = (int)rows(n, r);
    __syncthreads();
  }
  return UnitRows<Rows>{rows, n, table};
}

}  // namespace vlp
