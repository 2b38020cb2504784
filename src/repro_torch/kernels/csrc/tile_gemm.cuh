// One 64×64 output tile of a matrix product in T (float or double),
// computed by one block of 256 threads: the tile loop of blocked.cu's
// trsm and trailing update (f32 and f64). panel.cu's products run on
// gemm_nt.cuh instead, and gram.cu on its own upper-tile loop.
//
// The reduction runs kStep = 16 indices at a time. For each step the
// caller's `load(a_tile, b_tile, k0)` stages, for reduction indices
// k0 .. k0 + 15, the tile's 64 rows of the left operand into a_tile[kk][i]
// and its 64 columns of the right operand into b_tile[kk][j], writing zero
// past a ragged edge. Each thread then accumulates a 4×4 register
// micro-tile with plain FMAs in T (no TF32, no mma), and finally hands
// each of its 16 sums to `store(i, j, value)`, with i and j inside the
// tile; the store masks the ragged edges and applies the epilogue. Operand
// layouts differ only in `load`, epilogues only in `store`. The two
// staging buffers take 8.7 KB in f32 and 17.4 KB in f64.
//
// The sums of one output run over k in order, one FMA chain per element.

#pragma once

#include "scalar.cuh"

namespace afl_tile {

constexpr int kTile = 64;      // output tile side
constexpr int kStep = 16;      // reduction indices staged in shared memory per step
constexpr int kMicro = 4;      // each thread owns a kMicro × kMicro sub-tile
constexpr int kPad = 4;        // keeps 4-wide rows 16-byte aligned, halves bank conflicts
constexpr int kThreads = (kTile / kMicro) * (kTile / kMicro);  // 256
constexpr int kLoadsPerThread = (kStep * kTile) / kThreads;      // 4

template <class T>
using Stage = T (*)[kTile + kPad];   // one staged operand: [kStep][kTile + kPad]

// The tile loop on staging buffers the caller provides (16-byte aligned,
// kStep × (kTile + kPad) values each), for a kernel that runs several
// products on one pair of buffers.
template <class T, class Load, class Store>
__device__ __forceinline__ void tile_gemm(int k, Stage<T> a_tile, Stage<T> b_tile,
                                          Load load, Store store) {
  const int tx = threadIdx.x % (kTile / kMicro);   // column group of the sub-tile
  const int ty = threadIdx.x / (kTile / kMicro);   // row group of the sub-tile

  T acc[kMicro][kMicro];
#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int s = 0; s < kMicro; ++s) acc[r][s] = T(0);

  for (int k0 = 0; k0 < k; k0 += kStep) {
    load(a_tile, b_tile, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      T av[kMicro], bv[kMicro];
      afl::load4(&a_tile[kk][ty * kMicro], av);
      afl::load4(&b_tile[kk][tx * kMicro], bv);
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int s = 0; s < kMicro; ++s) acc[r][s] = afl::fma_(av[r], bv[s], acc[r][s]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int s = 0; s < kMicro; ++s) store(ty * kMicro + r, tx * kMicro + s, acc[r][s]);
}

// The tile loop on staging buffers of its own.
template <class T, class Load, class Store>
__device__ __forceinline__ void tile_gemm(int k, Load load, Store store) {
  __shared__ __align__(16) T a_tile[kStep][kTile + kPad];
  __shared__ __align__(16) T b_tile[kStep][kTile + kPad];
  tile_gemm<T>(k, a_tile, b_tile, load, store);
}

}  // namespace afl_tile
