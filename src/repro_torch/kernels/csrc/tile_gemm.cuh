// One 64×64 output tile of a matrix product in T (float or double),
// computed by one block of 256 threads: the tile loop of blocked.cu's
// trsm and trailing update (f32 and f64). panel.cu's products run on
// gemm_nt.cuh instead, and gram.cu on its own upper-tile loop.
//
// The reduction runs kStep = 16 indices at a time. For each step the
// caller's `load(a_tile, b_tile, k0)` stages, for reduction indices
// k0 .. k0 + 15, the tile's 64 rows of the left operand by
// a_tile.put(kk, i, value) and its 64 columns of the right operand by
// b_tile.put(kk, j, value), writing zero past a ragged edge. Each thread
// then accumulates a 4×4 register micro-tile with plain FMAs in T (no
// TF32, no mma), and finally hands each of its 16 sums to
// `store(i, j, value)`, with i and j inside the tile; the store masks the
// ragged edges and applies the epilogue. Operand layouts differ only in
// `load`, epilogues only in `store`. The two staging buffers take 8.7 KB
// in f32 and 17.4 KB in f64.
//
// The sums of one output run over k in order, one FMA chain per element.
//
// X2 (f32 only, precision "f32_x2": the reference's _make_mm split
// products): put splits each staged value into exact 12-bit halves
// (afl::split) in a hi and a lo plane, each output keeps three sums
// (afl::Sums: hi·hi, hi·lo, lo·hi), and store gets hh + (hl + lh); 17.4 KB
// of staging.

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

// What `load` writes through: one plane, or (X2) a value split into two.
template <class T>
struct Plain {
  Stage<T> s;
  __device__ __forceinline__ void put(int kk, int i, T v) const { s[kk][i] = v; }
};
struct Split {
  Stage<float> hi, lo;
  __device__ __forceinline__ void put(int kk, int i, float v) const {
    afl::split(v, hi[kk][i], lo[kk][i]);
  }
};

template <class T, bool X2 = false, class Load, class Store>
__device__ __forceinline__ void tile_gemm(int k, Load load, Store store) {
  static_assert(!X2 || sizeof(T) == 4, "the split products are f32 only");
  constexpr int kPlanes = X2 ? 2 : 1;
  __shared__ __align__(16) T a_tile[kPlanes][kStep][kTile + kPad];
  __shared__ __align__(16) T b_tile[kPlanes][kStep][kTile + kPad];
  const int tx = threadIdx.x % (kTile / kMicro);   // column group of the sub-tile
  const int ty = threadIdx.x / (kTile / kMicro);   // row group of the sub-tile

  afl::Sums<T, X2> acc[kMicro][kMicro];
  for (int k0 = 0; k0 < k; k0 += kStep) {
    if constexpr (X2)
      load(Split{a_tile[0], a_tile[1]}, Split{b_tile[0], b_tile[1]}, k0);
    else
      load(Plain<T>{a_tile[0]}, Plain<T>{b_tile[0]}, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      // the hi halves (native: the values), and X2's lo halves
      T av[kMicro], bv[kMicro], al[kMicro] = {}, bl[kMicro] = {};
      afl::load4(&a_tile[0][kk][ty * kMicro], av);
      afl::load4(&b_tile[0][kk][tx * kMicro], bv);
      if constexpr (X2) {
        afl::load4(&a_tile[1][kk][ty * kMicro], al);
        afl::load4(&b_tile[1][kk][tx * kMicro], bl);
      }
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int s = 0; s < kMicro; ++s) acc[r][s].add(av[r], al[r], bv[s], bl[s]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMicro; ++r)
#pragma unroll
    for (int s = 0; s < kMicro; ++s) store(ty * kMicro + r, tx * kMicro + s, acc[r][s].sum());
}

}  // namespace afl_tile
