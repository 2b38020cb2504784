// Fused Gram statistics for the AFL local stage:
//
//     G = XᵀX  (d, d)     Q = XᵀY  (d, C)
//
// X is (N, d) and Y is (N, C), row-major, both f32 or both bf16. G and Q
// are f32. bf16 values are converted to f32 on load and every product is
// accumulated with a plain f32 FMA (no TF32, no mma), so the result is the
// f32 matrix product up to the order of the sums.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram.py:gram_update
// (kernel body _gram_kernel). The TPU version walks N as its sequential
// grid axis, carrying each output tile in VMEM scratch from one grid step
// to the next, fuses Q into the j == 0 column of G's grid, and pads every
// dimension to a block multiple in its wrapper. On Hopper blocks run in
// parallel and in no order, so here each block owns one 64×64 output tile,
// loops over all N rows itself and keeps its tile in registers (the tile
// loop of tile_gemm.cuh, shared with blocked.cu); Q gets its own column of
// blocks after G's; the ragged edges of N, d and C are masked in the loads
// and stores instead of padded.
//
// Work: this kernel does 2·N·d·(d+C) flops in f32 FMA, since it computes
// both triangles of G. The function needs only N·d·(d+1) + 2·N·d·C: G is
// symmetric, so one triangle with its diagonal suffices. Bound on an H100
// SXM: that count at 67 TFLOP/s (f32 outside the tensor cores) against
// 4·(d² + d·C) + itemsize·N·(d+C) bytes at 3.35 TB/s. At the main path's
// per-batch shape (N=64, d=2304, C=16) that is 0.345 GFLOP (5.1 us)
// against 22.0 MB (6.6 us): bytes-bound, the full f32 G write being most
// of it. At N=8192 it is 44.1 GFLOP (0.66 ms), operations-bound. This
// first version meets neither bound on purpose: it keeps f32 FMA for
// exactness and computes both triangles. Computing only the tiles on and
// above the diagonal (mirroring them on store), cp.async/TMA staging, and
// wgmma for bf16 inputs are the follow-ups.
// G[i][j] and G[j][i] come from the same FMA chain with the factors
// swapped, so G is exactly symmetric.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libafl_gram.so gram.cu
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "tile_gemm.cuh"

namespace {

using afl_tile::kLoadsPerThread;
using afl_tile::kThreads;
using afl_tile::kTile;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// blockIdx.y picks the tile's rows of d; blockIdx.x < g_col_tiles picks a
// tile of G's columns, the blocks after them tiles of Q's columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ x, const T* __restrict__ y,
            float* __restrict__ g, float* __restrict__ q,
            int n, int d, int c, int g_col_tiles) {
  const bool is_q = blockIdx.x >= g_col_tiles;
  const int i0 = blockIdx.y * kTile;
  const int j0 = (is_q ? blockIdx.x - g_col_tiles : blockIdx.x) * kTile;
  const T* __restrict__ b_src = is_q ? y : x;
  const int b_cols = is_q ? c : d;
  float* __restrict__ out = is_q ? q : g;

  afl_tile::tile_gemm<float>(
      n,
      // the reduction runs over the rows of X / Y: neighbouring threads
      // read neighbouring columns of one row
      [=](afl_tile::Stage<float> a_tile, afl_tile::Stage<float> b_tile, int k0) {
#pragma unroll
        for (int l = 0; l < kLoadsPerThread; ++l) {
          const int e = threadIdx.x + l * kThreads;
          const int kk = e / kTile;
          const int m = e % kTile;
          const int row = k0 + kk;
          const int ci = i0 + m;
          const int cj = j0 + m;
          a_tile[kk][m] = (row < n && ci < d)
                              ? to_f32(x[static_cast<size_t>(row) * d + ci])
                              : 0.0f;
          b_tile[kk][m] = (row < n && cj < b_cols)
                              ? to_f32(b_src[static_cast<size_t>(row) * b_cols + cj])
                              : 0.0f;
        }
      },
      [=](int r, int s, float v) {
        const int row = i0 + r;
        const int col = j0 + s;
        if (row < d && col < b_cols) out[static_cast<size_t>(row) * b_cols + col] = v;
      });
}

template <typename T>
int launch(const void* x, const void* y, void* g, void* q, int n, int d, int c,
           void* stream) {
  const int g_col_tiles = (d + kTile - 1) / kTile;
  const int q_col_tiles = (c + kTile - 1) / kTile;
  const dim3 grid(g_col_tiles + q_col_tiles, g_col_tiles);
  gram_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<float*>(g),
      static_cast<float*>(q), n, d, c, g_col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int afl_gram_update_f32(const void* x, const void* y, void* g,
                                   void* q, int n, int d, int c, void* stream) {
  return launch<float>(x, y, g, q, n, d, c, stream);
}

extern "C" int afl_gram_update_bf16(const void* x, const void* y, void* g,
                                    void* q, int n, int d, int c, void* stream) {
  return launch<__nv_bfloat16>(x, y, g, q, n, d, c, stream);
}
