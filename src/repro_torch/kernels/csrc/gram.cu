// Fused Gram statistics for the AFL local stage:
//
//     G = XᵀX  (d, d)     Q = XᵀY  (d, C)
//
// X is (N, d) and Y is (N, C), row-major, both f32 or both bf16. G and Q
// are f32. bf16 values are widened to f32 when read from shared memory and
// every product is accumulated with a plain f32 FMA (no TF32, no mma), so
// the result is the f32 matrix product up to the order of the sums.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram.py:gram_update
// (kernel body _gram_kernel). The TPU version walks N as its sequential
// grid axis, carrying each output tile in VMEM scratch from one grid step
// to the next, computes every tile of G, fuses Q into the j == 0 column of
// G's grid, and pads every dimension to a block multiple in its wrapper.
// On Hopper blocks run in parallel and in no order, so here each block
// loops over all N rows of its tile itself and keeps the tile in
// registers. The design:
//
//   * Only the tiles on and above the diagonal. A block computes one 64 × 64
//     tile of G whose columns start at or right of its rows, or one 64 × 64
//     tile of Q. Of a tile of G, the elements with col >= row are written
//     where they are, and those with col > row are written again,
//     transposed through shared memory, at (col, row): the tiles cover the
//     upper triangle once, so G[j][i] is a copy of G[i][j] and G is exactly
//     symmetric by construction. The FMAs of G are about half of the full
//     product's.
//   * Q's tiles, 64 of X's columns by 64 of Y's, run in the same grid as
//     G's; their first operand is the same X column tile as that row of G's
//     tiles (read again from L2, not shared: blocks do not meet). At d =
//     2304, C = 16 they are 36 of 702 blocks.
//   * X is already k-major: row k of X holds all d columns, so a tile's
//     operand for reduction rows k0 .. k0 + 15 is 16 row segments of X (or
//     Y), copied as they lie into a ring of kStages shared-memory slots by
//     16-byte cp.async (8-byte for bf16, which stays bf16 in shared memory
//     and is widened on read) while the slot before computes. A row whose
//     length or base does not allow 4-value chunks is copied value by value.
//   * 64 threads; each owns 8 × 8 outputs as four 4 × 4 blocks 32 rows and
//     32 columns apart, so each 16-byte read from shared memory feeds 16
//     FMAs and a warp reads 4 (8) neighbouring words: no bank conflicts.
//     The tile is written with float4 stores, 128 contiguous bytes a row
//     per warp, and its mirror from the shared-memory transpose in rows of
//     256 contiguous bytes.
//   * One block a tile: 702 blocks at d = 2304, all resident at once (8 an
//     SM), which fills the card in one wave. A 128 × 64 tile, and a
//     persistent grid walking the tiles, were no faster at N = 64 or 8192
//     on an H100 (PERF.md). Where the tiles are too few to fill the card
//     (small d), N is split over blockIdx.y (kernels/gram.py:split_rows):
//     each block writes its partial tile to a workspace the wrapper
//     allocates, and gram_reduce_kernel adds them in split order (the same
//     bits every call) and stores the tile and its mirror. The unsplit grid
//     runs an instance without the split's arithmetic (kSplit = false),
//     2.5% faster at N = 8192.
//
// Bound on an H100 SXM: the function needs N·d·(d+1) + 2·N·d·C flops (one
// triangle of G with its diagonal, and Q) at 67 TFLOP/s (f32 outside the
// tensor cores), against 4·(d² + d·C) + itemsize·N·(d+C) bytes at 3.35
// TB/s. The main path's per-batch shape (N=64, d=2304, C=16) is
// bytes-bound: 22.0 MB (6.6 us), most of it the f32 G write, against
// 0.345 GFLOP (5.1 us). The two are close, and in a one-wave grid every
// block computes, then stores: the FMAs do not hide behind the stores.
// At N=8192 it is operations-bound: 44.1 GFLOP (0.66 ms).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libafl_gram.so gram.cu
// Each entry point launches on the caller's stream (two kernels for a split
// N), does not synchronise, allocates nothing and returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kStep = 16;     // rows of X (and Y) in one ring slot
constexpr int kStages = 3;    // ring slots

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// one 4-value chunk: 16 bytes of f32, 8 of bf16; zeros where !ok
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  afl::cp_async16(dst, src, ok ? 16 : 0);
}
__device__ __forceinline__ void copy4(__nv_bfloat16* dst, const __nv_bfloat16* src, bool ok) {
  afl::cp_async8(dst, src, ok ? 8 : 0);
}
__device__ __forceinline__ void put(float* dst, const float* src, bool ok) {
  *dst = ok ? *src : 0.f;
}
__device__ __forceinline__ void put(__nv_bfloat16* dst, const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}

constexpr int kTile = 64;      // rows and columns of a tile
constexpr int kThreads = 64;   // each 8 × 8 outputs

struct Work {
  int n, d, c;
  int rows_per_split;  // rows of X one block sums (blockIdx.y picks which)
  int tiles;         // kTile-wide tiles along d
  int g_tiles;       // tiles of G on and above the diagonal
  int q_tiles;       // kTile-wide column tiles of Q
  int vec_x, vec_y;  // X (Y) rows are read as 4-value chunks
  int vec_g, vec_q;  // G (Q) rows are written as float4
};

// Rows k0 .. k0 + kStep − 1 and columns c0 .. c0 + COLS − 1 of src (row
// stride ld, n rows, ncols columns) into dst[kStep][COLS], zeros past the
// ends. With vec, ncols is a multiple of 4, so a chunk is wholly in or out.
template <typename T, int COLS, int NT>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int ld, int vec,
                                      int k0, int c0, int n, int ncols) {
  constexpr int kChunks = kStep * COLS / 4;
#pragma unroll
  for (int e = threadIdx.x; e < kChunks; e += NT) {
    const int r = e / (COLS / 4);
    const int cc = (e % (COLS / 4)) * 4;
    const int gr = k0 + r;
    const int gc = c0 + cc;
    T* to = dst + r * COLS + cc;
    const T* from = src + (static_cast<size_t>(gr < n ? gr : 0) * ld + (gc < ncols ? gc : 0));
    if (vec) {
      copy4(to, from, gr < n && gc < ncols);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) put(to + q, from + q, gr < n && gc + q < ncols);
    }
  }
}

// shared memory of one block: the ring, then (reusing it) the mirror's
// transposed staging
template <typename T>
struct Smem {
  static constexpr int kSlot = 2 * kStep * kTile;              // A then B, in T
  static constexpr int kMirrorLd = kTile + 4;                  // transposed staging row
  static constexpr size_t kRing = size_t(kStages) * kSlot * sizeof(T);
  static constexpr size_t kMirror = size_t(kTile) * kMirrorLd * sizeof(float);
  static constexpr size_t kBytes = kRing > kMirror ? kRing : kMirror;
};

// Block `tile`'s tile: rows i0.., columns j0.. of G (j0 >= i0), or of Q.
struct TileAt {
  int i0, j0;
  bool is_q;
};

__device__ __forceinline__ TileAt tile_at(int tile, const Work& w) {
  int i = 0;
  if (tile >= w.g_tiles) {
    const int rest = tile - w.g_tiles;
    return {rest / w.q_tiles * kTile, rest % w.q_tiles * kTile, true};
  }
  int rest = tile;
  for (;; ++i) {                        // row i holds tiles − i tiles
    if (rest < w.tiles - i) break;
    rest -= w.tiles - i;
  }
  return {i * kTile, (i + rest) * kTile, false};
}

// A thread's 8 × 8 outputs: rows ty·4 + r % 4 + 32·(r / 4), columns
// tx·4 + s % 4 + 32·(s / 4) of the tile.
constexpr int kTX = kTile / 8;

// The tile where it lies (all of Q's; of G's, col >= row), and G's mirror
// (col, row) for col > row, transposed through `mirror`. Every thread of
// the block calls it; the ring must have drained.
__device__ __forceinline__ void store_tile(const float (&acc)[8][8], const TileAt& t,
                                           const Work& w, float* __restrict__ g,
                                           float* __restrict__ q, float* mirror) {
  constexpr int H = kTile / 2;
  constexpr int LD = kTile + 4;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  float* __restrict__ out = t.is_q ? q : g;
  const int ld = t.is_q ? w.c : w.d;
  const bool vec = t.is_q ? w.vec_q : w.vec_g;
  const bool whole = t.is_q || t.j0 >= t.i0 + kTile;     // wholly above the diagonal
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = t.i0 + (r / 4) * H + ty * 4 + r % 4;
    if (row >= w.d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = t.j0 + h * H + tx * 4;
      float* dst = out + static_cast<size_t>(row) * ld + col;
      const float v[4] = {acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                          acc[r][4 * h + 3]};
      if (vec && whole && col < ld) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < ld && (t.is_q || col + e >= row)) dst[e] = v[e];
      }
    }
  }
  if (t.is_q) return;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int cl = (s / 4) * H + tx * 4 + s % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(mirror + cl * LD + h * H + ty * 4) =
          make_float4(acc[4 * h][s], acc[4 * h + 1][s], acc[4 * h + 2][s], acc[4 * h + 3][s]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kTile / 4; e += kThreads) {
    const int cl = e / (kTile / 4);
    const int rl = (e % (kTile / 4)) * 4;
    const int grow = t.j0 + cl;          // G row: a column of the tile
    const int gcol = t.i0 + rl;          // G columns: rows of the tile
    if (grow >= w.d) continue;
    const float4 v4 = *reinterpret_cast<const float4*>(mirror + cl * LD + rl);
    float* dst = g + static_cast<size_t>(grow) * w.d + gcol;
    if (w.vec_g && gcol + 3 < grow) {
      *reinterpret_cast<float4*>(dst) = v4;
    } else {
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e2 = 0; e2 < 4; ++e2)
        if (gcol + e2 < grow) dst[e2] = v[e2];
    }
  }
}

// grid (tiles, splits): block (t, s) sums rows s·rows_per_split .. of its
// tile; unsplit (one block a tile, all N rows) it stores the tile, split
// its partial into part[s][t][thread][64]
template <typename T, bool kSplit>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const T* __restrict__ x, const T* __restrict__ y, float* __restrict__ g,
            float* __restrict__ q, float* __restrict__ part, Work w) {
  constexpr int kSlot = Smem<T>::kSlot;
  constexpr int H = kTile / 2;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const TileAt t = tile_at(blockIdx.x, w);
  const T* __restrict__ bsrc = t.is_q ? y : x;
  const int bld = t.is_q ? w.c : w.d;
  const int bvec = t.is_q ? w.vec_y : w.vec_x;
  const int k_begin = kSplit ? blockIdx.y * w.rows_per_split : 0;
  const int k_end = kSplit ? min(w.n, k_begin + w.rows_per_split) : w.n;
  const int steps = (k_end - k_begin + kStep - 1) / kStep;

  auto load = [&](int s) {
    T* a = ring + (s % kStages) * kSlot;
    const int k0 = k_begin + s * kStep;
    stage<T, kTile, kThreads>(a, x, w.d, w.vec_x, k0, t.i0, k_end, w.d);
    stage<T, kTile, kThreads>(a + kStep * kTile, bsrc, bld, bvec, k0, t.j0, k_end, bld);
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s);
    afl::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    afl::cp_async_wait<kStages - 2>();   // slot s has landed
    __syncthreads();                     // ... for all, and slot s − 1 is free
    if (s + kStages - 1 < steps) load(s + kStages - 1);
    afl::cp_async_commit();
    const T* a = ring + (s % kStages) * kSlot;
    const T* b = a + kStep * kTile;
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      const float4 a0 = load4(a + kk * kTile + ty * 4);
      const float4 a1 = load4(a + kk * kTile + H + ty * 4);
      const float4 b0 = load4(b + kk * kTile + tx * 4);
      const float4 b1 = load4(b + kk * kTile + H + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int s2 = 0; s2 < 8; ++s2) acc[r][s2] = fmaf(av[r], bv[s2], acc[r][s2]);
    }
  }
  afl::cp_async_wait<0>();
  __syncthreads();                       // every read of the ring is done

  if constexpr (!kSplit) {
    store_tile(acc, t, w, g, q, reinterpret_cast<float*>(smem4));
    return;
  }
  float4* mine = reinterpret_cast<float4*>(
      part + ((static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * kThreads +
              threadIdx.x) * 64);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mine[2 * r + h] = make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                                    acc[r][4 * h + 3]);
}

// grid (tiles): each tile's partials summed in split order, then stored
__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ g,
                   float* __restrict__ q, int splits, Work w) {
  __shared__ __align__(16) float mirror[kTile * (kTile + 4)];
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int s = 0; s < 8; ++s) acc[r][s] = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float4* theirs = reinterpret_cast<const float4*>(
        part + ((static_cast<size_t>(sp) * gridDim.x + blockIdx.x) * kThreads + threadIdx.x) *
                   64);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = theirs[2 * r + h];
        acc[r][4 * h] += v.x;
        acc[r][4 * h + 1] += v.y;
        acc[r][4 * h + 2] += v.z;
        acc[r][4 * h + 3] += v.w;
      }
  }
  store_tile(acc, tile_at(blockIdx.x, w), w, g, q, mirror);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// rows_per_split: a multiple of kStep, or n; with more than one split,
// `part` holds splits · tiles · kThreads · 64 floats
template <typename T>
int launch(const void* x, const void* y, void* g, void* q, int n, int d, int c,
           int rows_per_split, void* part, void* stream_v) {
  if (n < 0 || d < 1 || c < 0 || rows_per_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  Work w{};
  w.n = n;
  w.d = d;
  w.c = c;
  w.rows_per_split = rows_per_split;
  w.tiles = (d + kTile - 1) / kTile;
  w.q_tiles = (c + kTile - 1) / kTile;
  const long long g_tiles = static_cast<long long>(w.tiles) * (w.tiles + 1) / 2;
  const long long blocks = g_tiles + static_cast<long long>(w.tiles) * w.q_tiles;
  const int splits = n > rows_per_split ? (n + rows_per_split - 1) / rows_per_split : 1;
  if (blocks > INT32_MAX || splits > 65535 || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  w.g_tiles = static_cast<int>(g_tiles);
  w.vec_x = d % 4 == 0 && aligned(x, 4 * sizeof(T));
  w.vec_y = c % 4 == 0 && aligned(y, 4 * sizeof(T));
  w.vec_g = d % 4 == 0 && aligned(g, 16);
  w.vec_q = c % 4 == 0 && aligned(q, 16);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const dim3 grid(static_cast<unsigned>(blocks), splits);
  if (splits == 1) {
    gram_kernel<T, false><<<grid, kThreads, Smem<T>::kBytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(y), static_cast<float*>(g),
        static_cast<float*>(q), nullptr, w);
    return static_cast<int>(cudaGetLastError());
  }
  gram_kernel<T, true><<<grid, kThreads, Smem<T>::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<float*>(g),
      static_cast<float*>(q), static_cast<float*>(part), w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(g), static_cast<float*>(q), splits,
      w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int afl_gram_update_f32(const void* x, const void* y, void* g, void* q, int n,
                                   int d, int c, int rows_per_split, void* part,
                                   void* stream) {
  return launch<float>(x, y, g, q, n, d, c, rows_per_split, part, stream);
}

extern "C" int afl_gram_update_bf16(const void* x, const void* y, void* g, void* q, int n,
                                    int d, int c, int rows_per_split, void* part,
                                    void* stream) {
  return launch<__nv_bfloat16>(x, y, g, q, n, d, c, rows_per_split, part, stream);
}
