// The factor and inverse of one (b, b) diagonal block held in shared
// memory as a lower triangle packed by rows, computed by one block of
// kThreads threads in T (float or double): the column loops of the
// reference's _factor_tile and _tri_inv_tile (src/repro/kernels/solve.py),
// which panel.cu's panel_factor runs (1024 threads, b <= 256 in f32,
// b <= 128 in f64), and the packed layout's helpers (tri, load_lower,
// store_lower) that tri_blocked.cuh builds on.
//
// Only the lower triangle carries data: the upper half of the input is
// never read and the output's is written as zeros. Every product is a
// plain FMA in T, sqrt and division are IEEE and no pivot is clamped, so a
// block that is not positive definite gives NaN (sqrt of a negative
// pivot), as the reference does.

#pragma once

#include <cstddef>

#include "scalar.cuh"

namespace afl_tri {

// Offset of row i in a lower triangle packed by rows.
__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

// The lower triangle of a (b, b) block with row stride lda into s.
template <int kThreads, class T>
__device__ void load_lower(const T* a, int lda, int b, T* s) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < b; i += kWarps)
    for (int k = lane; k <= i; k += 32)
      s[tri(i) + k] = a[static_cast<size_t>(i) * lda + k];
}

// Writes the packed triangle as a dense (b, b) block with row stride ldo
// and a zero upper half.
template <int kThreads, class T>
__device__ void store_lower(const T* s, int b, T* out, int ldo) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < b; i += kWarps)
    for (int k = lane; k < b; k += 32)
      out[static_cast<size_t>(i) * ldo + k] = k <= i ? s[tri(i) + k] : T(0);
}

// Right-looking Cholesky of the packed triangle, in place. At column j one
// barrier publishes the scaled column (kept in col), then warps take the
// rows and lanes the columns of the trailing triangle's rank-1 update.
template <int kThreads, class T>
__device__ void factor_packed(T* s, T* col, int b) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int j = 0; j < b; ++j) {
    const T pv = afl::sqrt_(s[tri(j) + j]);
    for (int t = j + 1 + threadIdx.x; t < b; t += kThreads) {
      const T c = s[tri(t) + j] / pv;
      s[tri(t) + j] = c;
      col[t] = c;
    }
    __syncthreads();
    // The pivot is read by every thread above; nothing below reads it.
    if (threadIdx.x == 0) s[tri(j) + j] = pv;
    for (int i = j + 1 + warp; i < b; i += kWarps) {
      const T ci = col[i];
      T* row = s + tri(i);
      for (int k = j + 1 + lane; k <= i; k += 32)
        row[k] = afl::fma_(-ci, col[k], row[k]);
    }
    __syncthreads();
  }
}

// Inverse of the packed lower triangle, in place, by forward substitution
// on the identity: z_i = (e_i − Σ_{m<i} L[i][m] z_m) / L[i][i]. Row i of L
// is copied to lrow first, since row i of Z overwrites it; the rows of Z
// above it have already overwritten theirs. kThreads / kMaxPanel
// neighbouring lanes share each column's dot product and add their parts
// with shuffles.
template <int kThreads, int kMaxPanel, class T>
__device__ void invert_packed(T* s, T* lrow, int b) {
  constexpr int kParts = kThreads / kMaxPanel;
  static_assert(kParts >= 1 && kParts <= 32 && (kParts & (kParts - 1)) == 0,
                "a power of two of threads for each column");
  const int c = threadIdx.x / kParts;
  const int part = threadIdx.x % kParts;
  for (int i = 0; i < b; ++i) {
    for (int t = threadIdx.x; t <= i; t += kThreads) lrow[t] = s[tri(i) + t];
    __syncthreads();
    T acc = T(0);
    if (c <= i)
      for (int m = c + part; m < i; m += kParts)
        acc = afl::fma_(lrow[m], s[tri(m) + c], acc);
#pragma unroll
    for (int off = 1; off < kParts; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (c <= i && part == 0)
      s[tri(i) + c] = ((c == i ? T(1) : T(0)) - acc) / lrow[i];
    __syncthreads();
  }
}

}  // namespace afl_tri
