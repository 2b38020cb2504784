// The factor and inverse of one diagonal block held in shared memory as a
// lower triangle packed by rows, in sub-blocks of 32 with a handful of
// block barriers, in T (float or double): the micro-routines that
// panel.cu's panel_tri_inv and blocked.cu's diagonal and inverse kernels
// share. They compute what the column loops of packed_tri.cuh compute (the
// reference's _factor_tile and _tri_inv_tile, src/repro/kernels/solve.py),
// which take two block barriers a column or a row: 2b = 512 barrier-separated
// steps for a 256-wide inverse, with half the block idle at each.
//
//   invert_blocked  L (bp, bp) lower  ->  Z = L^-1, in place
//     * each 32-wide diagonal sub-block is inverted by one warp, all at
//       once, from a dense copy of it (fixed offsets): lane c keeps column
//       c of Z in 32 registers and runs the forward substitution
//       z_i = (e_i − Σ_{m<i} L[i][m] z_m) / L[i][i] down its column,
//       right-looking; L is read from shared memory, the same address in
//       every lane (a broadcast, which costs what a shuffle does and
//       spends no registers). No block barrier inside a sub-block.
//     * then pairs of neighbouring inverses are merged level by level,
//       Z21 = −Z22 · L21 · Z11, as two triangular-times-dense products by
//       the whole block: T = L21 · Z11 into the merge scratch, then
//       Z21 = −Z22 · T over L21's place. log2(bp / 32) levels (three at
//       256), two barriers each. A warp takes four columns of T (four rows
//       of Z21), so the triangular operand's k range is the same in all
//       its lanes and no lane idles on a range it does not need.
//   factor_blocked  A (bp, bp) SPD  ->  L = chol(A), in place, bp <= 128
//     per sub-panel of 32 columns: one warp factors the 32×32 diagonal
//     sub-block in registers (lane i keeps row i; the pivot reaches the
//     lanes by __shfl_sync, column k by one store a lane and 16-byte
//     broadcast loads, where a shuffle an entry took twice the
//     instructions); the block solves the rows below it (one thread a
//     row, forward substitution against a dense copy of the sub-block,
//     rows in registers), writing them also to a dense scratch; the block
//     applies the rank-32 update to the rest of the triangle from that
//     scratch (a warp four rows, a lane a column of each chunk of 32, in
//     registers). Three barriers a sub-panel, where factor_packed takes 64.
//
// Divisions. An IEEE division is a reciprocal and its corrections, many
// times an FMA's latency, so the substitutions scale by the reciprocal of
// each diagonal entry: one IEEE division a diagonal, taken off the chain
// of steps, as LAPACK's dpotf2 and dtrti2 scale. The 32 pivots of a
// sub-block's factor stay a chain, each waiting on its sqrt and on the
// division of its column: 128 of them a diagonal block, the largest part
// of blocked_cholesky's diagonal step.
//
// The width bp is a multiple of 32: load_lower_padded pads a (b, b) block
// to bp = padded(b) with an identity tail, which factors and inverts to
// the identity and never reaches the rows above it (block diagonal), so
// the first b rows are the block's own factor or inverse. Merge pairs whose
// second block is narrower than the first (bp / 32 not a power of two)
// are masked.
//
// Every product is a plain FMA or multiply in T, sqrt and division are
// IEEE and no pivot is clamped: a block that is not positive definite gives NaN (sqrt
// of a negative pivot). Only the lower triangle is read. Sums run in a
// fixed order: the same input gives the same bits.
//
// Shared memory: the packed triangle, tri(bp) values, and a scratch of
// kScratchValues (dense 32-wide stagings, then the merge products: one
// (s, s + 1) product a pair). At b = 256 in f32 that is 128.5 KiB +
// 64.5 KiB = 193 KiB, under the 227 KiB a block can take; at b = 128 in
// f64 64.5 KiB + 33.5 KiB.

#pragma once

#include "packed_tri.cuh"
#include "scalar.cuh"

namespace afl_tri {

constexpr int kSub = 32;   // sub-block width: one warp

__host__ __device__ constexpr int padded(int b) { return (b + kSub - 1) / kSub * kSub; }

constexpr int kLd = kSub + 1;                  // row stride of a dense 32-wide staging
constexpr int kFactorMax = 128;                // the widest triangle factor_blocked takes
// factor_blocked's work: two buffers of a column of the diagonal
// sub-block, that sub-block dense, and the rows below it dense
constexpr int kFactorWork = 2 * kSub + kSub * kLd + (kFactorMax - kSub) * kLd;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Values of the scratch for triangles up to kMaxPanel wide: for the
// inverse, each warp's dense copy of its 32-wide sub-block and then the
// merge products, one (s, s + 1) product a pair, kMaxPanel / 2 ·
// (kMaxPanel / 2 + 1) at most in all at any level; for the factor, its
// work.
template <int kMaxPanel>
constexpr int kScratchValues = cmax(cmax(kMaxPanel / 2 * (kMaxPanel / 2 + 1),
                                         kMaxPanel / kSub * kSub * kLd),
                                    kMaxPanel <= kFactorMax ? kFactorWork : 0);

// The row of entry e of a triangle packed by rows.
__device__ __forceinline__ int row_of(int e) {
  int i = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  while (tri(i) > e) --i;
  while (tri(i + 1) <= e) ++i;
  return i;
}

// The lower triangle of a (b, b) block with row stride lda into s, padded
// to bp = padded(b) rows with an identity tail. Threads walk the packed
// entries in order, each with kBatch loads in flight before it stores them.
template <int kThreads, class T>
__device__ void load_lower_padded(const T* __restrict__ a, int lda, int b, T* __restrict__ s) {
  constexpr int kBatch = 16;
  const int n = tri(padded(b));
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    T v[kBatch];
#pragma unroll
    for (int l = 0; l < kBatch; ++l) {
      const int e = e0 + l * kThreads;
      const int i = row_of(min(e, n - 1));
      const int k = e - tri(i);
      v[l] = e < n && i < b ? a[static_cast<size_t>(i) * lda + k] : T(k == i ? 1 : 0);
    }
#pragma unroll
    for (int l = 0; l < kBatch; ++l)
      if (e0 + l * kThreads < n) s[e0 + l * kThreads] = v[l];
  }
}

// One warp inverts the 32×32 diagonal sub-block at (o, o) in place,
// through a dense copy of it in stage (kSub · kLd values), so that every
// read of L is at a fixed offset. Lane c keeps column c of Z; z_m is final
// once the rows above have been folded into it, and is then folded into
// every row below (right-looking). Each diagonal's reciprocal is one IEEE
// division, taken by its lane before the sweep (see Divisions above).
template <class T>
__device__ __forceinline__ void invert_sub_block(T* s, T* stage, int o) {
  const int c = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kSub; ++i)
    if (c <= i) stage[i * kLd + c] = s[tri(o + i) + o + c];
  __syncwarp();
  const T rd = T(1) / stage[c * kLd + c];
  T z[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) z[i] = i == c ? T(1) : T(0);
#pragma unroll
  for (int m = 0; m < kSub; ++m) {
    const T r = __shfl_sync(0xffffffffu, rd, m);   // in every lane, outside the select
    z[m] = c <= m ? z[m] * r : T(0);
#pragma unroll
    for (int i = m + 1; i < kSub; ++i) z[i] = afl::fma_(-stage[i * kLd + m], z[m], z[i]);
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i)
    if (c <= i) s[tri(o + i) + o + c] = z[i];
  __syncwarp();
}

// Merge pairs at level sw: the pair p covers [a, a + sw + w2), a = 2·sw·p,
// its second block w2 = min(sw, bp − a − sw) wide (a multiple of 32).
__device__ __forceinline__ int merge_pairs(int bp, int sw) { return (bp + sw - 1) / (2 * sw); }

// T = L21 · Z11 into merge (row stride sw + 1), T[r][c] = Σ_{k ≥ c}
// L21[r][k] Z11[k][c]. A warp takes four columns c0..c0+3 of one pair, so
// the triangular k range starts at c0 in every lane; lane l takes rows
// l + 32·i, i < kR = sw / 32.
template <int kR, int kThreads, class T>
__device__ void merge_left(const T* s, T* merge, int bp, int sw) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int groups = sw / 4;
  for (int u = warp; u < merge_pairs(bp, sw) * groups; u += kWarps) {
    const int p = u / groups;
    const int c0 = 4 * (u % groups);
    const int a = 2 * sw * p;
    const int w2 = min(sw, bp - a - sw);
    const T* rows[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) rows[i] = s + tri(a + sw + min(lane + 32 * i, w2 - 1)) + a;
    T acc[kR][4];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
    const T* zk = s + tri(a + c0) + a + c0;         // Z11[k][c0], from k = c0
#pragma unroll 4
    for (int k = c0; k < sw; ++k) {
      T bv[4], av[kR];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = j <= k - c0 ? zk[j] : T(0);
#pragma unroll
      for (int i = 0; i < kR; ++i) av[i] = rows[i][k];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = afl::fma_(av[i], bv[j], acc[i][j]);
      zk += a + k + 1;                              // tri(a + k + 1) − tri(a + k)
    }
    T* tm = merge + static_cast<size_t>(p) * sw * (sw + 1);
#pragma unroll
    for (int i = 0; i < kR; ++i)
      if (32 * i < w2)
#pragma unroll
        for (int j = 0; j < 4; ++j) tm[(lane + 32 * i) * (sw + 1) + c0 + j] = acc[i][j];
  }
}

// Z21 = −Z22 · T over L21's place, Z21[r][c] = −Σ_{k ≤ r} Z22[r][k] T[k][c].
// A warp takes four rows r0..r0+3 of one pair, so the triangular k range
// ends at r0 + 3 in every lane; lane l takes columns l + 32·j, j < kC =
// sw / 32.
template <int kC, int kThreads, class T>
__device__ void merge_right(T* s, const T* merge, int bp, int sw) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int groups = sw / 4;
  for (int u = warp; u < merge_pairs(bp, sw) * groups; u += kWarps) {
    const int p = u / groups;
    const int r0 = 4 * (u % groups);
    const int a = 2 * sw * p;
    const int w2 = min(sw, bp - a - sw);
    if (r0 >= w2) continue;
    const T* tm = merge + static_cast<size_t>(p) * sw * (sw + 1);
    const T* zr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) zr[i] = s + tri(a + sw + r0 + i) + a + sw;
    T acc[4][kC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) acc[i][j] = T(0);
#pragma unroll 4
    for (int k = 0; k <= r0 + 3; ++k) {
      T av[4], bv[kC];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = k <= r0 + i ? zr[i][k] : T(0);
#pragma unroll
      for (int j = 0; j < kC; ++j) bv[j] = tm[k * (sw + 1) + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) acc[i][j] = afl::fma_(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kC; ++j) s[tri(a + sw + r0 + i) + a + lane + 32 * j] = -acc[i][j];
  }
}

template <int kWide, int kThreads, class T>
__device__ void merge_level(T* s, T* merge, int bp, int sw) {
  merge_left<kWide, kThreads>(s, merge, bp, sw);
  __syncthreads();
  merge_right<kWide, kThreads>(s, merge, bp, sw);
  __syncthreads();
}

// Inverse of the packed (bp, bp) lower triangle s, bp <= 256, in place;
// scratch holds kScratchValues<bp> values. Starts and ends with a block
// barrier.
template <int kThreads, class T>
__device__ void invert_blocked(T* s, T* merge, int bp) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  __syncthreads();
  for (int blk = warp; blk * kSub < bp; blk += kWarps)
    invert_sub_block(s, merge + warp * kSub * kLd, blk * kSub);
  __syncthreads();
  if (bp > 32) merge_level<1, kThreads>(s, merge, bp, 32);
  if (bp > 64) merge_level<2, kThreads>(s, merge, bp, 64);
  if (bp > 128) merge_level<4, kThreads>(s, merge, bp, 128);
}

// Cholesky factor of the packed (bp, bp) SPD triangle s, bp <= kFactorMax,
// in place; work (16-byte aligned) holds kFactorWork values. Starts and
// ends with a block barrier.
template <int kThreads, class T>
__device__ void factor_blocked(T* s, T* work, int bp) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kChunks = (kFactorMax - kSub) / 32;     // column chunks of a trailing row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  T* col = work;                // two buffers of a column, then the reciprocals
  T* l11 = work + 2 * kSub;     // the diagonal sub-block, dense, row stride kLd
  T* l21 = l11 + kSub * kLd;    // the rows below it, dense, row stride kLd
  __syncthreads();
  for (int o = 0; o < bp; o += kSub) {
    // the 32×32 diagonal sub-block: lane i keeps row i; the pivot reaches
    // the lanes by a shuffle, column k through shared memory (two buffers,
    // one barrier a step), read four entries a load; the next pivot's
    // entry is updated and its root taken before the rest of the column
    if (warp == 0) {
      T a[kSub];
      T* row = s + tri(o + lane) + o;
#pragma unroll
      for (int m = 0; m < kSub; ++m) a[m] = m <= lane ? row[m] : T(0);
      T pv = afl::sqrt_(__shfl_sync(0xffffffffu, a[0], 0));
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        if (lane > k) a[k] = a[k] / pv;
        else if (lane == k) a[k] = pv;
        if (k + 1 == kSub) break;
        T* ck = col + (k % 2) * kSub;
        ck[lane] = a[k];
        __syncwarp();
        T cv[kSub];
#pragma unroll
        for (int q = (k + 1) / 4; q < kSub / 4; ++q) {
          T v[4];
          afl::load4(ck + 4 * q, v);
#pragma unroll
          for (int t = 0; t < 4; ++t) cv[4 * q + t] = v[t];
        }
        if (lane > k) a[k + 1] = afl::fma_(-a[k], cv[k + 1], a[k + 1]);
        pv = afl::sqrt_(__shfl_sync(0xffffffffu, a[k + 1], k + 1));
#pragma unroll
        for (int j = k + 2; j < kSub; ++j)
          if (lane >= j) a[j] = afl::fma_(-a[k], cv[j], a[j]);
      }
#pragma unroll
      for (int m = 0; m < kSub; ++m)
        if (m <= lane) {
          row[m] = a[m];
          l11[lane * kLd + m] = a[m];
        }
      __syncwarp();
      col[lane] = T(1) / l11[lane * kLd + lane];   // the pivots' reciprocals, for the rows below
    }
    __syncthreads();
    const int e = o + kSub;
    const int n = bp - e;
    // the rows below it: x = A21 row · L11⁻ᵀ, by forward substitution
    // (right-looking: x_c is final once scaled by the reciprocal of
    // L11[c][c], each one IEEE division of the diagonal's lane, as
    // LAPACK's dpotf2 scales), into place and into the dense copy
    for (int r = threadIdx.x; r < n; r += kThreads) {
      T* row = s + tri(e + r) + o;
      T x[kSub];
#pragma unroll
      for (int c = 0; c < kSub; ++c) x[c] = row[c];
#pragma unroll
      for (int c = 0; c < kSub; ++c) {
        x[c] = x[c] * col[c];
#pragma unroll
        for (int c2 = c + 1; c2 < kSub; ++c2) x[c2] = afl::fma_(-x[c], l11[c2 * kLd + c], x[c2]);
      }
#pragma unroll
      for (int c = 0; c < kSub; ++c) {
        row[c] = x[c];
        l21[r * kLd + c] = x[c];
      }
    }
    __syncthreads();
    // the rank-32 update of the triangle below and right of them: a warp
    // takes four rows, each lane a column of every chunk of 32
    for (int i0 = 4 * warp; i0 < n; i0 += 4 * kWarps) {
      T acc[4][kChunks];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int m = 0; m < kChunks; ++m) acc[ii][m] = T(0);
#pragma unroll 4
      for (int k = 0; k < kSub; ++k) {
        T av[4], bv[kChunks];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) av[ii] = l21[(i0 + ii) * kLd + k];
#pragma unroll
        for (int m = 0; m < kChunks; ++m) {
          const int j = lane + 32 * m;
          bv[m] = 32 * m <= i0 + 3 && j < n ? l21[j * kLd + k] : T(0);
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int m = 0; m < kChunks; ++m) acc[ii][m] = afl::fma_(av[ii], bv[m], acc[ii][m]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int m = 0; m < kChunks; ++m) {
          const int j = lane + 32 * m;
          if (j <= i0 + ii) {
            T* dst = s + tri(e + i0 + ii) + e + j;
            *dst = *dst - acc[ii][m];
          }
        }
    }
    __syncthreads();
  }
}

}  // namespace afl_tri
