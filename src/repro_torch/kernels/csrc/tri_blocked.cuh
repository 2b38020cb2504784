// The factor and inverse of one diagonal block held in shared memory as a
// lower triangle packed by rows (row i at tri(i)), in sub-blocks of 32 with
// a handful of block barriers, in T (float or double): the micro-routines
// that panel.cu's panel_factor and panel_tri_inv and blocked.cu's diagonal
// and inverse kernels share. They compute what the reference's
// _factor_tile and _tri_inv_tile (src/repro/kernels/solve.py) compute with
// column loops, which take two block barriers a column or a row: 2b = 512
// barrier-separated steps for a 256-wide factor and as many for its
// inverse, with most of the block idle at each.
//
//   invert_blocked  L (bp, bp) lower  ->  Z = L^-1, in place, bp <= 256
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
//   factor_blocked  A (bp, bp) SPD  ->  L = chol(A), in place, bp <= kWidth
//     per sub-panel of 32 columns: one warp factors the 32×32 diagonal
//     sub-block in registers (lane i keeps row i; the pivot reaches the
//     lanes by __shfl_sync, column k by one store a lane and 16-byte
//     broadcast loads, where a shuffle an entry took twice the
//     instructions); the block solves the rows below it (one thread a
//     row, forward substitution against a dense copy of the sub-block,
//     rows in registers), writing them also to a dense scratch; the block
//     applies the rank-32 update to the rest of the triangle from that
//     scratch (a warp four rows, a lane a column of each chunk of 32, in
//     registers: kWidth / 32 − 1 chunks). Three barriers a sub-panel,
//     where the column loop takes 64.
//   load_factor_ahead  the same factor, loaded from device memory first,
//     with a look-ahead: warp 0's chain of 32 pivots runs beside the
//     rank-32 update instead of after it (see the function).
//
// Divisions. An IEEE division is a reciprocal and its corrections, many
// times an FMA's latency, so the substitutions scale by the reciprocal of
// each diagonal entry: one IEEE division a diagonal, taken off the chain
// of steps, as LAPACK's dpotf2 and dtrti2 scale. The 32 pivots of a
// sub-block's factor stay a chain, each waiting on its sqrt and on the
// division of its column: 128 of them a 128-wide diagonal block, the
// largest part of blocked_cholesky's diagonal step, and 256 of panel_factor's.
//
// The width bp is a multiple of 32: load_lower_padded and load_rows pad a
// (b, b) block to bp = padded(b) with an identity tail, which factors and
// inverts to the identity and never reaches the rows above it (block
// diagonal), so the first b rows are the block's own factor or inverse.
// Merge pairs whose second block is narrower than the first (bp / 32 not
// a power of two) are masked.
//
// Every product is a plain FMA or multiply in T, sqrt and division are
// IEEE and no pivot is clamped: a block that is not positive definite gives NaN (sqrt
// of a negative pivot). Only the lower triangle is read. Sums run in a
// fixed order, whichever warp takes them: the same input gives the same bits.
//
// Shared memory: the packed triangle, tri(bp) values, and a scratch of
// kScratchValues (dense 32-wide stagings, then the merge products: one
// (s, s + 1) product a pair; the factor's work at its widest, 8512 values
// at 256, fits under the inverse's 16512). At b = 256 in f32 that is
// 128.5 KiB + 64.5 KiB = 193 KiB, under the 227 KiB a block can take; at
// b = 128 in f64 64.5 KiB + 33.5 KiB.

#pragma once

#include <cstddef>

#include "scalar.cuh"

namespace afl_tri {

constexpr int kSub = 32;   // sub-block width: one warp

// Offset of row i in a lower triangle packed by rows.
__device__ __forceinline__ int tri(int i) { return i * (i + 1) / 2; }

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

// Points of panel_factor's schedule at which load_factor_ahead,
// invert_blocked and panel.cu's factor_kernel call a Marks functor,
// mark(point), in every thread that reaches the point: after each block
// barrier, and in warp 0 after its chain and in the updating warps after
// their rows. The kernels pass NoMarks, which compiles to nothing;
// tools/panel_factor_probe.cu passes one that stamps clock64().
namespace marks {
constexpr int kStart = 0;      // the kernel's first instruction
constexpr int kLoaded = 1;     // the load and the first diagonal sub-block's chain
// sub-panel o's phases: 0 the rows below, 1 the next diagonal sub-block's
// update, 2 warp 0's chain, 3 the rest of the update
__host__ __device__ constexpr int step(int o, int phase) { return 2 + 4 * (o / kSub) + phase; }
constexpr int kFactored = 40;
constexpr int kInverting = 41;  // invert_blocked's first barrier: L stored
constexpr int kSubBlocks = 42;  // the diagonal sub-blocks inverted
constexpr int kMerged = 43;     // + level: merge levels of 32, 64, 128
constexpr int kDone = 46;       // the kernel's last instruction: Z stored
constexpr int kPoints = 47;
}  // namespace marks

struct NoMarks {
  __device__ __forceinline__ void operator()(int) const {}
};

__host__ __device__ constexpr int padded(int b) { return (b + kSub - 1) / kSub * kSub; }

constexpr int kLd = kSub + 1;                  // row stride of a dense 32-wide staging
// factor_blocked's work for triangles up to kWidth wide: two buffers of a
// column of the diagonal sub-block, that sub-block dense, and the rows
// below it dense
template <int kWidth>
constexpr int kFactorWork = 2 * kSub + kSub * kLd + (kWidth - kSub) * kLd;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Values of the scratch for triangles up to kMaxPanel wide: for the
// inverse, each warp's dense copy of its 32-wide sub-block and then the
// merge products, one (s, s + 1) product a pair, kMaxPanel / 2 ·
// (kMaxPanel / 2 + 1) at most in all at any level; for the factor, its
// work.
template <int kMaxPanel>
constexpr int kScratchValues = cmax(cmax(kMaxPanel / 2 * (kMaxPanel / 2 + 1),
                                         kMaxPanel / kSub * kSub * kLd),
                                    kFactorWork<kMaxPanel>);

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
template <int kThreads, class T, class Marks = NoMarks>
__device__ void invert_blocked(T* s, T* merge, int bp, const Marks& mark = Marks{}) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  __syncthreads();
  mark(marks::kInverting);
  for (int blk = warp; blk * kSub < bp; blk += kWarps)
    invert_sub_block(s, merge + warp * kSub * kLd, blk * kSub);
  __syncthreads();
  mark(marks::kSubBlocks);
  if (bp > 32) merge_level<1, kThreads>(s, merge, bp, 32);
  mark(marks::kMerged);
  if (bp > 64) merge_level<2, kThreads>(s, merge, bp, 64);
  mark(marks::kMerged + 1);
  if (bp > 128) merge_level<4, kThreads>(s, merge, bp, 128);
  mark(marks::kMerged + 2);
}

// Rows row0.. of a (b, b) block with row stride lda into the packed
// triangle s, padded to bp = padded(b) <= kWidth rows with an identity
// tail, by the warps warp0.. of the block: a warp takes two rows at a
// time and a lane a column of each chunk of 32, every load of both rows in
// flight before the stores (no search for an entry's row, as
// load_lower_padded does).
template <int kThreads, int kWidth, class T>
__device__ void load_rows(const T* __restrict__ a, int lda, int b, T* __restrict__ s, int row0,
                          int warp0) {
  constexpr int kC = kWidth / 32;
  const int nw = kThreads / 32 - warp0;
  const int w = static_cast<int>(threadIdx.x / 32) - warp0;
  const int lane = threadIdx.x % 32;
  const int bp = padded(b);
  for (int i0 = row0 + w; i0 < bp; i0 += 2 * nw) {
    T v[2][kC];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int i = i0 + r * nw, k = lane + 32 * c;
        v[r][c] = i < bp && k <= i
                      ? (i < b ? a[static_cast<size_t>(i) * lda + k] : T(k == i ? 1 : 0))
                      : T(0);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int i = i0 + r * nw, k = lane + 32 * c;
        if (i < bp && k <= i) s[tri(i) + k] = v[r][c];
      }
  }
}

// One warp factors the 32×32 diagonal sub-block at (o, o) in place and
// into l11 (dense, row stride kLd): lane i keeps row i; the pivot reaches
// the lanes by a shuffle, column k through shared memory (two buffers of
// col, one barrier a step), read four entries a load; the next pivot's
// entry is updated and its root taken before the rest of the column. Then
// col holds the pivots' reciprocals, for the rows below.
//
// kOwnPivot: the next pivot needs only its own lane's entry of column k
// (a_{k+1,k+1} − l_{k+1,k}²), so its root is taken and shuffled before the
// column's trip through shared memory, with the same bits. It is on in
// load_factor_ahead, where other warps compete for the chain's scheduler,
// and off in factor_blocked, whose chain runs alone (blocked.cu's diagonal
// step was slower with it: PERF.md).
template <bool kOwnPivot, class T>
__device__ __forceinline__ void factor_sub_block(T* s, T* col, T* l11, int o) {
  const int lane = threadIdx.x % 32;
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
    T next = T(0);
    if constexpr (kOwnPivot)   // lane k + 1's own update: the fma below gives it the same bits
      next = afl::sqrt_(__shfl_sync(0xffffffffu, afl::fma_(-a[k], a[k], a[k + 1]), k + 1));
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
    if constexpr (kOwnPivot) pv = next;
    else pv = afl::sqrt_(__shfl_sync(0xffffffffu, a[k + 1], k + 1));
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
  col[lane] = T(1) / l11[lane * kLd + lane];
}

// The n rows below the diagonal sub-block at (o, o): x = A21 row · L11⁻ᵀ
// by forward substitution, one thread a row (right-looking: x_c is final
// once scaled by the reciprocal of L11[c][c] in col, each one IEEE
// division of the diagonal's lane, as LAPACK's dpotf2 scales), into place
// and into the dense copy l21.
template <int kThreads, class T>
__device__ __forceinline__ void solve_below(T* s, const T* col, const T* l11, T* l21, int o,
                                            int n) {
  const int e = o + kSub;
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
}

// The rank-32 update of kR rows of the trailing triangle at (e, e), n
// wide: s[e + i][e + j] −= Σ_k l21[i][k] · l21[j][k] for i = i0..i0+kR−1
// and j = lane + 32·m, m0 <= m < m0 + kC, on and below the diagonal (a
// lane a column of each chunk of 32, in registers). A chunk past the rows'
// diagonal or past n is read as zeros and not stored. Each entry's sum
// runs over k in order, whichever warp takes it.
template <int kC, int kR = 4, class T>
__device__ __forceinline__ void update_rows(T* s, const T* l21, int e, int n, int i0, int m0) {
  const int lane = threadIdx.x % 32;
  T acc[kR][kC];
#pragma unroll
  for (int ii = 0; ii < kR; ++ii)
#pragma unroll
    for (int m = 0; m < kC; ++m) acc[ii][m] = T(0);
#pragma unroll 4
  for (int k = 0; k < kSub; ++k) {
    T av[kR], bv[kC];
#pragma unroll
    for (int ii = 0; ii < kR; ++ii) av[ii] = l21[(i0 + ii) * kLd + k];
#pragma unroll
    for (int m = 0; m < kC; ++m) {
      const int j = lane + 32 * (m0 + m);
      bv[m] = 32 * (m0 + m) <= i0 + kR - 1 && j < n ? l21[j * kLd + k] : T(0);
    }
#pragma unroll
    for (int ii = 0; ii < kR; ++ii)
#pragma unroll
      for (int m = 0; m < kC; ++m) acc[ii][m] = afl::fma_(av[ii], bv[m], acc[ii][m]);
  }
#pragma unroll
  for (int ii = 0; ii < kR; ++ii)
#pragma unroll
    for (int m = 0; m < kC; ++m) {
      const int j = lane + 32 * (m0 + m);
      if (j <= i0 + ii) {
        T* dst = s + tri(e + i0 + ii) + e + j;
        *dst = *dst - acc[ii][m];
      }
    }
}

// update_rows over c chunks from m0, 1 <= c <= kC: one register block for
// each count, so a row near the top spends nothing on the chunks right of
// its diagonal.
template <int kC, int kR, class T>
__device__ __forceinline__ void update_rows_upto(int c, T* s, const T* l21, int e, int n,
                                                 int i0, int m0) {
  if constexpr (kC > 1) {
    if (c < kC) {
      update_rows_upto<kC - 1, kR>(c, s, l21, e, n, i0, m0);
      return;
    }
  }
  update_rows<kC, kR>(s, l21, e, n, i0, m0);
}

// Cholesky factor of the packed (bp, bp) SPD triangle s, bp <= kWidth, in
// place; work (16-byte aligned) holds kFactorWork<kWidth> values. Starts
// and ends with a block barrier. Per sub-panel of 32 columns at o: warp 0
// factors the diagonal sub-block (factor_sub_block); the block solves the
// rows below it (solve_below); the block applies the rank-32 update to the
// trailing triangle (update_rows, a warp four rows and every chunk of
// them). Three barriers a sub-panel.
template <int kThreads, int kWidth, class T>
__device__ void factor_blocked(T* s, T* work, int bp) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kChunks = (kWidth - kSub) / 32;    // column chunks of a trailing row
  static_assert(kWidth % kSub == 0 && kChunks >= 1, "a width of two sub-blocks or more");
  const int warp = threadIdx.x / 32;
  T* col = work;                // two buffers of a column, then the reciprocals
  T* l11 = work + 2 * kSub;     // the diagonal sub-block, dense, row stride kLd
  T* l21 = l11 + kSub * kLd;    // the rows below it, dense, row stride kLd
  __syncthreads();
  for (int o = 0; o < bp; o += kSub) {
    if (warp == 0) factor_sub_block<false>(s, col, l11, o);
    __syncthreads();
    const int e = o + kSub;
    const int n = bp - e;
    solve_below<kThreads>(s, col, l11, l21, o, n);
    __syncthreads();
    for (int i0 = 4 * warp; i0 < n; i0 += 4 * kWarps) update_rows<kChunks>(s, l21, e, n, i0, 0);
    __syncthreads();
  }
}

// Loads a (b, b) SPD block with row stride lda into the packed triangle
// s, padded to bp = padded(b) <= kWidth, and factors it in place as
// factor_blocked does, with a look-ahead that takes warp 0's chains of
// pivots off the update's path; work as factor_blocked's. Ends with a
// block barrier.
//   * Warp 0 loads the first diagonal sub-block and factors it while the
//     other warps load the rows below (load_rows).
//   * Per sub-panel at o: the block solves the rows below the diagonal
//     sub-block; eight warps update the next diagonal sub-block, four
//     rows each; then warp 0 factors it while the warps off its scheduler
//     (warp % 4 != 0, so that nothing competes with its chain for issue)
//     apply the rest of the rank-32 update, eight rows a warp over only
//     the chunks up to their diagonal.
// Three barriers a sub-panel, as factor_blocked takes, and every entry
// gets the sum factor_blocked gives it: the same bits. mark: see marks.
template <int kThreads, int kWidth, class T, class Marks = NoMarks>
__device__ void load_factor_ahead(const T* __restrict__ a, int lda, int b, T* s, T* work,
                                  const Marks& mark = Marks{}) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kChunks = (kWidth - kSub) / 32;
  constexpr int kUpdaters = kWarps - kWarps / 4;   // the warps off warp 0's scheduler
  static_assert(kWidth % kSub == 0 && kChunks >= 1 && kWarps % 4 == 0 && kWarps >= 8,
                "two sub-blocks or more; warps in fours, eight at least");
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bp = padded(b);
  T* col = work;
  T* l11 = work + 2 * kSub;
  T* l21 = l11 + kSub * kLd;
  if (warp == 0) {
    T v[kSub];   // rows 0..31, a lane a column
#pragma unroll
    for (int i = 0; i < kSub; ++i)
      v[i] = lane <= i ? (i < b ? a[static_cast<size_t>(i) * lda + lane] : T(lane == i ? 1 : 0))
                       : T(0);
#pragma unroll
    for (int i = 0; i < kSub; ++i)
      if (lane <= i) s[tri(i) + lane] = v[i];
    __syncwarp();
  } else {
    load_rows<kThreads, kWidth>(a, lda, b, s, kSub, 1);
  }
  // o = −kSub: warp 0's chain on the first sub-block beside the load; one
  // call site, so that the chain's unrolled code is one copy (fetched once
  // when the kernel starts with its code out of the caches, as in the
  // streamed factor, where other kernels run between two panels)
  for (int o = -kSub; o + kSub < bp; o += kSub) {
    const int e = o + kSub;
    const int n = bp - e;
    if (o >= 0) {
      solve_below<kThreads>(s, col, l11, l21, o, n);
      __syncthreads();
      mark(marks::step(o, 0));
      if (warp < kSub / 4) update_rows<1>(s, l21, e, n, 4 * warp, 0);
      __syncthreads();
      mark(marks::step(o, 1));
    }
    if (warp == 0) {
      factor_sub_block<true>(s, col, l11, e);
      if (o >= 0) mark(marks::step(o, 2));
    } else if (o >= 0 && warp % 4 != 0) {
      for (int i0 = kSub + 8 * (warp - warp / 4 - 1); i0 < n; i0 += 8 * kUpdaters)
        update_rows_upto<kChunks, 8>(i0 / kSub + 1, s, l21, e, n, i0, 0);
      mark(marks::step(o, 3));
    }
    __syncthreads();
    if (o < 0) mark(marks::kLoaded);
  }
  mark(marks::kFactored);
}

}  // namespace afl_tri
