// Blocked Cholesky, batched triangular solve and the fused γ sweep of
// systems narrower than the streamed path's 2048, in f32 and in f64 (one
// template, instantiated twice):
//
//   blocked_cholesky   a (m, d, d) SPD                  ->  L (m, d, d)
//   cholesky_solve     L (m, d, d), b (m, d, c)         ->  x, L Lᵀ x = b
//   multi_gamma_solve  C (d, d), Q (d, c), γ (n_g,)     ->  W (n_g, d, c),
//                                                           (C + γ_j I) W_j = Q
//
// They replace the Pallas TPU kernels blocked_cholesky, cholesky_solve and
// multi_gamma_solve of src/repro/kernels/solve.py, which are one algorithm
// there: _factor_panels (a right-looking blocked Cholesky over panels of
// 128, each diagonal block factored and inverted by column loops, trsm and
// trailing update as tile products) and _solve_panels (forward and
// backward substitution as products with the inverse diagonal blocks).
// Only the lower triangle of a, L and C is read. L comes back with an
// exact-zero upper triangle. A system that is not positive definite gives
// NaN (sqrt of a negative pivot) and leaves the other systems alone: every
// product is a plain FMA in the input's type (no TF32, no mma; the f64
// instances use the card's native FP64), sqrt and division are IEEE and no
// pivot is clamped. No sum uses atomics, and every sum runs in a fixed
// order: the same input gives the same bits.
//
// Design: every step is a grid over the whole card, for all systems of the
// call at once, and one host loop (one ctypes call) makes the launches on
// the caller's stream. Separate launches were chosen over one persistent
// cooperative grid: the kernel boundary is the grid-wide barrier the panel
// order needs, each launch takes the block shape and shared memory its step
// wants (a diagonal step 49 KB in f32 on one block a system, the tile grids
// 8.7 KB on hundreds), and no grid-wide barrier or ready flag has to be
// written or kept deadlock-free. What it costs is a launch's gap a step;
// fusing steps (and look-ahead, the next diagonal block beside this panel's
// trailing tiles) is later work.
//
// The factor (blocked_cholesky, and the sweep's factor of every γ), for
// each panel of 128 columns:
//   * chol_diag_kernel, one block of 256 threads a system: the diagonal
//     block is factored by factor_blocked and inverted by invert_blocked
//     (tri_blocked.cuh: warp-level 32-wide sub-blocks, a few barriers a
//     sub-panel or a merge level); L11 goes into place, Z11 to a scratch:
//     one (128, 128) slot a system for blocked_cholesky, which skips the
//     last panel's inverse, and one a panel for the sweep, whose solve
//     takes every inverse from there;
//   * chol_trsm_kernel, a grid of 64×64 output tiles × systems: L21 =
//     A21 · Z11ᵀ into the per-system (d, 128) scratch panel (A21 is still
//     read there);
//   * chol_trailing_kernel, a grid of only the lower triangle's 64×64
//     tiles × systems (253 at the first panel of d = 1536, 595 × 16 γs at
//     d = 2304): A22 −= L21 · L21ᵀ; the diagonal tile of each row of tiles
//     also copies its rows of L21 into place and writes zeros into their
//     mirror above the diagonal.
// The first panel reads its source where it lies, at a stride a system
// that is 0 for the sweep: every γ reads the one C, and no copy of C + γI
// is made. The sweep's γ_j joins at that first panel only: the diagonal
// kernel adds it to the diagonal as it loads, and the trailing kernel
// writes a diagonal entry of A22 as (a + γ_j) − v, the rounding of a work
// matrix C + γ_j I. Later panels read the output. Every entry above the
// diagonal of the output is written as zero by a diagonal block's store or
// a mirror. 3·⌈d/128⌉ − 2 launches (34 at d = 1536).
//
// The solve (cholesky_solve, and the sweep after its factor), the algebra
// of _solve_panels on a right-looking schedule: with Z_p the inverse of
// diagonal block p,
//   * forward, for each panel p: y_p = Z_p · r_p over the panel's 64-row
//     tiles (forward_apply_kernel), then r_{>p} −= L_{>p,p} · y_p over
//     every 64-row tile below it (forward_update_kernel); r is b at the
//     first panel, read in place (at stride 0 for the sweep's Q), and the
//     running right-hand side in x after it;
//   * backward, mirrored, for p from the last panel down: x_p = Z_pᵀ · s_p,
//     then s_{<p} −= L_{p,<p}ᵀ · x_p, with s the forward result y, updated
//     in place.
// Each tile is 64 rows × 16 right-hand-side columns of one system (more
// columns take more tiles), one thread a row and four columns, 32 steps of
// the reduction staged in shared memory at a time. cholesky_solve first
// inverts every diagonal block at once, a grid of ⌈d/128⌉ blocks × systems
// running invert_blocked (the sweep has its inverses from the factor).
// 2·(2·⌈d/128⌉ − 1) substitution launches (46 at d = 1536), and one more
// for cholesky_solve's inverses.
//
// Bound at the path's shapes (d³/3 flops a factor, 2d²c a solve; each input
// read once, of a, L and C only the lower triangle, and each output written
// once; 67 TFLOP/s f32, 3.35 TB/s): blocked_cholesky (1, 1536) 1.21 GFLOP =
// 18 us against 14.2 MB = 4.2 us, operations; cholesky_solve (1, 1536, 16)
// 75.5 MFLOP = 1.1 us against 4.9 MB = 1.5 us, bytes; multi_gamma_solve
// (2304, 16, 16 γs) 68.0 GFLOP = 1.01 ms against 13.1 MB = 3.9 us,
// operations. The factor's critical path is its diagonal blocks, one after
// the other on one SM a system, and its launches; its flops run on the
// tile grids. The solve is a chain of 2·(2·⌈d/128⌉ − 1) small steps: its
// launches bound it, not its bytes.
//
// precision "f32_x2" (the reference's _make_mm split products, f32 only):
// instances of the trsm, trailing and substitution kernels (template flag
// X2) whose staging splits each operand value into exact 12-bit halves
// (afl::split: tile_gemm.cuh's Split, sub_tile's two planes) and whose
// threads keep three FMA sums an output, hh + (hl + lh) at the epilogue:
// trail − (hh + (hl + lh)), and (a + γ_j) − (hh + (hl + lh)) on the
// sweep's first trailing diagonal. The diagonal kernels stay native, as
// the reference's _factor_tile and _tri_inv_tile do; the schedule and its
// launches are the same. Entry points afl_<kernel>_f32x2. The bound
// counts the three products' flops: 3× the native rows'.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libblocked.so blocked.cu
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns a CUDA error code (0 on success). Scratch
// of the input's type: blocked_cholesky zs (m, 128, 128) and panels
// (m, d, 128); cholesky_solve zs (m, ⌈d/128⌉, 128, 128) and y (m, d, c);
// multi_gamma_solve the factors (n_g, d, d), zs (n_g, ⌈d/128⌉, 128, 128),
// panels (n_g, d, 128) and y (n_g, d, c).

#include <cuda_runtime.h>

#include <cstddef>

#include "tile_gemm.cuh"
#include "tri_blocked.cuh"

namespace {

using afl::fma_;
using afl_tile::kLoadsPerThread;
using afl_tile::kStep;
using afl_tile::kThreads;   // 256: the tile loop's block, and every kernel's here
using afl_tile::kTile;
using afl_tri::tri;

constexpr int kPanel = 128;                    // panel width (DEFAULT_BLOCK)
constexpr int kPanelValues = kPanel * kPanel;
// The diagonal kernels' dynamic shared memory: the packed triangle and the
// scratch of factor_blocked and invert_blocked (49 KB in f32, 98 KB in f64)
constexpr int kDiagValues = kPanel * (kPanel + 1) / 2 + afl_tri::kScratchValues<kPanel>;

// A substitution tile: kRows rows × kCols right-hand-side columns, the
// reduction staged kK indices at a time
constexpr int kRows = 64;
constexpr int kCols = 16;
constexpr int kK = 32;
static_assert(kThreads == kRows * kCols / 4, "one thread a row and four columns");

__device__ __forceinline__ size_t at(int row, int col, int ld) {
  return static_cast<size_t>(row) * ld + col;
}

__host__ __device__ __forceinline__ int panels_of(int d) { return (d + kPanel - 1) / kPanel; }

// The inverse diagonal block of panel p of system sys: one slot a system,
// or one a panel when every inverse is kept.
template <class T>
__device__ __forceinline__ T* z_slot(T* zs, size_t sys, int p, int d, bool keep_all) {
  return zs + (keep_all ? sys * panels_of(d) + p : sys) * kPanelValues;
}

// --- the factor: a panel schedule over all SMs ---------------------------------
//
// Per panel [o, e) of every system, three launches: the diagonal block (one
// block a system), the trsm L21 = A21 · Z11ᵀ (64×64 tiles × systems) and the
// trailing update A22 −= L21 · L21ᵀ (the lower triangle's tiles × systems).
// src is the input at the first panel, at src_stride values a system (0
// when every system reads one matrix), and the output after it. gammas is
// non-null at the first panel of the sweep only.

// The diagonal block at (o, o), plus γ_sys on its diagonal where gammas is
// given: factored and stored as L11 (zeros above its diagonal) by
// factor_blocked; inverted by invert_blocked into the system's slot of zs
// (zeros above) unless it is the last panel and not every inverse is kept.
template <class T>
__global__ void __launch_bounds__(kThreads)
chol_diag_kernel(const T* src, size_t src_stride, const T* gammas, T* out, T* zs,
                 bool keep_all, int d, int o) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  T* scratch = s + kPanel * (kPanel + 1) / 2;
  const size_t sys = blockIdx.x;
  const size_t dd = static_cast<size_t>(d) * d;
  const int bw = min(kPanel, d - o);
  const int bp = afl_tri::padded(bw);
  afl_tri::load_lower_padded<kThreads>(src + sys * src_stride + at(o, o, d), d, bw, s);
  if (gammas != nullptr) {
    __syncthreads();
    const T g = gammas[sys];
    for (int i = threadIdx.x; i < bw; i += kThreads) s[tri(i) + i] += g;
  }
  afl_tri::factor_blocked<kThreads, kPanel>(s, scratch, bp);   // starts with a barrier
  afl_tri::store_lower<kThreads>(s, bw, out + sys * dd + at(o, o, d), d);
  if (keep_all || o + bw < d) {
    afl_tri::invert_blocked<kThreads>(s, scratch, bp);   // after a barrier: the store has read s
    afl_tri::store_lower<kThreads>(s, bw, z_slot(zs, sys, o / kPanel, d, keep_all), kPanel);
  }
}

// L21 = A21 · Z11ᵀ into the system's (d, kPanel) scratch panel: one 64×64
// tile (blockIdx.y rows, blockIdx.x columns) of system blockIdx.z.
template <class T, bool X2>
__global__ void __launch_bounds__(kThreads)
chol_trsm_kernel(const T* src, size_t src_stride, const T* zs, bool keep_all, T* panels,
                 int d, int o) {
  const size_t sys = blockIdx.z;
  const T* w = src + sys * src_stride;
  const T* z = z_slot(zs, sys, o / kPanel, d, keep_all);
  T* panel = panels + sys * d * kPanel;
  const int bw = min(kPanel, d - o);
  const int e = o + bw;
  const int t = d - e;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  afl_tile::tile_gemm<T, X2>(
      bw,
      [=](auto a_tile, auto b_tile, int k0) {
#pragma unroll
        for (int l = 0; l < kLoadsPerThread; ++l) {
          const int idx = threadIdx.x + l * kThreads;
          const int r = idx / kStep;
          const int kk = idx % kStep;
          const int col = k0 + kk;
          a_tile.put(kk, r, (i0 + r < t && col < bw) ? w[at(e + i0 + r, o + col, d)] : T(0));
          const int zr = j0 + r;
          b_tile.put(kk, r, (zr < bw && col <= zr) ? z[at(zr, col, kPanel)] : T(0));
        }
      },
      [=](int r, int c, T v) {
        if (i0 + r < t && j0 + c < bw) panel[at(i0 + r, j0 + c, kPanel)] = v;
      });
}

// One lower tile of A22 −= L21 · L21ᵀ (read from src, written to out), a
// diagonal entry (a + γ_sys) − v where gammas is given: tile blockIdx.x of
// the lower triangle's, row by row, of system blockIdx.y. The diagonal tile
// of each row of tiles then copies those rows of L21 into place, and zeros
// into their mirror above the diagonal.
template <class T, bool X2>
__global__ void __launch_bounds__(kThreads)
chol_trailing_kernel(const T* src, size_t src_stride, const T* gammas, T* out,
                     const T* panels, int d, int o) {
  const size_t sys = blockIdx.y;
  const T* a = src + sys * src_stride;
  T* w = out + sys * d * d;
  const T* panel = panels + sys * d * kPanel;
  const T g = gammas != nullptr ? gammas[sys] : T(0);
  const int bw = min(kPanel, d - o);
  const int e = o + bw;
  const int t = d - e;
  const int x = blockIdx.x;
  int ti = static_cast<int>((sqrtf(8.0f * x + 1.0f) - 1.0f) * 0.5f);
  while (ti * (ti + 1) / 2 > x) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= x) ++ti;
  const int tj = x - ti * (ti + 1) / 2;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  afl_tile::tile_gemm<T, X2>(
      bw,
      [=](auto a_tile, auto b_tile, int k0) {
#pragma unroll
        for (int l = 0; l < kLoadsPerThread; ++l) {
          const int idx = threadIdx.x + l * kThreads;
          const int r = idx / kStep;
          const int kk = idx % kStep;
          const int col = k0 + kk;
          a_tile.put(kk, r, (i0 + r < t && col < bw) ? panel[at(i0 + r, col, kPanel)] : T(0));
          b_tile.put(kk, r, (j0 + r < t && col < bw) ? panel[at(j0 + r, col, kPanel)] : T(0));
        }
      },
      [=](int r, int c, T v) {
        const int row = i0 + r;
        const int col = j0 + c;
        if (row >= t || col > row) return;
        const T entry = a[at(e + row, e + col, d)];
        w[at(e + row, e + col, d)] = (gammas != nullptr && row == col ? entry + g : entry) - v;
      });
  if (ti != tj) return;
  const int rows = min(kTile, t - i0);
  for (int idx = threadIdx.x; idx < rows * bw; idx += kThreads) {
    const int r = idx / bw;
    const int c = idx % bw;
    w[at(e + i0 + r, o + c, d)] = panel[at(i0 + r, c, kPanel)];
  }
  for (int idx = threadIdx.x; idx < rows * bw; idx += kThreads) {
    const int c = idx / rows;
    const int r = idx % rows;
    w[at(o + c, e + i0 + r, d)] = T(0);
  }
}

// --- the solve: a substitution spread over all SMs -----------------------------

// Every diagonal block of the factors l inverted into zs (one slot a
// panel): block (blockIdx.x panel, blockIdx.y system).
template <class T>
__global__ void __launch_bounds__(kThreads)
solve_inverse_kernel(const T* l, T* zs, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  T* scratch = s + kPanel * (kPanel + 1) / 2;
  const size_t sys = blockIdx.y;
  const int o = blockIdx.x * kPanel;
  const int bw = min(kPanel, d - o);
  afl_tri::load_lower_padded<kThreads>(l + sys * d * d + at(o, o, d), d, bw, s);
  afl_tri::invert_blocked<kThreads>(s, scratch, afl_tri::padded(bw));   // barriers at both ends
  afl_tri::store_lower<kThreads>(s, bw, z_slot(zs, sys, blockIdx.x, d, true), kPanel);
}

// One substitution tile: out (rows <= kRows, cols <= kCols) = A (rows, k) ·
// Y (k, cols), each sum handed to store(i, j, value). a_at(i, kk) and
// y_at(kk, j) read the operands; kATransposed says that neighbouring i
// (rather than kk) are neighbouring addresses of A, so the staging reads
// stay coalesced. Thread t owns row t / 4 and columns 4·(t % 4) .. +3; its
// sums run over k in order. X2 (f32): each staged value split into a hi
// and a lo plane, three sums an output (afl::Sums), store gets
// hh + (hl + lh).
template <bool kATransposed, class T, bool X2, class AAt, class YAt, class Store>
__device__ __forceinline__ void sub_tile(int rows, int cols, int k, AAt a_at, YAt y_at,
                                         Store store) {
  static_assert(!X2 || sizeof(T) == 4, "the split products are f32 only");
  constexpr int kPlanes = X2 ? 2 : 1;
  __shared__ T sa[kPlanes][kK][kRows + 1];
  __shared__ __align__(16) T sy[kPlanes][kK][kCols];
  const int r = threadIdx.x / 4;
  const int q = 4 * (threadIdx.x % 4);
  afl::Sums<T, X2> acc[4];
  for (int k0 = 0; k0 < k; k0 += kK) {
#pragma unroll
    for (int l = 0; l < kK * kRows / kThreads; ++l) {
      const int e = threadIdx.x + l * kThreads;
      const int kk = kATransposed ? e / kRows : e % kK;
      const int i = kATransposed ? e % kRows : e / kK;
      const T v = (i < rows && k0 + kk < k) ? a_at(i, k0 + kk) : T(0);
      if constexpr (X2) afl::split(v, sa[0][kk][i], sa[1][kk][i]);
      else sa[0][kk][i] = v;
    }
#pragma unroll
    for (int l = 0; l < kK * kCols / kThreads; ++l) {
      const int e = threadIdx.x + l * kThreads;
      const int kk = e / kCols;
      const int j = e % kCols;
      const T v = (k0 + kk < k && j < cols) ? y_at(k0 + kk, j) : T(0);
      if constexpr (X2) afl::split(v, sy[0][kk][j], sy[1][kk][j]);
      else sy[0][kk][j] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      // the hi halves (native: the values), and X2's lo halves
      const T a = sa[0][kk][r];
      T al = T(0), yv[4], yl[4] = {};
      afl::load4(&sy[0][kk][q], yv);
      if constexpr (X2) {
        al = sa[1][kk][r];
        afl::load4(&sy[1][kk][q], yl);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[t].add(a, al, yv[t], yl[t]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (r < rows && q + t < cols) store(r, q + t, acc[t].sum());
}

// Each substitution kernel takes tile (blockIdx.x of 64 rows, blockIdx.y of
// 16 columns) of system blockIdx.z, for panel p = [o, e).
struct Step {
  int o, e, i0, j0;
  size_t sys;
};

__device__ __forceinline__ Step step_of(int d, int p) {
  Step s;
  s.o = p * kPanel;
  s.e = min(s.o + kPanel, d);
  s.i0 = blockIdx.x * kRows;
  s.j0 = blockIdx.y * kCols;
  s.sys = blockIdx.z;
  return s;
}

// Forward: y_p = Z_p · r_p, r at r_stride values a system.
template <class T, bool X2>
__global__ void __launch_bounds__(kThreads)
forward_apply_kernel(const T* zs, const T* r, size_t r_stride, T* y, int d, int c, int p) {
  const Step s = step_of(d, p);
  const T* z = z_slot(zs, s.sys, p, d, true);
  const T* rs = r + s.sys * r_stride + at(s.o, s.j0, c);
  T* ys = y + s.sys * d * c + at(s.o + s.i0, s.j0, c);
  sub_tile<false, T, X2>(
      min(kRows, s.e - s.o - s.i0), min(kCols, c - s.j0), s.e - s.o,
      [=](int i, int k) { return z[at(s.i0 + i, k, kPanel)]; },
      [=](int k, int j) { return rs[at(k, j, c)]; },
      [=](int i, int j, T v) { ys[at(i, j, c)] = v; });
}

// Forward: x_{>p} = r_{>p} − L_{>p,p} · y_p, the rows below the panel.
template <class T, bool X2>
__global__ void __launch_bounds__(kThreads)
forward_update_kernel(const T* l, const T* y, const T* r, size_t r_stride, T* x, int d, int c,
                      int p) {
  const Step s = step_of(d, p);
  const int row0 = s.e + s.i0;
  const T* ls = l + s.sys * d * d + at(row0, s.o, d);
  const T* ys = y + s.sys * d * c + at(s.o, s.j0, c);
  const T* rs = r + s.sys * r_stride + at(row0, s.j0, c);
  T* xs = x + s.sys * d * c + at(row0, s.j0, c);
  sub_tile<false, T, X2>(
      min(kRows, d - row0), min(kCols, c - s.j0), s.e - s.o,
      [=](int i, int k) { return ls[at(i, k, d)]; },
      [=](int k, int j) { return ys[at(k, j, c)]; },
      [=](int i, int j, T v) { xs[at(i, j, c)] = rs[at(i, j, c)] - v; });
}

// Backward: x_p = Z_pᵀ · y_p.
template <class T, bool X2>
__global__ void __launch_bounds__(kThreads)
backward_apply_kernel(const T* zs, const T* y, T* x, int d, int c, int p) {
  const Step s = step_of(d, p);
  const T* z = z_slot(zs, s.sys, p, d, true);
  const T* ys = y + s.sys * d * c + at(s.o, s.j0, c);
  T* xs = x + s.sys * d * c + at(s.o + s.i0, s.j0, c);
  sub_tile<true, T, X2>(
      min(kRows, s.e - s.o - s.i0), min(kCols, c - s.j0), s.e - s.o,
      [=](int i, int k) { return z[at(k, s.i0 + i, kPanel)]; },
      [=](int k, int j) { return ys[at(k, j, c)]; },
      [=](int i, int j, T v) { xs[at(i, j, c)] = v; });
}

// Backward: y_{<p} −= L_{p,<p}ᵀ · x_p, the rows above the panel, in place.
template <class T, bool X2>
__global__ void __launch_bounds__(kThreads)
backward_update_kernel(const T* l, const T* x, T* y, int d, int c, int p) {
  const Step s = step_of(d, p);
  const T* ls = l + s.sys * d * d + at(s.o, s.i0, d);
  const T* xs = x + s.sys * d * c + at(s.o, s.j0, c);
  T* ys = y + s.sys * d * c + at(s.i0, s.j0, c);
  sub_tile<true, T, X2>(
      min(kRows, s.o - s.i0), min(kCols, c - s.j0), s.e - s.o,
      [=](int i, int k) { return ls[at(k, i, d)]; },
      [=](int k, int j) { return xs[at(k, j, c)]; },
      [=](int i, int j, T v) { ys[at(i, j, c)] = ys[at(i, j, c)] - v; });
}

// --- host loops ----------------------------------------------------------------

template <class Kernel>
int prepare(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <class T>
constexpr int kDiagBytes = kDiagValues * static_cast<int>(sizeof(T));

#define AFL_LAUNCHED()                                              \
  do {                                                              \
    if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err); \
  } while (0)

// The factors of m systems into out, the inverse diagonal blocks into zs:
// the first panel reads a at a_stride values a system and adds gammas (if
// not null) to the diagonal. X2: the split products.
template <class T, bool X2>
int factor(const T* a, size_t a_stride, const T* gammas, T* out, T* zs, bool keep_all,
           T* panels, int m, int d, cudaStream_t st) {
  if (int err = prepare(chol_diag_kernel<T>, kDiagBytes<T>)) return err;
  const size_t dd = static_cast<size_t>(d) * d;
  for (int o = 0; o < d; o += kPanel) {
    const T* src = o == 0 ? a : out;
    const size_t stride = o == 0 ? a_stride : dd;
    const T* g = o == 0 ? gammas : nullptr;
    const int e = min(o + kPanel, d);
    const int nt = (d - e + kTile - 1) / kTile;
    chol_diag_kernel<T><<<m, kThreads, kDiagBytes<T>, st>>>(src, stride, g, out, zs, keep_all,
                                                            d, o);
    AFL_LAUNCHED();
    if (nt > 0) {
      chol_trsm_kernel<T, X2><<<dim3((e - o + kTile - 1) / kTile, nt, m), kThreads, 0, st>>>(
          src, stride, zs, keep_all, panels, d, o);
      AFL_LAUNCHED();
      chol_trailing_kernel<T, X2><<<dim3(nt * (nt + 1) / 2, m), kThreads, 0, st>>>(
          src, stride, g, out, panels, d, o);
      AFL_LAUNCHED();
    }
  }
  return 0;
}

// L Lᵀ x = b for m factors l with their inverse diagonal blocks in zs (one
// slot a panel): b at
// b_stride values a system (read in place), y a (m, d, c) scratch.
template <class T, bool X2>
int substitute(const T* l, const T* zs, const T* b, size_t b_stride, T* y, T* x, int m, int d,
               int c, cudaStream_t st) {
  const int n = panels_of(d);
  const int chunks = (c + kCols - 1) / kCols;
  const size_t dc = static_cast<size_t>(d) * c;
  auto tiles = [](int rows) { return (rows + kRows - 1) / kRows; };
  for (int p = 0; p < n; ++p) {
    const int o = p * kPanel;
    const int e = min(o + kPanel, d);
    const T* r = p == 0 ? b : x;
    const size_t r_stride = p == 0 ? b_stride : dc;
    forward_apply_kernel<T, X2><<<dim3(tiles(e - o), chunks, m), kThreads, 0, st>>>(
        zs, r, r_stride, y, d, c, p);
    AFL_LAUNCHED();
    if (e < d) {
      forward_update_kernel<T, X2><<<dim3(tiles(d - e), chunks, m), kThreads, 0, st>>>(
          l, y, r, r_stride, x, d, c, p);
      AFL_LAUNCHED();
    }
  }
  for (int p = n - 1; p >= 0; --p) {
    const int o = p * kPanel;
    const int e = min(o + kPanel, d);
    backward_apply_kernel<T, X2><<<dim3(tiles(e - o), chunks, m), kThreads, 0, st>>>(
        zs, y, x, d, c, p);
    AFL_LAUNCHED();
    if (o > 0) {
      backward_update_kernel<T, X2><<<dim3(tiles(o), chunks, m), kThreads, 0, st>>>(l, x, y, d, c,
                                                                                 p);
      AFL_LAUNCHED();
    }
  }
  return 0;
}

template <class T, bool X2>
int blocked_cholesky(const void* a, void* out, void* zs, void* panels, int m, int d,
                     void* stream) {
  return factor<T, X2>(static_cast<const T*>(a), static_cast<size_t>(d) * d, nullptr,
                   static_cast<T*>(out), static_cast<T*>(zs), false, static_cast<T*>(panels), m,
                   d, static_cast<cudaStream_t>(stream));
}

template <class T, bool X2>
int cholesky_solve(const void* l, const void* b, void* x, void* zs, void* y, int m, int d,
                   int c, void* stream) {
  if (int err = prepare(solve_inverse_kernel<T>, kDiagBytes<T>)) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* lm = static_cast<const T*>(l);
  T* z = static_cast<T*>(zs);
  solve_inverse_kernel<T><<<dim3(panels_of(d), m), kThreads, kDiagBytes<T>, st>>>(lm, z, d);
  AFL_LAUNCHED();
  return substitute<T, X2>(lm, z, static_cast<const T*>(b), static_cast<size_t>(d) * c,
                       static_cast<T*>(y), static_cast<T*>(x), m, d, c, st);
}

template <class T, bool X2>
int multi_gamma_solve(const void* cm, const void* q, const void* gammas, void* factors,
                      void* zs, void* panels, void* y, void* w, int n_g, int d, int c,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* l = static_cast<T*>(factors);
  T* z = static_cast<T*>(zs);
  if (int err = factor<T, X2>(static_cast<const T*>(cm), 0, static_cast<const T*>(gammas), l, z,
                          true, static_cast<T*>(panels), n_g, d, st))
    return err;
  return substitute<T, X2>(l, z, static_cast<const T*>(q), 0, static_cast<T*>(y),
                       static_cast<T*>(w), n_g, d, c, st);
}

#undef AFL_LAUNCHED

}  // namespace

// One set of entry points for each type, _f32 and _f64, and one for the
// f32 split products, _f32x2.
#define AFL_BLOCKED_ENTRY_POINTS(T, SUFFIX, X2)                                         \
  extern "C" int afl_blocked_cholesky_##SUFFIX(const void* a, void* out, void* zs,      \
                                               void* panels, int m, int d,              \
                                               void* stream) {                          \
    return blocked_cholesky<T, X2>(a, out, zs, panels, m, d, stream);                   \
  }                                                                                     \
  extern "C" int afl_cholesky_solve_##SUFFIX(const void* l, const void* b, void* x,     \
                                             void* zs, void* y, int m, int d, int c,    \
                                             void* stream) {                            \
    return cholesky_solve<T, X2>(l, b, x, zs, y, m, d, c, stream);                      \
  }                                                                                     \
  extern "C" int afl_multi_gamma_solve_##SUFFIX(const void* cm, const void* q,          \
                                                const void* gammas, void* factors,      \
                                                void* zs, void* panels, void* y,        \
                                                void* w, int n_g, int d, int c,         \
                                                void* stream) {                         \
    return multi_gamma_solve<T, X2>(cm, q, gammas, factors, zs, panels, y, w, n_g, d, c, \
                                    stream);                                            \
  }

AFL_BLOCKED_ENTRY_POINTS(float, f32, false)
AFL_BLOCKED_ENTRY_POINTS(double, f64, false)
AFL_BLOCKED_ENTRY_POINTS(float, f32x2, true)
