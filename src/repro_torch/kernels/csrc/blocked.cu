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
// pivot is clamped.
//
// Design of cholesky_solve and multi_gamma_solve. As the TPU kernel is
// one pallas_call whose grid walks the systems, each is one launch whose
// blocks are the systems (the γs of the sweep): one block of 256 threads
// walks the panels of its system in device memory (for the sweep, in a
// per-γ copy of C + γ_j I that the wrapper allocates). A system of
// d = 1536 is 9.4 MB and stays in the 50 MB L2. Per panel of width
// b <= 128 (the last one ragged, masked where the reference pads with an
// identity tail):
//   * the diagonal block is loaded into shared memory as a packed lower
//     triangle (33 KB at b = 128), factored and inverted there by the
//     column loops of packed_tri.cuh, and L11 is written back; the sweep
//     keeps each inverse for its solve, as _factor_panels does;
//   * trsm L21 = A21 · Z11ᵀ and the trailing update A22 −= L21 · L21ᵀ run
//     as loops over 64×64 output tiles with the tile loop of tile_gemm.cuh.
//     L21 goes to a per-system (d, 128) scratch panel first, since A21 is
//     still being read, and is copied into place after. The trailing update
//     covers only the lower triangle's tiles: the d³/3 flops a factor needs.
// The solve inverts the diagonal blocks of L (cholesky_solve; the sweep has
// them), then runs the two substitutions panel by panel: each product of a
// (b, K) slab of L (or Z) with a (K, c) block of right-hand sides stages 32
// steps of K at a time in shared memory, one row per thread pair and eight
// columns per thread.
//
// Design of blocked_cholesky: the same right-looking panels, spread over
// the card. One host loop (one ctypes call) makes, for each panel of 128
// and for all m systems at once, three launches on the caller's stream:
//   * chol_diag_kernel, one block of 256 threads a system: the diagonal
//     block is factored by factor_blocked and inverted by invert_blocked
//     (tri_blocked.cuh: warp-level 32-wide sub-blocks, a few barriers a
//     sub-panel or a merge level, where the column loops take 2b); L11 goes
//     into place, Z11 to a per-system (128, 128) scratch. The last panel
//     skips the inverse;
//   * chol_trsm_kernel, a grid of 64×64 output tiles × systems: L21 =
//     A21 · Z11ᵀ into the per-system (d, 128) scratch panel (A21 is still
//     read there);
//   * chol_trailing_kernel, a grid of only the lower triangle's 64×64
//     tiles × systems (253 at the first panel of d = 1536, about two waves
//     over 132 SMs): A22 −= L21 · L21ᵀ; the diagonal tile of each row of
//     tiles also copies its rows of L21 into place and writes zeros into
//     their mirror above the diagonal.
// The first panel reads a where it lies and writes the output, so a is
// never copied and its upper triangle never read; every entry above the
// diagonal of the output is written as zero by a diagonal block's store or
// a mirror. 3·⌈d/128⌉ − 2 launches a call (34 at d = 1536). Separate
// launches were chosen over one persistent cooperative grid: the kernel
// boundary is the grid-wide barrier the panel order needs, each launch
// takes the block shape and shared memory its step wants (the diagonal
// step 49 KB in f32 on one block a system, the tile grids 8.7 KB on
// hundreds), and no grid-wide barrier has to be written or kept
// deadlock-free; look-ahead (the next diagonal block beside this panel's
// trailing tiles) is later work.
//
// Bound at the path's shapes (d³/3 flops a factor, 2d²c a solve; each input
// read once, of a, L and C only the lower triangle, and each output written
// once; 67 TFLOP/s f32, 3.35 TB/s): blocked_cholesky (1, 1536) 1.21 GFLOP =
// 18 us against 14.2 MB = 4.2 us, operations; cholesky_solve (1, 1536, 16)
// 75.5 MFLOP = 1.1 us against 4.9 MB = 1.5 us, bytes; multi_gamma_solve
// (2304, 16, 16 γs) 68.0 GFLOP = 1.01 ms against 13.1 MB = 3.9 us,
// operations. The factor's critical path is its 12 diagonal blocks, one
// after the other on one SM each, and 34 launches; its flops run on the
// tile grids. cholesky_solve and multi_gamma_solve use one SM per system
// (the sweep 16), with the column loops of the diagonal blocks (2b steps a
// panel, each behind a barrier) one after the other: spreading them over
// SMs and moving them onto tri_blocked.cuh is later work.
//
// Shared memory (kSmemValues values a block): 60.8 KB in f32, 121.6 KB in
// f64, under the 227 KB a block can take, so the f64 instances keep the
// panel width of 128 and the same schedule.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libblocked.so blocked.cu
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns a CUDA error code (0 on success).
// blocked_cholesky takes two scratches of the input's type: zs (m, 128,
// 128) and panels (m, d, 128).

#include <cuda_runtime.h>

#include <cstddef>

#include "packed_tri.cuh"
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
constexpr int kSolveK = 32;                    // K staged per step of a solve product
constexpr int kSolveCols = 16;                 // right-hand-side columns per pass
constexpr int kSolvePad = kPanel + 1;

// Dynamic shared memory, in values of the type: the packed triangle and a
// row or column of it, the tile loop's two staging buffers, the solve
// products' staging.
constexpr int kTriValues = kPanel * (kPanel + 1) / 2 + kPanel;   // 8384
constexpr int kStageValues = kStep * (kTile + afl_tile::kPad);            // 1088
constexpr int kSolveAValues = kSolveK * kSolvePad;                        // 4128
constexpr int kSolveYValues = kSolveK * kSolveCols;                       // 512
constexpr int kSmemValues = kTriValues + 2 * kStageValues + kSolveAValues + kSolveYValues;
template <class T>
constexpr int kSmemBytes = kSmemValues * static_cast<int>(sizeof(T));   // 60.8 / 121.6 KB
// blocked_cholesky's diagonal kernel: the packed triangle and the scratch
// of factor_blocked and invert_blocked (49 KB in f32, 98 KB in f64)
constexpr int kDiagValues = kPanel * (kPanel + 1) / 2 + afl_tri::kScratchValues<kPanel>;
static_assert(kTriValues % 4 == 0 && kStageValues % 4 == 0 && kSolveAValues % 4 == 0,
              "16-byte aligned staging buffers");
static_assert(kThreads == 2 * kPanel, "two threads for each row of a solve product");

template <class T>
struct Smem {
  T* tri;                     // packed lower triangle of a diagonal block
  T* buf;                     // kPanel values: a column or a row of it
  afl_tile::Stage<T> a_tile;
  afl_tile::Stage<T> b_tile;
  T* solve_a;                 // [kSolveK][kSolvePad]
  T* solve_y;                 // [kSolveK][kSolveCols]
};

template <class T>
__device__ Smem<T> carve(unsigned char* raw) {
  T* smem = reinterpret_cast<T*>(raw);
  Smem<T> s;
  s.tri = smem;
  s.buf = smem + kTriValues - kPanel;
  s.a_tile = reinterpret_cast<afl_tile::Stage<T>>(smem + kTriValues);
  s.b_tile = reinterpret_cast<afl_tile::Stage<T>>(smem + kTriValues + kStageValues);
  s.solve_a = smem + kTriValues + 2 * kStageValues;
  s.solve_y = s.solve_a + kSolveAValues;
  return s;
}

__device__ __forceinline__ size_t at(int row, int col, int ld) {
  return static_cast<size_t>(row) * ld + col;
}

// out (rows, cols) = A (rows, k) · Y (k, cols) for rows <= kPanel, the
// sums handed to store(i, j, value). a_at(i, kk) and y_at(kk, j) read the
// operands; kATransposed says that neighbouring i (rather than kk) are
// neighbouring addresses of A, so the staging reads stay coalesced. Each
// thread owns one row and eight of each pass's 16 columns; sums run over k
// in order.
template <bool kATransposed, class T, class AAt, class YAt, class Store>
__device__ void solve_product(int rows, int cols, int k, AAt a_at, YAt y_at,
                              Store store, const Smem<T>& sm) {
  const int i = threadIdx.x % kPanel;
  const int half = threadIdx.x / kPanel;
  for (int j0 = 0; j0 < cols; j0 += kSolveCols) {
    T acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = T(0);
    for (int k0 = 0; k0 < k; k0 += kSolveK) {
#pragma unroll 4
      for (int l = 0; l < kSolveK * kPanel / kThreads; ++l) {
        const int e = threadIdx.x + l * kThreads;
        const int kk = kATransposed ? e / kPanel : e % kSolveK;
        const int r = kATransposed ? e % kPanel : e / kSolveK;
        sm.solve_a[kk * kSolvePad + r] =
            (r < rows && k0 + kk < k) ? a_at(r, k0 + kk) : T(0);
      }
#pragma unroll
      for (int l = 0; l < kSolveK * kSolveCols / kThreads; ++l) {
        const int e = threadIdx.x + l * kThreads;
        const int kk = e / kSolveCols;
        const int jj = e % kSolveCols;
        sm.solve_y[kk * kSolveCols + jj] =
            (k0 + kk < k && j0 + jj < cols) ? y_at(k0 + kk, j0 + jj) : T(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kSolveK; ++kk) {
        const T a = sm.solve_a[kk * kSolvePad + i];
        T y0[4], y1[4];
        afl::load4(&sm.solve_y[kk * kSolveCols + half * 8], y0);
        afl::load4(&sm.solve_y[kk * kSolveCols + half * 8 + 4], y1);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[q] = fma_(a, y0[q], acc[q]);
          acc[q + 4] = fma_(a, y1[q], acc[q + 4]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + half * 8 + q;
      if (i < rows && j < cols) store(i, j, acc[q]);
    }
  }
}

// One panel's trsm and trailing update. The panel is columns [o, e) of the
// (d, d) system w; z is its inverse diagonal block, packed in shared
// memory; panel is a (d, kPanel) scratch.
template <class T>
__device__ void trsm_and_update(T* w, int d, int o, int e, const T* z,
                                T* panel, const Smem<T>& sm) {
  const int bw = e - o;
  const int t = d - e;
  // trsm: panel (t, bw) = A21 · Z11ᵀ, Z11 lower triangular in shared memory
  for (int i0 = 0; i0 < t; i0 += kTile)
    for (int j0 = 0; j0 < bw; j0 += kTile)
      afl_tile::tile_gemm<T>(
          bw, sm.a_tile, sm.b_tile,
          [=](afl_tile::Stage<T> a_tile, afl_tile::Stage<T> b_tile, int k0) {
#pragma unroll
            for (int l = 0; l < kLoadsPerThread; ++l) {
              const int idx = threadIdx.x + l * kThreads;
              const int r = idx / kStep;
              const int kk = idx % kStep;
              const int col = k0 + kk;
              a_tile[kk][r] = (i0 + r < t && col < bw) ? w[at(e + i0 + r, o + col, d)] : T(0);
              const int zr = j0 + r;
              b_tile[kk][r] = (zr < bw && col <= zr) ? z[tri(zr) + col] : T(0);
            }
          },
          [=](int r, int s, T v) {
            if (i0 + r < t && j0 + s < bw) panel[at(i0 + r, j0 + s, kPanel)] = v;
          });
  __syncthreads();
  for (int idx = threadIdx.x; idx < t * bw; idx += kThreads) {
    const int r = idx / bw;
    const int c = idx % bw;
    w[at(e + r, o + c, d)] = panel[at(r, c, kPanel)];
  }
  // trailing update of the lower triangle: A22 −= L21 · L21ᵀ
  for (int i0 = 0; i0 < t; i0 += kTile)
    for (int j0 = 0; j0 <= i0; j0 += kTile)
      afl_tile::tile_gemm<T>(
          bw, sm.a_tile, sm.b_tile,
          [=](afl_tile::Stage<T> a_tile, afl_tile::Stage<T> b_tile, int k0) {
#pragma unroll
            for (int l = 0; l < kLoadsPerThread; ++l) {
              const int idx = threadIdx.x + l * kThreads;
              const int r = idx / kStep;
              const int kk = idx % kStep;
              const int col = k0 + kk;
              a_tile[kk][r] = (i0 + r < t && col < bw) ? panel[at(i0 + r, col, kPanel)] : T(0);
              b_tile[kk][r] = (j0 + r < t && col < bw) ? panel[at(j0 + r, col, kPanel)] : T(0);
            }
          },
          [=](int r, int s, T v) {
            const int row = i0 + r;
            const int col = j0 + s;
            if (row >= t || col > row) return;
            T* dst = w + at(e + row, e + col, d);
            *dst = *dst - v;
          });
}

// Factors the (d, d) system w (row stride d, lower triangle read) in place
// into its lower factor; the entries above the diagonal are not written
// outside the diagonal blocks, where they become zeros. Each panel's
// inverse diagonal block goes to zkeep (row stride kPanel, one
// kPanel² block per panel) when it is not null. panel is a
// (d, kPanel) scratch.
template <class T>
__device__ void factor_system(T* w, int d, T* zkeep, T* panel, const Smem<T>& sm) {
  for (int o = 0, p = 0; o < d; o += kPanel, ++p) {
    const int e = min(o + kPanel, d);
    const int bw = e - o;
    const int t = d - e;
    afl_tri::load_lower<kThreads>(w + at(o, o, d), d, bw, sm.tri);
    __syncthreads();
    afl_tri::factor_packed<kThreads>(sm.tri, sm.buf, bw);
    afl_tri::store_lower<kThreads>(sm.tri, bw, w + at(o, o, d), d);
    __syncthreads();             // the inverse overwrites what was stored
    afl_tri::invert_packed<kThreads, kPanel>(sm.tri, sm.buf, bw);
    if (zkeep != nullptr)
      afl_tri::store_lower<kThreads>(sm.tri, bw, zkeep + static_cast<size_t>(p) * kPanelValues,
                                     kPanel);
    if (t > 0) trsm_and_update(w, d, o, e, sm.tri, panel, sm);
    __syncthreads();
  }
}

// Inverts the diagonal blocks of the lower factor l (row stride d) into
// zkeep, as factor_system keeps them.
template <class T>
__device__ void invert_diagonal(const T* l, int d, T* zkeep, const Smem<T>& sm) {
  for (int o = 0, p = 0; o < d; o += kPanel, ++p) {
    const int bw = min(kPanel, d - o);
    afl_tri::load_lower<kThreads>(l + at(o, o, d), d, bw, sm.tri);
    __syncthreads();
    afl_tri::invert_packed<kThreads, kPanel>(sm.tri, sm.buf, bw);
    afl_tri::store_lower<kThreads>(sm.tri, bw, zkeep + static_cast<size_t>(p) * kPanelValues,
                                   kPanel);
    __syncthreads();
  }
}

// L Lᵀ x = b for the lower factor l (row stride d) whose inverse diagonal
// blocks are in zs: forward substitution into y (a (d, c) scratch; x holds
// each panel's right-hand side meanwhile), then backward into x.
template <class T>
__device__ void solve_system(const T* l, int d, const T* zs, const T* b,
                             T* y, T* x, int c, const Smem<T>& sm) {
  const int n_panels = (d + kPanel - 1) / kPanel;
  for (int p = 0; p < n_panels; ++p) {
    const int o = p * kPanel;
    const int bw = min(kPanel, d - o);
    const T* z = zs + static_cast<size_t>(p) * kPanelValues;
    // rhs = b[o:e] − L[o:e, :o] · y[:o]
    solve_product<false>(
        bw, c, o, [=](int i, int k) { return l[at(o + i, k, d)]; },
        [=](int k, int j) { return y[at(k, j, c)]; },
        [=](int i, int j, T v) { x[at(o + i, j, c)] = b[at(o + i, j, c)] - v; }, sm);
    __syncthreads();
    // y[o:e] = Z · rhs
    solve_product<false>(
        bw, c, bw, [=](int i, int k) { return z[at(i, k, kPanel)]; },
        [=](int k, int j) { return x[at(o + k, j, c)]; },
        [=](int i, int j, T v) { y[at(o + i, j, c)] = v; }, sm);
    __syncthreads();
  }
  for (int p = n_panels - 1; p >= 0; --p) {
    const int o = p * kPanel;
    const int e = min(o + kPanel, d);
    const int bw = e - o;
    const T* z = zs + static_cast<size_t>(p) * kPanelValues;
    // y[o:e] −= L[e:, o:e]ᵀ · x[e:]
    solve_product<true>(
        bw, c, d - e, [=](int i, int k) { return l[at(e + k, o + i, d)]; },
        [=](int k, int j) { return x[at(e + k, j, c)]; },
        [=](int i, int j, T v) { y[at(o + i, j, c)] = y[at(o + i, j, c)] - v; }, sm);
    __syncthreads();
    // x[o:e] = Zᵀ · y[o:e]
    solve_product<true>(
        bw, c, bw, [=](int i, int k) { return z[at(k, i, kPanel)]; },
        [=](int k, int j) { return y[at(o + k, j, c)]; },
        [=](int i, int j, T v) { x[at(o + i, j, c)] = v; }, sm);
    __syncthreads();
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
cholesky_solve_kernel(const T* l, const T* b, T* x, T* zs, T* y, int d, int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> sm = carve<T>(smem);
  const size_t sys = blockIdx.x;
  const size_t n_panels = (d + kPanel - 1) / kPanel;
  const T* lm = l + sys * d * d;
  T* zm = zs + sys * n_panels * kPanelValues;
  invert_diagonal(lm, d, zm, sm);
  solve_system(lm, d, static_cast<const T*>(zm), b + sys * d * c, y + sys * d * c,
               x + sys * d * c, c, sm);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
multi_gamma_kernel(const T* cm, const T* q, const T* gammas, T* work, T* zs, T* panels,
                   T* y, T* w_out, int d, int c) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> sm = carve<T>(smem);
  const size_t g = blockIdx.x;
  const size_t dd = static_cast<size_t>(d) * d;
  const size_t n_panels = (d + kPanel - 1) / kPanel;
  const T gamma = gammas[g];
  T* w = work + g * dd;
  // C + γ_j I, lower triangle (the rest is never read)
  for (int r = threadIdx.x / 32; r < d; r += kThreads / 32)
    for (int col = threadIdx.x % 32; col <= r; col += 32)
      w[at(r, col, d)] = col < r ? cm[at(r, col, d)] : cm[at(r, col, d)] + gamma;
  __syncthreads();
  T* zg = zs + g * n_panels * kPanelValues;
  factor_system(w, d, zg, panels + g * static_cast<size_t>(d) * kPanel, sm);
  solve_system(static_cast<const T*>(w), d, static_cast<const T*>(zg), q, y + g * d * c,
               w_out + g * d * c, c, sm);
}

// --- blocked_cholesky: a panel schedule over all SMs --------------------------
//
// Per panel [o, e) of every system w (row stride d), three launches: the
// diagonal block (one block a system), the trsm L21 = A21 · Z11ᵀ (64×64
// tiles × systems) and the trailing update A22 −= L21 · L21ᵀ (the lower
// triangle's tiles × systems). src is the input a at the first panel and
// the output after it, so a is read in place and never copied.

// The diagonal block at (o, o): factored and stored as L11 (zeros above
// its diagonal) by factor_blocked; inverted by invert_blocked into zs (one
// kPanel² block a system, zeros above) unless it is the last panel.
template <class T>
__global__ void __launch_bounds__(kThreads)
chol_diag_kernel(const T* src, T* out, T* zs, int d, int o) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  T* scratch = s + kPanel * (kPanel + 1) / 2;
  const size_t sys = blockIdx.x;
  const size_t dd = static_cast<size_t>(d) * d;
  const int bw = min(kPanel, d - o);
  const int bp = afl_tri::padded(bw);
  afl_tri::load_lower_padded<kThreads>(src + sys * dd + at(o, o, d), d, bw, s);
  afl_tri::factor_blocked<kThreads>(s, scratch, bp);
  afl_tri::store_lower<kThreads>(s, bw, out + sys * dd + at(o, o, d), d);
  if (o + bw < d) {
    afl_tri::invert_blocked<kThreads>(s, scratch, bp);   // after a barrier: the store has read s
    afl_tri::store_lower<kThreads>(s, bw, zs + sys * kPanelValues, kPanel);
  }
}

// L21 = A21 · Z11ᵀ into the system's (d, kPanel) scratch panel: one 64×64
// tile (blockIdx.y rows, blockIdx.x columns) of system blockIdx.z.
template <class T>
__global__ void __launch_bounds__(kThreads)
chol_trsm_kernel(const T* src, const T* zs, T* panels, int d, int o) {
  const size_t sys = blockIdx.z;
  const T* w = src + sys * d * d;
  const T* z = zs + sys * kPanelValues;
  T* panel = panels + sys * d * kPanel;
  const int bw = min(kPanel, d - o);
  const int e = o + bw;
  const int t = d - e;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  afl_tile::tile_gemm<T>(
      bw,
      [=](afl_tile::Stage<T> a_tile, afl_tile::Stage<T> b_tile, int k0) {
#pragma unroll
        for (int l = 0; l < kLoadsPerThread; ++l) {
          const int idx = threadIdx.x + l * kThreads;
          const int r = idx / kStep;
          const int kk = idx % kStep;
          const int col = k0 + kk;
          a_tile[kk][r] = (i0 + r < t && col < bw) ? w[at(e + i0 + r, o + col, d)] : T(0);
          const int zr = j0 + r;
          b_tile[kk][r] = (zr < bw && col <= zr) ? z[at(zr, col, kPanel)] : T(0);
        }
      },
      [=](int r, int c, T v) {
        if (i0 + r < t && j0 + c < bw) panel[at(i0 + r, j0 + c, kPanel)] = v;
      });
}

// One lower tile of A22 −= L21 · L21ᵀ (read from src, written to out):
// tile blockIdx.x of the lower triangle's, row by row, of system
// blockIdx.y. The diagonal tile of each row of tiles then copies those
// rows of L21 into place, and zeros into their mirror above the diagonal.
template <class T>
__global__ void __launch_bounds__(kThreads)
chol_trailing_kernel(const T* src, T* out, const T* panels, int d, int o) {
  const size_t sys = blockIdx.y;
  const T* a = src + sys * d * d;
  T* w = out + sys * d * d;
  const T* panel = panels + sys * d * kPanel;
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
  afl_tile::tile_gemm<T>(
      bw,
      [=](afl_tile::Stage<T> a_tile, afl_tile::Stage<T> b_tile, int k0) {
#pragma unroll
        for (int l = 0; l < kLoadsPerThread; ++l) {
          const int idx = threadIdx.x + l * kThreads;
          const int r = idx / kStep;
          const int kk = idx % kStep;
          const int col = k0 + kk;
          a_tile[kk][r] = (i0 + r < t && col < bw) ? panel[at(i0 + r, col, kPanel)] : T(0);
          b_tile[kk][r] = (j0 + r < t && col < bw) ? panel[at(j0 + r, col, kPanel)] : T(0);
        }
      },
      [=](int r, int c, T v) {
        const int row = i0 + r;
        const int col = j0 + c;
        if (row >= t || col > row) return;
        w[at(e + row, e + col, d)] = a[at(e + row, e + col, d)] - v;
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

template <class Kernel>
int prepare(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <class T>
int blocked_cholesky(const void* a, void* out, void* zs, void* panels, int m, int d,
                     void* stream) {
  const int bytes = kDiagValues * static_cast<int>(sizeof(T));
  if (int err = prepare(chol_diag_kernel<T>, bytes)) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  T* w = static_cast<T*>(out);
  T* z = static_cast<T*>(zs);
  T* p = static_cast<T*>(panels);
  const T* src = static_cast<const T*>(a);
  for (int o = 0; o < d; o += kPanel) {
    const int e = min(o + kPanel, d);
    const int nt = (d - e + kTile - 1) / kTile;
    chol_diag_kernel<T><<<m, kThreads, bytes, st>>>(src, w, z, d, o);
    if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
    if (nt > 0) {
      chol_trsm_kernel<T><<<dim3((e - o + kTile - 1) / kTile, nt, m), kThreads, 0, st>>>(
          src, z, p, d, o);
      if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
      chol_trailing_kernel<T><<<dim3(nt * (nt + 1) / 2, m), kThreads, 0, st>>>(src, w, p, d, o);
      if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
    }
    src = w;
  }
  return 0;
}

template <class T>
int cholesky_solve(const void* l, const void* b, void* x, void* zs, void* y, int m, int d,
                   int c, void* stream) {
  if (int err = prepare(cholesky_solve_kernel<T>, kSmemBytes<T>)) return err;
  cholesky_solve_kernel<T><<<m, kThreads, kSmemBytes<T>, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), static_cast<const T*>(b), static_cast<T*>(x),
      static_cast<T*>(zs), static_cast<T*>(y), d, c);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int multi_gamma_solve(const void* cm, const void* q, const void* gammas, void* work,
                      void* zs, void* panels, void* y, void* w, int n_g, int d, int c,
                      void* stream) {
  if (int err = prepare(multi_gamma_kernel<T>, kSmemBytes<T>)) return err;
  multi_gamma_kernel<T><<<n_g, kThreads, kSmemBytes<T>, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cm), static_cast<const T*>(q), static_cast<const T*>(gammas),
      static_cast<T*>(work), static_cast<T*>(zs), static_cast<T*>(panels),
      static_cast<T*>(y), static_cast<T*>(w), d, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One set of entry points for each type: _f32 and _f64.
#define AFL_BLOCKED_ENTRY_POINTS(T, SUFFIX)                                             \
  extern "C" int afl_blocked_cholesky_##SUFFIX(const void* a, void* out, void* zs,      \
                                               void* panels, int m, int d,              \
                                               void* stream) {                          \
    return blocked_cholesky<T>(a, out, zs, panels, m, d, stream);                       \
  }                                                                                     \
  extern "C" int afl_cholesky_solve_##SUFFIX(const void* l, const void* b, void* x,     \
                                             void* zs, void* y, int m, int d, int c,    \
                                             void* stream) {                            \
    return cholesky_solve<T>(l, b, x, zs, y, m, d, c, stream);                          \
  }                                                                                     \
  extern "C" int afl_multi_gamma_solve_##SUFFIX(const void* cm, const void* q,          \
                                                const void* gammas, void* work,         \
                                                void* zs, void* panels, void* y,        \
                                                void* w, int n_g, int d, int c,         \
                                                void* stream) {                         \
    return multi_gamma_solve<T>(cm, q, gammas, work, zs, panels, y, w, n_g, d, c,       \
                                stream);                                                \
  }

AFL_BLOCKED_ENTRY_POINTS(float, f32)
AFL_BLOCKED_ENTRY_POINTS(double, f64)
