// Blocked Cholesky, batched triangular solve and the fused γ sweep of
// systems narrower than the streamed path's 2048, in f32:
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
// product is a plain f32 FMA (no TF32, no mma), sqrt and division are IEEE
// and no pivot is clamped.
//
// Design. As the TPU kernel is one pallas_call whose grid walks the
// systems, each of these is one launch whose blocks are the systems (the
// γs of the sweep): one block of 256 threads walks the panels of its
// system in device memory, in place in the output (for the sweep, in a
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
// Bound at the path's shapes (d³/3 flops a factor, 2d²c a solve; each input
// read once, of a, L and C only the lower triangle, and each output written
// once; 67 TFLOP/s f32, 3.35 TB/s): blocked_cholesky (1, 1536) 1.21 GFLOP =
// 18 us against 14.2 MB = 4.2 us, operations; cholesky_solve (1, 1536, 16)
// 75.5 MFLOP = 1.1 us against 4.9 MB = 1.5 us, bytes; multi_gamma_solve
// (2304, 16, 16 γs) 68.0 GFLOP = 1.01 ms against 13.1 MB = 3.9 us,
// operations. None of this reaches the
// bound: one block per system uses one SM of 132 (the sweep 16), and the
// column loops of the diagonal blocks (2b steps a panel, each behind a
// barrier) run one after the other. Spreading a system over SMs
// (a cooperative grid, or one launch per panel as the streamed path does),
// a blocked micro-factor with fewer barriers, cp.async/TMA staging and
// wgmma at a lower precision than f32 are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libblocked.so blocked.cu
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns a CUDA error code (0 on success).

#include <cuda_runtime.h>

#include <cstddef>

#include "packed_tri.cuh"
#include "tile_gemm.cuh"

namespace {

using afl_tile::kLoadsPerThread;
using afl_tile::kStep;
using afl_tile::kThreads;   // 256: the tile loop's block, and every kernel's here
using afl_tile::kTile;
using afl_tri::tri;

constexpr int kPanel = 128;                    // panel width (DEFAULT_BLOCK)
constexpr int kPanelFloats = kPanel * kPanel;
constexpr int kSolveK = 32;                    // K staged per step of a solve product
constexpr int kSolveCols = 16;                 // right-hand-side columns per pass
constexpr int kSolvePad = kPanel + 1;

// Dynamic shared memory, in floats: the packed triangle and a row or column
// of it, the tile loop's two staging buffers, the solve products' staging.
constexpr int kTriFloats = kPanel * (kPanel + 1) / 2 + kPanel;   // 8384
constexpr int kStageFloats = kStep * (kTile + afl_tile::kPad);            // 1088
constexpr int kSolveAFloats = kSolveK * kSolvePad;                        // 4128
constexpr int kSolveYFloats = kSolveK * kSolveCols;                       // 512
constexpr int kSmemFloats = kTriFloats + 2 * kStageFloats + kSolveAFloats + kSolveYFloats;
constexpr int kSmemBytes = kSmemFloats * static_cast<int>(sizeof(float));
static_assert(kTriFloats % 4 == 0 && kStageFloats % 4 == 0 && kSolveAFloats % 4 == 0,
              "16-byte aligned staging buffers");
static_assert(kThreads == 2 * kPanel, "two threads for each row of a solve product");

struct Smem {
  float* tri;                 // packed lower triangle of a diagonal block
  float* buf;                 // kPanel floats: a column or a row of it
  afl_tile::Stage a_tile;
  afl_tile::Stage b_tile;
  float* solve_a;             // [kSolveK][kSolvePad]
  float* solve_y;             // [kSolveK][kSolveCols]
};

__device__ Smem carve(float* smem) {
  Smem s;
  s.tri = smem;
  s.buf = smem + kTriFloats - kPanel;
  s.a_tile = reinterpret_cast<afl_tile::Stage>(smem + kTriFloats);
  s.b_tile = reinterpret_cast<afl_tile::Stage>(smem + kTriFloats + kStageFloats);
  s.solve_a = smem + kTriFloats + 2 * kStageFloats;
  s.solve_y = s.solve_a + kSolveAFloats;
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
template <bool kATransposed, class AAt, class YAt, class Store>
__device__ void solve_product(int rows, int cols, int k, AAt a_at, YAt y_at,
                              Store store, const Smem& sm) {
  const int i = threadIdx.x % kPanel;
  const int half = threadIdx.x / kPanel;
  for (int j0 = 0; j0 < cols; j0 += kSolveCols) {
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
    for (int k0 = 0; k0 < k; k0 += kSolveK) {
#pragma unroll 4
      for (int l = 0; l < kSolveK * kPanel / kThreads; ++l) {
        const int e = threadIdx.x + l * kThreads;
        const int kk = kATransposed ? e / kPanel : e % kSolveK;
        const int r = kATransposed ? e % kPanel : e / kSolveK;
        sm.solve_a[kk * kSolvePad + r] =
            (r < rows && k0 + kk < k) ? a_at(r, k0 + kk) : 0.0f;
      }
#pragma unroll
      for (int l = 0; l < kSolveK * kSolveCols / kThreads; ++l) {
        const int e = threadIdx.x + l * kThreads;
        const int kk = e / kSolveCols;
        const int jj = e % kSolveCols;
        sm.solve_y[kk * kSolveCols + jj] =
            (k0 + kk < k && j0 + jj < cols) ? y_at(k0 + kk, j0 + jj) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kSolveK; ++kk) {
        const float a = sm.solve_a[kk * kSolvePad + i];
        const float4 y0 = *reinterpret_cast<const float4*>(
            &sm.solve_y[kk * kSolveCols + half * 8]);
        const float4 y1 = *reinterpret_cast<const float4*>(
            &sm.solve_y[kk * kSolveCols + half * 8 + 4]);
        acc[0] = fmaf(a, y0.x, acc[0]);
        acc[1] = fmaf(a, y0.y, acc[1]);
        acc[2] = fmaf(a, y0.z, acc[2]);
        acc[3] = fmaf(a, y0.w, acc[3]);
        acc[4] = fmaf(a, y1.x, acc[4]);
        acc[5] = fmaf(a, y1.y, acc[5]);
        acc[6] = fmaf(a, y1.z, acc[6]);
        acc[7] = fmaf(a, y1.w, acc[7]);
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
__device__ void trsm_and_update(float* w, int d, int o, int e, const float* z,
                                float* panel, const Smem& sm) {
  const int bw = e - o;
  const int t = d - e;
  // trsm: panel (t, bw) = A21 · Z11ᵀ, Z11 lower triangular in shared memory
  for (int i0 = 0; i0 < t; i0 += kTile)
    for (int j0 = 0; j0 < bw; j0 += kTile)
      afl_tile::tile_gemm(
          bw, sm.a_tile, sm.b_tile,
          [=](afl_tile::Stage a_tile, afl_tile::Stage b_tile, int k0) {
#pragma unroll
            for (int l = 0; l < kLoadsPerThread; ++l) {
              const int idx = threadIdx.x + l * kThreads;
              const int r = idx / kStep;
              const int kk = idx % kStep;
              const int col = k0 + kk;
              a_tile[kk][r] = (i0 + r < t && col < bw) ? w[at(e + i0 + r, o + col, d)] : 0.0f;
              const int zr = j0 + r;
              b_tile[kk][r] = (zr < bw && col <= zr) ? z[tri(zr) + col] : 0.0f;
            }
          },
          [=](int r, int s, float v) {
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
      afl_tile::tile_gemm(
          bw, sm.a_tile, sm.b_tile,
          [=](afl_tile::Stage a_tile, afl_tile::Stage b_tile, int k0) {
#pragma unroll
            for (int l = 0; l < kLoadsPerThread; ++l) {
              const int idx = threadIdx.x + l * kThreads;
              const int r = idx / kStep;
              const int kk = idx % kStep;
              const int col = k0 + kk;
              a_tile[kk][r] = (i0 + r < t && col < bw) ? panel[at(i0 + r, col, kPanel)] : 0.0f;
              b_tile[kk][r] = (j0 + r < t && col < bw) ? panel[at(j0 + r, col, kPanel)] : 0.0f;
            }
          },
          [=](int r, int s, float v) {
            const int row = i0 + r;
            const int col = j0 + s;
            if (row >= t || col > row) return;
            float* dst = w + at(e + row, e + col, d);
            *dst = *dst - v;
          });
}

// Factors the (d, d) system w (row stride d, lower triangle read) in place
// into its lower factor; the entries above the diagonal are not written
// outside the diagonal blocks, where they become zeros. Each panel's
// inverse diagonal block goes to zkeep (row stride kPanel, one
// kPanel² block per panel) when it is not null. panel is a
// (d, kPanel) scratch.
__device__ void factor_system(float* w, int d, float* zkeep, float* panel,
                              const Smem& sm) {
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
      afl_tri::store_lower<kThreads>(sm.tri, bw, zkeep + static_cast<size_t>(p) * kPanelFloats,
                                     kPanel);
    if (t > 0) trsm_and_update(w, d, o, e, sm.tri, panel, sm);
    __syncthreads();
  }
}

// Inverts the diagonal blocks of the lower factor l (row stride d) into
// zkeep, as factor_system keeps them.
__device__ void invert_diagonal(const float* l, int d, float* zkeep, const Smem& sm) {
  for (int o = 0, p = 0; o < d; o += kPanel, ++p) {
    const int bw = min(kPanel, d - o);
    afl_tri::load_lower<kThreads>(l + at(o, o, d), d, bw, sm.tri);
    __syncthreads();
    afl_tri::invert_packed<kThreads, kPanel>(sm.tri, sm.buf, bw);
    afl_tri::store_lower<kThreads>(sm.tri, bw, zkeep + static_cast<size_t>(p) * kPanelFloats,
                                   kPanel);
    __syncthreads();
  }
}

// L Lᵀ x = b for the lower factor l (row stride d) whose inverse diagonal
// blocks are in zs: forward substitution into y (a (d, c) scratch; x holds
// each panel's right-hand side meanwhile), then backward into x.
__device__ void solve_system(const float* l, int d, const float* zs, const float* b,
                             float* y, float* x, int c, const Smem& sm) {
  const int n_panels = (d + kPanel - 1) / kPanel;
  for (int p = 0; p < n_panels; ++p) {
    const int o = p * kPanel;
    const int bw = min(kPanel, d - o);
    const float* z = zs + static_cast<size_t>(p) * kPanelFloats;
    // rhs = b[o:e] − L[o:e, :o] · y[:o]
    solve_product<false>(
        bw, c, o, [=](int i, int k) { return l[at(o + i, k, d)]; },
        [=](int k, int j) { return y[at(k, j, c)]; },
        [=](int i, int j, float v) { x[at(o + i, j, c)] = b[at(o + i, j, c)] - v; }, sm);
    __syncthreads();
    // y[o:e] = Z · rhs
    solve_product<false>(
        bw, c, bw, [=](int i, int k) { return z[at(i, k, kPanel)]; },
        [=](int k, int j) { return x[at(o + k, j, c)]; },
        [=](int i, int j, float v) { y[at(o + i, j, c)] = v; }, sm);
    __syncthreads();
  }
  for (int p = n_panels - 1; p >= 0; --p) {
    const int o = p * kPanel;
    const int e = min(o + kPanel, d);
    const int bw = e - o;
    const float* z = zs + static_cast<size_t>(p) * kPanelFloats;
    // y[o:e] −= L[e:, o:e]ᵀ · x[e:]
    solve_product<true>(
        bw, c, d - e, [=](int i, int k) { return l[at(e + k, o + i, d)]; },
        [=](int k, int j) { return x[at(e + k, j, c)]; },
        [=](int i, int j, float v) { y[at(o + i, j, c)] = y[at(o + i, j, c)] - v; }, sm);
    __syncthreads();
    // x[o:e] = Zᵀ · y[o:e]
    solve_product<true>(
        bw, c, bw, [=](int i, int k) { return z[at(k, i, kPanel)]; },
        [=](int k, int j) { return y[at(o + k, j, c)]; },
        [=](int i, int j, float v) { x[at(o + i, j, c)] = v; }, sm);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
blocked_cholesky_kernel(const float* a, float* out, float* panels, int d) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve(smem);
  const size_t dd = static_cast<size_t>(d) * d;
  const float* src = a + blockIdx.x * dd;
  float* w = out + blockIdx.x * dd;
  // the lower triangle of the system, and zeros above it
  for (int r = threadIdx.x / 32; r < d; r += kThreads / 32)
    for (int col = threadIdx.x % 32; col < d; col += 32)
      w[at(r, col, d)] = col <= r ? src[at(r, col, d)] : 0.0f;
  __syncthreads();
  factor_system(w, d, nullptr, panels + blockIdx.x * static_cast<size_t>(d) * kPanel, sm);
}

__global__ void __launch_bounds__(kThreads)
cholesky_solve_kernel(const float* l, const float* b, float* x, float* zs, float* y,
                      int d, int c) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve(smem);
  const size_t sys = blockIdx.x;
  const size_t n_panels = (d + kPanel - 1) / kPanel;
  const float* lm = l + sys * d * d;
  float* zm = zs + sys * n_panels * kPanelFloats;
  invert_diagonal(lm, d, zm, sm);
  solve_system(lm, d, zm, b + sys * d * c, y + sys * d * c, x + sys * d * c, c, sm);
}

__global__ void __launch_bounds__(kThreads)
multi_gamma_kernel(const float* cm, const float* q, const float* gammas, float* work,
                   float* zs, float* panels, float* y, float* w_out, int d, int c) {
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve(smem);
  const size_t g = blockIdx.x;
  const size_t dd = static_cast<size_t>(d) * d;
  const size_t n_panels = (d + kPanel - 1) / kPanel;
  const float gamma = gammas[g];
  float* w = work + g * dd;
  // C + γ_j I, lower triangle (the rest is never read)
  for (int r = threadIdx.x / 32; r < d; r += kThreads / 32)
    for (int col = threadIdx.x % 32; col <= r; col += 32)
      w[at(r, col, d)] = col < r ? cm[at(r, col, d)] : cm[at(r, col, d)] + gamma;
  __syncthreads();
  float* zg = zs + g * n_panels * kPanelFloats;
  factor_system(w, d, zg, panels + g * static_cast<size_t>(d) * kPanel, sm);
  solve_system(w, d, zg, q, y + g * d * c, w_out + g * d * c, c, sm);
}

template <class Kernel>
int prepare(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
}

}  // namespace

extern "C" int afl_blocked_cholesky_f32(const void* a, void* out, void* panels, int m,
                                        int d, void* stream) {
  if (int err = prepare(blocked_cholesky_kernel)) return err;
  blocked_cholesky_kernel<<<m, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(out), static_cast<float*>(panels),
      d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int afl_cholesky_solve_f32(const void* l, const void* b, void* x, void* zs,
                                      void* y, int m, int d, int c, void* stream) {
  if (int err = prepare(cholesky_solve_kernel)) return err;
  cholesky_solve_kernel<<<m, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l), static_cast<const float*>(b), static_cast<float*>(x),
      static_cast<float*>(zs), static_cast<float*>(y), d, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int afl_multi_gamma_solve_f32(const void* cm, const void* q, const void* gammas,
                                         void* work, void* zs, void* panels, void* y,
                                         void* w, int n_g, int d, int c, void* stream) {
  if (int err = prepare(multi_gamma_kernel)) return err;
  multi_gamma_kernel<<<n_g, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cm), static_cast<const float*>(q),
      static_cast<const float*>(gammas), static_cast<float*>(work), static_cast<float*>(zs),
      static_cast<float*>(panels), static_cast<float*>(y), static_cast<float*>(w), d, c);
  return static_cast<int>(cudaGetLastError());
}
