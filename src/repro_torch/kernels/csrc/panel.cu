// Panel kernels of the streamed Cholesky factor and solve of one wide SPD
// system (d >= 2048), in f32 and in f64 (one template, instantiated twice):
//
//   panel_factor   (b, b) SPD diagonal block A  ->  L = chol(A), Z = L^-1
//   panel_tri_inv  (b, b) lower-triangular L    ->  Z = L^-1
//   panel_trsm     raw (r, b), Z (b, b)         ->  raw · Zᵀ
//   panel_update   T (r, w), A (r, b), B (w, b) ->  T − A · Bᵀ
//
// They replace the Pallas TPU kernels of src/repro/kernels/solve.py:
// panel_factor (_factor_tile then _tri_inv_tile), panel_tri_inv
// (_tri_inv_tile), panel_trsm and panel_update (one tiled matmul each).
// Every product is a plain FMA in the input's type (no TF32, no mma; the
// f64 instances use the card's native FP64), sqrt and division are IEEE
// (no fast math), and no pivot is clamped, so a block that is not
// positive definite gives NaN (sqrt of a negative pivot) as the reference
// does. The upper triangles of L and Z are written as exact zeros.
//
// panel_factor. On the TPU the whole (b, b) tile sits in VMEM and a
// fori_loop sweeps its columns. Here one block of 1024 threads does the
// same, with the column loops of packed_tri.cuh. At b = 256 an f32 tile is
// 256 KB: more than a block's 227 KB of shared memory, and the whole
// register file of the SM. Only the lower triangle carries data (the upper
// half of the input is never read, and the output's is zero), so the block
// keeps that triangle, packed by rows, in 128.5 KB of dynamic shared
// memory. The factor is right-looking: at column j one barrier publishes
// the scaled column, then warps take the rows and lanes the columns of the
// trailing triangle for the rank-1 update. The inverse then runs in place,
// row by row, over the same packed triangle: row i of Z needs row i of L,
// copied to a buffer first, and the rows of Z above it, which have already
// overwritten theirs; four threads share each column's dot product and add
// their parts with shuffles. Bound at b = 256: 2b³/3 = 11.2 MFLOP (0.17 us
// at 67 TFLOP/s f32) against 4·(b(b+1)/2 + 2b²) = 0.66 MB (0.20 us at
// 3.35 TB/s), so bytes. Neither is what limits it: it is 2b = 512 steps
// that must run one after the other, each behind a barrier, on one SM.
//
// panel_tri_inv. One block of 512 threads inverts the packed triangle with
// invert_blocked (tri_blocked.cuh): the eight 32-wide diagonal sub-blocks
// of a 256-wide block are inverted by eight warps at once, without block
// barriers, then merged in three levels of two triangular-times-dense
// products each (Z21 = −Z22 · L21 · Z11), eight barriers in all where the
// row loop took 512. A ragged b is padded to a multiple of 32 with an
// identity tail. Shared memory: the packed triangle and a 128 × 129 merge
// operand, 193 KB at b = 256 in f32. Bound at b = 256: b³/3 = 5.6 MFLOP
// (0.08 us) against 4·(b(b+1)/2 + b²) = 0.39 MB (0.12 us), so bytes; the
// merge products, about 1.3 M FMAs with their operands read from shared
// memory on one SM, are what remains.
//
// In f64 the packed triangle doubles: 257 KB at b = 256, more than a block
// can hold, so the f64 instances take panels of at most 128 (65.5 KB, and
// 33.5 KB more of scratch for the inverse) and eight threads share
// each column of panel_factor's inverse; the streamed schedule runs f64
// systems at b = 128 (kernels/solve.py, STREAM_BLOCK_F64).
//
// panel_trsm / panel_update. One tiled kernel computes C = A·Bᵀ, or
// C = T − A·Bᵀ, in 64×64 output tiles: the tile loop of tile_gemm.cuh
// (one tile per 256-thread block, 4×4 register micro-tiles, K staged 16 at
// a time through shared memory), which gram.cu shares. Each operand comes
// as a pointer and a row stride, so the column slabs of the (d, d) work
// matrix are read and written where they lie, without a copy; C may be T
// itself (each element is read and then written by one thread). Ragged
// edges are masked. At the shapes of the d = 2304 path, panel_update
// (2304, 2048, 256) needs 2·r·w·b = 2.42 GFLOP (36 us) against
// 4·(2rw + rb + wb) = 42.2 MB (12.6 us). Z is lower triangular (both
// panel kernels write its upper half as zeros), so panel_trsm (2304, 256)
// needs r·b·(b+1) = 0.152 GFLOP (2.3 us) against 4·(2rb + b(b+1)/2) =
// 4.85 MB (1.4 us); this kernel does twice those flops, since it
// multiplies the zero half too. Both are bound by operations. Skipping Z's
// zero half, skipping the rows of the full-height slab that the schedule
// masks to zero, cp.async/TMA staging and wgmma (at a lower precision than
// this port's f32) are later work. The f64 instance stages 17.4 KB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpanel.so panel.cu
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns a CUDA error code (0 on success).

#include <cuda_runtime.h>

#include <cstddef>

#include "packed_tri.cuh"
#include "tile_gemm.cuh"
#include "tri_blocked.cuh"

namespace {

constexpr int kPanelThreads = 1024;

// The widest panel one block holds as a packed triangle in T.
template <class T>
constexpr int kMaxPanel = sizeof(T) == 4 ? 256 : 128;

using afl_tri::tri;

template <class T>
__global__ void __launch_bounds__(kPanelThreads)
factor_kernel(const T* __restrict__ a, int lda, int b,
              T* __restrict__ l_out, T* __restrict__ z_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);   // tri(b) values: the packed lower triangle
  T* buf = s + tri(b);                     // kMaxPanel values: a column or a row of L
  afl_tri::load_lower<kPanelThreads>(a, lda, b, s);
  __syncthreads();
  afl_tri::factor_packed<kPanelThreads>(s, buf, b);
  afl_tri::store_lower<kPanelThreads>(s, b, l_out, b);
  __syncthreads();             // the inverse overwrites what was stored
  afl_tri::invert_packed<kPanelThreads, kMaxPanel<T>>(s, buf, b);
  afl_tri::store_lower<kPanelThreads>(s, b, z_out, b);
}

constexpr int kInvThreads = 512;

template <class T>
__global__ void __launch_bounds__(kInvThreads)
tri_inv_kernel(const T* __restrict__ l, int ldl, int b, T* __restrict__ z_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bp = afl_tri::padded(b);
  T* s = reinterpret_cast<T*>(smem_raw);   // tri(bp) values: the packed lower triangle
  T* scratch = s + tri(bp);                // the sub-block stagings and merge products
  afl_tri::load_lower_padded<kInvThreads>(l, ldl, b, s);
  afl_tri::invert_blocked<kInvThreads>(s, scratch, bp);
  afl_tri::store_lower<kInvThreads>(s, b, z_out, b);
}

template <class Kernel>
int prepare(Kernel kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <class T>
int launch_factor(const void* a, int lda, int b, void* l, void* z, void* stream) {
  if (b < 1 || b > kMaxPanel<T>) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = (b * (b + 1) / 2 + kMaxPanel<T>) * static_cast<int>(sizeof(T));
  if (int err = prepare(factor_kernel<T>, bytes)) return err;
  factor_kernel<T><<<1, kPanelThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), lda, b, static_cast<T*>(l), static_cast<T*>(z));
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_tri_inv(const void* l, int ldl, int b, void* z, void* stream) {
  if (b < 1 || b > kMaxPanel<T>) return static_cast<int>(cudaErrorInvalidValue);
  const int bp = afl_tri::padded(b);
  const int bytes =
      (bp * (bp + 1) / 2 + afl_tri::kScratchValues<kMaxPanel<T>>) * static_cast<int>(sizeof(T));
  if (int err = prepare(tri_inv_kernel<T>, bytes)) return err;
  tri_inv_kernel<T><<<1, kInvThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), ldl, b, static_cast<T*>(z));
  return static_cast<int>(cudaGetLastError());
}

using afl_tile::kLoadsPerThread;
using afl_tile::kStep;
using afl_tile::kThreads;
using afl_tile::kTile;

// C (m, n) = A (m, k) · B (n, k)ᵀ, or T − A · Bᵀ. Row strides lda, ldb,
// ldt, ldc; unit column strides. t and c may be the same matrix.
template <class T, bool kSubtract>
__global__ void __launch_bounds__(kThreads)
gemm_nt_kernel(const T* __restrict__ a, int lda,
               const T* __restrict__ bm, int ldb, const T* t, int ldt,
               T* c, int ldc, int m, int n, int k) {
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  afl_tile::tile_gemm<T>(
      k,
      // the reduction runs along the rows of A and B: neighbouring threads
      // read neighbouring entries of one row
      [=](afl_tile::Stage<T> a_tile, afl_tile::Stage<T> b_tile, int k0) {
#pragma unroll
        for (int l = 0; l < kLoadsPerThread; ++l) {
          const int e = threadIdx.x + l * kThreads;
          const int r = e / kStep;
          const int kk = e % kStep;
          const int col = k0 + kk;
          a_tile[kk][r] = (i0 + r < m && col < k)
                              ? a[static_cast<size_t>(i0 + r) * lda + col]
                              : T(0);
          b_tile[kk][r] = (j0 + r < n && col < k)
                              ? bm[static_cast<size_t>(j0 + r) * ldb + col]
                              : T(0);
        }
      },
      [=](int r, int s, T v) {
        const int row = i0 + r;
        const int col = j0 + s;
        if (row >= m || col >= n) return;
        if (kSubtract) v = t[static_cast<size_t>(row) * ldt + col] - v;
        c[static_cast<size_t>(row) * ldc + col] = v;
      });
}

template <class T, bool kSubtract>
int launch_gemm(const void* t, int ldt, const void* a, int lda, const void* b,
                int ldb, void* c, int ldc, int m, int n, int k, void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  gemm_nt_kernel<T, kSubtract><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), lda, static_cast<const T*>(b), ldb,
      static_cast<const T*>(t), ldt, static_cast<T*>(c), ldc, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One set of entry points for each type: _f32 and _f64.
#define AFL_PANEL_ENTRY_POINTS(T, SUFFIX)                                             \
  extern "C" int afl_panel_factor_##SUFFIX(const void* a, int lda, int b, void* l,    \
                                           void* z, void* stream) {                   \
    return launch_factor<T>(a, lda, b, l, z, stream);                                 \
  }                                                                                   \
  extern "C" int afl_panel_tri_inv_##SUFFIX(const void* l, int ldl, int b, void* z,   \
                                            void* stream) {                           \
    return launch_tri_inv<T>(l, ldl, b, z, stream);                                   \
  }                                                                                   \
  extern "C" int afl_panel_trsm_##SUFFIX(const void* raw, int ldr, const void* zinv,  \
                                         int ldz, void* out, int ldo, int r, int b,   \
                                         void* stream) {                              \
    return launch_gemm<T, false>(nullptr, 0, raw, ldr, zinv, ldz, out, ldo, r, b, b,  \
                                 stream);                                             \
  }                                                                                   \
  extern "C" int afl_panel_update_##SUFFIX(const void* trail, int ldt, const void* lp, \
                                           int ldl, const void* pt, int ldp,          \
                                           void* out, int ldo, int r, int w, int b,   \
                                           void* stream) {                            \
    return launch_gemm<T, true>(trail, ldt, lp, ldl, pt, ldp, out, ldo, r, w, b,      \
                                stream);                                              \
  }

AFL_PANEL_ENTRY_POINTS(float, f32)
AFL_PANEL_ENTRY_POINTS(double, f64)
