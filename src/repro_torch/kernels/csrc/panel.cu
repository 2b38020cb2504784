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
// Every product is IEEE in the input's type: f32 FMA (no TF32), f64 FMA
// or, in panel_trsm and panel_update, the FP64 tensor cores (DMMA, whose
// products and sums are f64); sqrt and division are IEEE
// (no fast math), and no pivot is clamped, so a block that is not
// positive definite gives NaN (sqrt of a negative pivot) as the reference
// does. The upper triangles of L and Z are written as exact zeros.
//
// panel_factor. On the TPU the whole (b, b) tile sits in VMEM and a
// fori_loop sweeps its columns. At b = 256 an f32 tile is 256 KB: more
// than a block's 227 KB of shared memory. Only the lower triangle carries
// data (the upper half of the input is never read, and the output's is
// zero), so one block keeps that triangle, packed by rows, in 128.5 KB of
// dynamic shared memory, and factors and inverts it there in one launch:
// the blocked factor of tri_blocked.cuh (eight sub-panels of 32 at 256,
// three barriers each), L stored, then invert_blocked in place (three
// merge levels), Z stored. Bound at b = 256: 2b³/3 = 11.2 MFLOP (0.17 us
// at 67 TFLOP/s f32) against 4·(b(b+1)/2 + 2b²) = 0.66 MB (0.20 us at
// 3.35 TB/s), so bytes. Neither is what limits it: it is the chains of
// 32 pivots of the eight diagonal sub-blocks (a sqrt and a division
// each), the rows below each, and the merge products, on one SM. So the
// factor runs with load_factor_ahead's look-ahead (warp 0's chains beside
// the rank-32 updates, the first beside the load), on 512 threads, in
// both types; tools/panel_factor_probe.cu times it, with a hot L2 and a
// cold one, against 256 and 1024 threads and against load_rows and
// factor_blocked without the look-ahead (PERF.md).
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
// In f64 the packed triangle doubles: 257 KB at b = 256, more than a
// block can hold, so the f64 instances take panels of at most 128 (64.5
// KB, and 33.5 KB more of scratch); the streamed schedule runs f64
// systems at b = 128 (kernels/solve.py, STREAM_BLOCK_F64).
//
// panel_trsm / panel_update. One kernel template computes C = A·Bᵀ, or
// C = T − A·Bᵀ, one output tile per block, on the tile routine of
// gemm_nt.cuh (its header states the loop in each type). Each operand
// comes as a pointer and a row stride, so the column slabs of the (d, d)
// work matrix are read and written where they lie, without a copy; C may
// be T itself. The product stays whole: Z's zero upper half is multiplied
// and every row of the full-height slab computed, as the Pallas kernels
// do. Bounds on an H100 SXM at the paths' shapes (bytes at 3.35 TB/s, f32
// at 67 TFLOP/s on the FMA pipes, f64 at 67 TFLOP/s on DMMA):
//   f32 panel_update (2304, 2048, 256): 2.42 GFLOP (36 us) against 42.2 MB
//     (12.6 us), and (6144, 5888, 256): 18.5 GFLOP (276 us) against 302 MB
//     (90 us): operations. The FMA loop keeps 8×8 or 8×4 outputs a thread,
//     each 16-byte shared-memory read feeding 32 FMAs, and the next
//     slice's loads in flight while one computes.
//   f32 panel_trsm (2304, 256): r·b·(b+1) = 0.152 GFLOP (2.3 us) against
//     4.85 MB (1.4 us): operations, but too small a grid to reach them; it
//     is a chain of 16 dependent slices on one round of 96 blocks.
//   f64 panel_update (2304, 2176, 128): 1.28 GFLOP (19 us) against 84.8 MB
//     (25 us): bytes, T's read and C's write. DMMA takes the products off
//     the FMA pipes' 34 TFLOP/s, and T's tile is fetched into shared memory
//     while the last slice computes.
//   f64 panel_trsm (2304, 128): 0.038 GFLOP (0.6 us) against 4.79 MB
//     (1.4 us): bytes, but again a short chain on 72 blocks; it runs the
//     whole k = 128 as two 64-deep slices, split four ways over the
//     block's 16 warps. A scheduler with one warp whose eight chains of mma
//     are all it has gets 58% of the DMMA rate (tools/dmma_probe.cu), so
//     each of the 72 SMs wants four warps a scheduler.
// The tile for each call comes from the output's shape (launch_f32,
// launch_f64). Nothing is split across blocks and a block adds its split
// sums in a fixed order, so a call gives the same bits every time. Skipping Z's zero half and the schedule's masked rows
// is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpanel.so panel.cu
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns a CUDA error code (0 on success).

#include <cuda_runtime.h>

#include <cstddef>

#include "gemm_nt.cuh"
#include "tri_blocked.cuh"

namespace {

// The widest panel one block holds as a packed triangle in T.
template <class T>
constexpr int kMaxPanel = sizeof(T) == 4 ? 256 : 128;

using afl_tri::tri;

// Dynamic shared memory of a kernel on one (b, b) block: the packed
// triangle padded to a multiple of 32, and the scratch of factor_blocked
// and invert_blocked at the widest panel (193 KiB at b = 256 in f32).
template <class T>
int tri_bytes(int b) {
  const int bp = afl_tri::padded(b);
  return (bp * (bp + 1) / 2 + afl_tri::kScratchValues<kMaxPanel<T>>) * static_cast<int>(sizeof(T));
}

// panel_factor: load and factor with load_factor_ahead, store L, invert
// in place, store Z. mark: afl_tri::NoMarks here, clock stamps in
// tools/panel_factor_probe.cu, which also builds other block sizes.
template <class T, int kThreads, class Marks>
__global__ void __launch_bounds__(kThreads)
factor_kernel(const T* __restrict__ a, int lda, int b, T* __restrict__ l_out,
              T* __restrict__ z_out, Marks mark) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  mark(afl_tri::marks::kStart);
  const int bp = afl_tri::padded(b);
  T* s = reinterpret_cast<T*>(smem_raw);   // tri(bp) values: the packed lower triangle
  T* scratch = s + tri(bp);                // the factor's work, then the inverse's
  afl_tri::load_factor_ahead<kThreads, kMaxPanel<T>>(a, lda, b, s, scratch, mark);
  afl_tri::store_lower<kThreads>(s, b, l_out, b);
  afl_tri::invert_blocked<kThreads>(s, scratch, bp, mark);   // after a barrier: the store has read s
  afl_tri::store_lower<kThreads>(s, b, z_out, b);
  mark(afl_tri::marks::kDone);
}

constexpr int kFactorThreads = 512;

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
  auto kernel = factor_kernel<T, kFactorThreads, afl_tri::NoMarks>;
  const int bytes = tri_bytes<T>(b);
  if (int err = prepare(kernel, bytes)) return err;
  kernel<<<1, kFactorThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), lda, b, static_cast<T*>(l), static_cast<T*>(z),
      afl_tri::NoMarks{});
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_tri_inv(const void* l, int ldl, int b, void* z, void* stream) {
  if (b < 1 || b > kMaxPanel<T>) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = tri_bytes<T>(b);
  if (int err = prepare(tri_inv_kernel<T>, bytes)) return err;
  tri_inv_kernel<T><<<1, kInvThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(l), ldl, b, static_cast<T*>(z));
  return static_cast<int>(cudaGetLastError());
}

// panel_trsm and panel_update: one block per output tile of gemm_nt.cuh.
template <class Tile, class Epi, class T>
__global__ void __launch_bounds__(Tile::kThreads)
gemm_nt_kernel(afl_gemm::Problem<T> p, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int i0 = blockIdx.y * Tile::kRows, j0 = blockIdx.x * Tile::kCols;
  if constexpr (sizeof(T) == 4)
    afl_gemm::ffma_tile<Tile>(p, i0, j0, epi, reinterpret_cast<float*>(smem_raw));
  else
    afl_gemm::dmma_tile<Tile>(p, i0, j0, epi, reinterpret_cast<double*>(smem_raw));
}

// The tiles. f32: 128×64 (8×4 outputs a thread, three blocks an SM fit)
// and, for outputs at most 256 wide (panel_trsm at b = 256, the last
// update), 96×64 (4×4, 384 threads): 96 blocks at m = 2304 fill the card
// in one round where 64×64 tiles would leave 12 SMs with two. f64: 64×64
// in 16-deep slices, and for outputs at most 128 wide (panel_trsm at
// b = 128, the last update: 72 blocks at m = 2304) 64-deep slices, so
// that the whole k = 128 is in flight in two stages, each slice split
// over four groups of four warps.
using F32Mid = afl_gemm::FfmaTile<16, 16, 8, 4, 16>;
using F32Narrow = afl_gemm::FfmaTile<24, 16, 4, 4, 16>;
using F64Mid = afl_gemm::DmmaTile<2, 2, 16, 3>;
using F64Narrow = afl_gemm::DmmaTile<2, 2, 64, 2, 4>;

template <class Kernel>
int prepare_once(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  if (int err = static_cast<int>(cudaGetDevice(&dev))) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return 0;
  if (int err = prepare(kernel, bytes)) return err;
  if (dev >= 0 && dev < 64) done[dev] = true;
  return 0;
}

template <class Tile, class Epi, class T>
int launch_tile(const afl_gemm::Problem<T>& p, Epi epi, cudaStream_t stream) {
  static bool prepared[64] = {};
  const dim3 grid((p.n + Tile::kCols - 1) / Tile::kCols, (p.m + Tile::kRows - 1) / Tile::kRows);
  auto kernel = gemm_nt_kernel<Tile, Epi, T>;
  constexpr int kBytes = Tile::template smem_bytes<Epi>();
  if (int err = prepare_once(kernel, kBytes, prepared)) return err;
  kernel<<<grid, Tile::kThreads, kBytes, stream>>>(p, epi);
  return static_cast<int>(cudaGetLastError());
}

template <class Epi>
int launch_f32(const afl_gemm::Problem<float>& p, Epi epi, cudaStream_t s) {
  return p.n <= 256 ? launch_tile<F32Narrow>(p, epi, s) : launch_tile<F32Mid>(p, epi, s);
}

template <class Epi>
int launch_f64(const afl_gemm::Problem<double>& p, Epi epi, cudaStream_t s) {
  return p.n <= 128 ? launch_tile<F64Narrow>(p, epi, s) : launch_tile<F64Mid>(p, epi, s);
}

// C (m, n) = A (m, k) · B (n, k)ᵀ, or T − A · Bᵀ. Row strides lda, ldb,
// ldt, ldc; unit column strides. t and c may be the same matrix.
template <class T, bool kSubtract>
int launch_gemm(const void* t, int ldt, const void* a, int lda, const void* b, int ldb,
                void* c, int ldc, int m, int n, int k, void* stream) {
  using afl_gemm::vec16;
  constexpr int kSize = static_cast<int>(sizeof(T));
  const afl_gemm::Problem<T> p{
      {static_cast<const T*>(a), lda, vec16(a, lda, kSize)},
      {static_cast<const T*>(b), ldb, vec16(b, ldb, kSize)},
      {static_cast<const T*>(t), ldt, t != nullptr && vec16(t, ldt, kSize)},
      static_cast<T*>(c), ldc, vec16(c, ldc, kSize), m, n, k};
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 4) {
    if constexpr (kSubtract) return launch_f32(p, afl_gemm::SubtractFrom{}, s);
    else return launch_f32(p, afl_gemm::StoreProduct{}, s);
  } else {
    if constexpr (kSubtract) return launch_f64(p, afl_gemm::SubtractFrom{}, s);
    else return launch_f64(p, afl_gemm::StoreProduct{}, s);
  }
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
