// Rank-k update of a lower Cholesky factor, in f32:
//
//   chol_rank_update  L (d, d) lower, xs (k, d)  ->  L' = chol(L Lᵀ + xsᵀ xs)
//
// It replaces the Pallas TPU kernel chol_rank_update of
// src/repro/kernels/solve.py (body _rank_update_kernel): a Householder
// column sweep over the implicit QR of [Lᵀ; xs]. At column i one
// (k+1)-reflection annihilates the k update entries of row i of xsᵀ:
//
//   w = xsᵀ[i], s = w·w, a = L[i][i], r = sqrt(a² + s),
//   amr = −s / (r + a)  (a − r without cancellation),
//   β = (r + a) / (r · s_)  with s_ = s, or 1 when s = 0,
//   t_j = amr · L[j][i] + xsᵀ[j] · w                        for j > i,
//   L[i][i] = r, L[j][i] −= β · amr · t_j, xsᵀ[j] −= β · t_j · w.
//
// A zero update row gives t = 0, so the s_ guard makes it a no-op, as in
// the reference; sqrt and division are IEEE and nothing is clamped, so a
// non-finite input gives NaN. Entries above the diagonal are copied from L.
//
// Design. The sweep is sequential over the d columns; within a column the
// (d − i)·k entries of the tails are independent. On the TPU L and xsᵀ sit
// in VMEM for the whole sweep. Here one block of 1024 threads walks the
// columns, with two barriers a column: warp 0 forms w and the scalars of
// the reflection, then every warp takes rows j of the tail, eight lanes to
// a row (the dot product, a three-step shuffle, and the row's update). Row
// i of L as a column is strided, so the block works on R = Lᵀ, whose row i
// is the tail of column i and contiguous, and on xsᵀ (d, k), whose rows are
// contiguous: both in device memory (scratch the wrapper allocates; xsᵀ is
// 0.6 MB at d = 2304, k = 64, and both stay in L2), written in and read out
// by tiled transposes through shared memory.
//
// Bound at the path's shape (d = 2304, k = 64): the sweep needs 2kd² =
// 0.68 GFLOP (10 us at 67 TFLOP/s f32) against 4·(2d² + kd) = 43.1 MB
// (12.9 us at 3.35 TB/s) for L, xs and L', so bytes. One SM cannot come
// near either: each column reads and writes the (d − i, k) tail of xsᵀ
// again, 4·d²·k = 1.36 GB through one SM's path to L2 over the sweep, and
// 2d barriers run one after the other. Keeping the tail's bottom rows in
// shared memory, a blocked (compact WY) sweep that touches xsᵀ once per
// panel of columns, or a sweep spread over SMs are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librank_update.so rank_update.cu
// The entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns a CUDA error code (0 on success).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerRow = 8;                 // lanes sharing one row of the tail
constexpr int kRowsPerWarp = 32 / kLanesPerRow;
constexpr int kEdge = 32;                       // transpose tile edge

__device__ __forceinline__ size_t at(int row, int col, int ld) {
  return static_cast<size_t>(row) * ld + col;
}

// dst (rows, cols) tile at (r0, c0) = srcᵀ, src with row stride lds and
// dst with row stride ldd; both coalesced through a padded shared tile.
__device__ void transpose_tile(const float* src, int lds, float* dst, int ldd,
                               int r0, int c0, int rows, int cols,
                               float (*tile)[kEdge + 1]) {
  const int tx = threadIdx.x % kEdge;
  const int ty = threadIdx.x / kEdge;
  if (c0 + ty < cols && r0 + tx < rows) tile[ty][tx] = src[at(c0 + ty, r0 + tx, lds)];
  __syncthreads();
  if (r0 + ty < rows && c0 + tx < cols) dst[at(r0 + ty, c0 + tx, ldd)] = tile[tx][ty];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
rank_update_kernel(const float* l, const float* xs, float* rt, float* xt, float* out,
                   int d, int k) {
  __shared__ float tile[kEdge][kEdge + 1];
  __shared__ float scalars[3];                  // r, amr, β of the column
  extern __shared__ float w[];                  // k floats: row i of xsᵀ
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = (d + kEdge - 1) / kEdge;

  // R = Lᵀ on and above the diagonal (from L's lower tiles), and xsᵀ
  for (int tr = 0; tr < n_tiles; ++tr)
    for (int tc = tr; tc < n_tiles; ++tc)
      transpose_tile(l, d, rt, d, tr * kEdge, tc * kEdge, d, d, tile);
  for (int tr = 0; tr < n_tiles; ++tr)
    for (int tc = 0; tc * kEdge < k; ++tc)
      transpose_tile(xs, d, xt, k, tr * kEdge, tc * kEdge, d, k, tile);

  const int sub = lane % kLanesPerRow;
  const int group = lane / kLanesPerRow;
  for (int i = 0; i < d; ++i) {
    if (warp == 0) {
      float part = 0.0f;
      for (int q = lane; q < k; q += 32) {
        const float v = xt[at(i, q, k)];
        w[q] = v;
        part = fmaf(v, v, part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) {
        const float s = part;
        const float s_ = s > 0.0f ? s : 1.0f;   // w == 0 ⇒ t == 0, updates vanish
        const float a = rt[at(i, i, d)];
        const float r = sqrtf(a * a + s);
        scalars[0] = r;
        scalars[1] = -s / (r + a);
        scalars[2] = (r + a) / (r * s_);
      }
    }
    __syncthreads();
    const float amr = scalars[1];
    const float beta = scalars[2];
    for (int base = i + 1 + warp * kRowsPerWarp; base < d; base += kWarps * kRowsPerWarp) {
      const int j = base + group;
      const bool live = j < d;
      float dot = 0.0f;
      if (live)
        for (int q = sub; q < k; q += kLanesPerRow) dot = fmaf(xt[at(j, q, k)], w[q], dot);
#pragma unroll
      for (int off = 1; off < kLanesPerRow; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (live) {
        const float col = rt[at(i, j, d)];
        const float t = amr * col + dot;
        if (sub == 0) rt[at(i, j, d)] = col - (beta * amr) * t;
        const float bt = beta * t;
        for (int q = sub; q < k; q += kLanesPerRow) {
          float* x = xt + at(j, q, k);
          *x = *x - bt * w[q];
        }
      }
    }
    if (threadIdx.x == 0) rt[at(i, i, d)] = scalars[0];
    __syncthreads();
  }

  // L' = Rᵀ on and below the diagonal; above it, L as it came
  for (int tr = 0; tr < n_tiles; ++tr)
    for (int tc = 0; tc <= tr; ++tc)
      transpose_tile(rt, d, out, d, tr * kEdge, tc * kEdge, d, d, tile);
  for (int r = warp; r < d; r += kWarps)
    for (int c = r + 1 + lane; c < d; c += 32) out[at(r, c, d)] = l[at(r, c, d)];
}

}  // namespace

extern "C" int afl_chol_rank_update_f32(const void* l, const void* xs, void* rt, void* xt,
                                        void* out, int d, int k, void* stream) {
  const int bytes = k * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      rank_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_update_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(l), static_cast<const float*>(xs), static_cast<float*>(rt),
      static_cast<float*>(xt), static_cast<float*>(out), d, k);
  return static_cast<int>(cudaGetLastError());
}
