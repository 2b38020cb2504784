// Rank-k update of a lower Cholesky factor, in f32 and in f64 (one
// template, instantiated twice):
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
// Every product is a plain FMA in the input's type (the f64 instance uses
// the card's native FP64).
//
// Design: a blocked (compact WY) sweep. Take row j's pair z_j = (L[j, :],
// xsᵀ[j, :]). Column i's step is z_j ← z_j − β_i (u_iᵀ z_j) u_i for every
// j > i, with u_i = (amr_i e_i, w_i): a reflection that touches only
// coordinate i of L and the k coordinates of xsᵀ. So the columns of a
// panel P = [p, p + nb) sweep on the panel's own nb rows alone, and their
// effect on every row below is one product Q = H_p ··· H_{p+nb−1} =
// I − V T Vᵀ, V = [diag(amr) ; W], W the nb rows w_i as each stood when
// its column was swept. Two reflectors' L coordinates never meet, so
// v_aᵀ v_b = w_a · w_b for a ≠ b, and T (nb × nb, upper triangular) follows
// from the Gram WᵀW alone: T[b][b] = β_b, T[:b, b] = −β_b T[:b, :b] (WᵀW)[:b, b]
// (LAPACK's dlarft recurrence). A zero w_b has amr_b = 0 and WᵀW[:, b] = 0,
// so its column of V·T vanishes.
//   * panel_kernel (one block of 256 threads): runs the reference's column
//     sweep on the panel's rows, L[P, P] in shared memory and each row of
//     xsᵀ[P, :] in the registers of its eight lanes, one barrier a column
//     (row i is published to shared memory for column i); the dot products
//     of the rows already swept with w_i are WᵀW's column i, so the Gram
//     comes free. It writes L[P, P] (lower) back, leaves W in place of
//     xsᵀ[P, :] (those rows are never read again), and forms T (one warp,
//     no barriers) into a scratch the wrapper allocates, with amr.
//   * trailing_kernel (a grid over the rows below the panel, kRowTile rows
//     a block of 256 threads): with l = L[j, P] and x = xsᵀ[j, :],
//     Y = l∘amr + x·Wᵀ, Y ← Y·T, L[j, P] −= Y∘amr, xsᵀ[j, :] −= Y·W. W, x
//     and T sit in shared memory; xsᵀ is read and written once a panel.
// Sequencing: the two kernels alternate on the caller's stream, with no
// host synchronisation in between (2·⌈d/nb⌉ − 1 launches a pass, after a
// copy of L into the output and one transpose of the pass's rows of xs):
// simpler than one cooperative kernel with a grid-wide barrier, which
// would also idle the other SMs during each panel. Look-ahead (the next
// panel's sweep beside this panel's trailing step) is later work.
//
// Update rows are folded in passes of at most kPass = 256 (K_PASS): a sum
// of Gram deltas is a Gram delta, so the passes are exact in exact
// arithmetic; the engine's rank budget at d = 2304 (d/16 = 144) is one
// pass. nb = kNb = 32. The panel kernel keeps 8·kPer ≥ k values of a row
// in registers (kPer = 8, 16 or 32: three instances a type, picked by the
// pass's k) and 15.1 KB of shared memory in f32, 30.2 KB in f64; the
// trailing kernel 57.9 / 115.8 KB at k = kPass (sized to the pass's k at
// launch: 21.1 KB in f32 at k = 64). The
// trailing grid's tile is kRowTile = 16 rows: at d = 2304 the first
// panel's grid has 142 blocks, more than the 132 SMs (64-row tiles would
// give 35), and 72 on average over the panels.
//
// Bound at the path's shape (d = 2304, k = 64): the update needs 2kd² =
// 0.68 GFLOP (10 us at 67 TFLOP/s f32) against 4·(2d² + kd) = 43.1 MB
// (12.85 us at 3.35 TB/s) for L, xs and L', so bytes. The critical path
// is d column steps on one SM (registers and one barrier each) plus
// d/nb = 72 trailing steps and 144 launches.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librank_update.so rank_update.cu
// The entry points launch on the caller's stream, do not synchronise,
// allocate nothing and return a CUDA error code (0 on success).

#include <cuda_runtime.h>

#include <cstddef>

#include "scalar.cuh"

namespace {

using afl::fma_;

constexpr int kThreads = 256;
constexpr int kNb = 32;                          // panel width
constexpr int kPass = 256;                       // update rows folded per pass (K_PASS)
constexpr int kLanesPerRow = 8;                  // panel sweep: lanes sharing one row
constexpr int kRowTile = 16;                     // trailing step: rows of a block
constexpr int kEdge = 32;                        // transpose tile edge
static_assert(kThreads == kNb * kLanesPerRow, "one lane group for each row of a panel");
static_assert(kThreads == kRowTile * (kNb / 2), "two Y columns a thread");

__host__ __device__ __forceinline__ size_t at(int row, int col, int ld) {
  return static_cast<size_t>(row) * ld + col;
}

// Row stride of the trailing step's tiles in shared memory: it reads W
// down its columns (an odd stride keeps them on distinct banks).
__host__ __device__ __forceinline__ int trail_ld(int k) { return (k + 31) / 32 * 32 + 1; }

template <class T>
__host__ __device__ __forceinline__ int trail_bytes(int k) {
  return ((kNb + kRowTile) * trail_ld(k) + kNb * (kNb + 1) + kNb +
          2 * kRowTile * (kNb + 1)) * static_cast<int>(sizeof(T));
}

// xt (d, kp) = the rows k0 .. k0 + kp of xs (k, d), transposed: rows of xt
// are contiguous, as the sweep reads them.
template <class T>
__global__ void transpose_kernel(const T* __restrict__ xs, T* __restrict__ xt, int d,
                                 int kp) {
  __shared__ T tile[kEdge][kEdge + 1];
  const int j0 = blockIdx.x * kEdge;
  const int q0 = blockIdx.y * kEdge;
  for (int r = threadIdx.y; r < kEdge; r += blockDim.y) {
    const int q = q0 + r, j = j0 + threadIdx.x;
    if (q < kp && j < d) tile[r][threadIdx.x] = xs[at(q, j, d)];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < kEdge; r += blockDim.y) {
    const int j = j0 + r, q = q0 + threadIdx.x;
    if (j < d && q < kp) xt[at(j, q, kp)] = tile[threadIdx.x][r];
  }
}

// The sweep of panel P = [p, p + nbw) on its own rows; then T and amr into
// ws (amr: kNb values, then T: kNb × kNb, row-major, zero outside
// nbw × nbw and below the diagonal). Row j of xsᵀ[P, :] lives in the
// registers of lane group j, kPer values a lane (entries sub, sub + 8, …;
// kp ≤ 8·kPer). Row i, the reflection's w, is published to shared memory
// by its group when column i − 1 has updated it (two buffers, so one
// barrier a column). Every group's dot product with w is also WᵀW's entry
// for a row already swept: group j < i holds w_j, so it records w_j·w_i.
template <class T, int kPer>
__global__ void __launch_bounds__(kThreads)
panel_kernel(T* __restrict__ out, T* __restrict__ xt, T* __restrict__ ws, int d, int kp,
             int p, int nbw) {
  constexpr int kRow = kLanesPerRow * kPer;
  __shared__ T wbuf[2][kRow];                    // row i of xsᵀ, for column i
  __shared__ T ls[kNb][kNb + 1];                 // L[P, P]
  __shared__ T g[kNb][kNb + 1];                  // WᵀW (above the diagonal)
  __shared__ T tm[kNb][kNb + 1];                 // T
  __shared__ T amr_s[kNb], beta_s[kNb], r_s[kNb];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int j = threadIdx.x / kLanesPerRow;
  const int sub = threadIdx.x % kLanesPerRow;

  T x[kPer];                                     // row j of xsᵀ[P, :], zero past kp
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int q = sub + kLanesPerRow * m;
    x[m] = j < nbw && q < kp ? xt[at(p + j, q, kp)] : T(0);
  }
  for (int r = warp; r < nbw; r += kThreads / 32)
    for (int c = lane; c <= r; c += 32) ls[r][c] = out[at(p + r, p + c, d)];
  if (j == 0) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) wbuf[0][sub + kLanesPerRow * m] = x[m];
  }
  __syncthreads();

  for (int i = 0; i < nbw; ++i) {
    const T* wrow = wbuf[i & 1];
    const bool below = j > i && j < nbw;
    T w[kPer];
    T s = T(0), dot = T(0);
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      w[m] = wrow[sub + kLanesPerRow * m];
      s = fma_(w[m], w[m], s);
      dot = fma_(x[m], w[m], dot);
    }
    const T col = below ? ls[j][i] : T(0);
#pragma unroll
    for (int off = 1; off < kLanesPerRow; off <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    }
    const T a = ls[i][i];                        // written only after the sweep
    const T r = afl::sqrt_(a * a + s);
    const T s_ = s > T(0) ? s : T(1);            // w == 0 ⇒ t == 0, updates vanish
    const T amr = -s / (r + a);
    const T beta = (r + a) / (r * s_);
    const T t = fma_(amr, col, dot);
    if (below) {
      const T bt = beta * t;
#pragma unroll
      for (int m = 0; m < kPer; ++m) x[m] = x[m] - bt * w[m];
    }
    if (j == i + 1) {                            // row i + 1 is final: the next w
#pragma unroll
      for (int m = 0; m < kPer; ++m) wbuf[(i + 1) & 1][sub + kLanesPerRow * m] = x[m];
    }
    __syncwarp();                                // every lane of the group has read col
    if (sub == 0) {
      if (below) ls[j][i] = col - (beta * amr) * t;
      if (j < i) g[j][i] = dot;                  // w_j · w_i
      if (j == i) {
        r_s[i] = r;
        amr_s[i] = amr;
        beta_s[i] = beta;
      }
    }
    __syncthreads();
  }

  if (j < nbw) {                                 // W, in place of xsᵀ[P, :]
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int q = sub + kLanesPerRow * m;
      if (q < kp) xt[at(p + j, q, kp)] = x[m];
    }
  }
  for (int r = warp; r < nbw; r += kThreads / 32)
    for (int c = lane; c <= r; c += 32) out[at(p + r, p + c, d)] = c == r ? r_s[r] : ls[r][c];
  if (p + nbw >= d) return;                      // no rows below: no T needed

  // T, column by column, by warp 0 (lane a owns row a); four partial sums
  // shorten each lane's chain of dependent FMAs
  if (warp == 0) {
    for (int b = 0; b < kNb; ++b) {
      T v = T(0);
      if (b < nbw && lane < b) {
        T acc[4] = {T(0), T(0), T(0), T(0)};
        int c = lane;
        for (; c + 3 < b; c += 4) {
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[m] = fma_(tm[lane][c + m], g[c + m][b], acc[m]);
        }
        for (; c < b; ++c) acc[0] = fma_(tm[lane][c], g[c][b], acc[0]);
        v = -beta_s[b] * ((acc[0] + acc[1]) + (acc[2] + acc[3]));
      } else if (b < nbw && lane == b) {
        v = beta_s[b];
      }
      __syncwarp();
      tm[lane][b] = v;
      __syncwarp();
    }
    ws[lane] = lane < nbw ? amr_s[lane] : T(0);
    for (int b = 0; b < kNb; ++b) ws[kNb + at(lane, b, kNb)] = tm[lane][b];
  }
}

template <class T>
int launch_panel(T* out, T* xt, T* ws, int d, int kp, int p, int nbw, cudaStream_t stream) {
  if (kp <= 64)
    panel_kernel<T, 8><<<1, kThreads, 0, stream>>>(out, xt, ws, d, kp, p, nbw);
  else if (kp <= 128)
    panel_kernel<T, 16><<<1, kThreads, 0, stream>>>(out, xt, ws, d, kp, p, nbw);
  else
    panel_kernel<T, kPass / kLanesPerRow><<<1, kThreads, 0, stream>>>(out, xt, ws, d, kp, p, nbw);
  return static_cast<int>(cudaGetLastError());
}

// The rows j0 .. j0 + kRowTile of the trailing part take panel P's
// transform. nbw == kNb here: only a full panel has rows below it.
template <class T>
__global__ void __launch_bounds__(kThreads)
trailing_kernel(T* __restrict__ out, T* __restrict__ xt, const T* __restrict__ ws, int d,
                int kp, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = trail_ld(kp);
  T* wm = reinterpret_cast<T*>(smem);            // [kNb][ld]: W
  T* xm = wm + kNb * ld;                         // [kRowTile][ld]: xsᵀ[j, :]
  T* tm = xm + kRowTile * ld;                    // [kNb][kNb + 1]: T
  T* amr = tm + kNb * (kNb + 1);                 // [kNb]
  T* y = amr + kNb;                              // [kRowTile][kNb + 1]: Y
  T* y2 = y + kRowTile * (kNb + 1);              // [kRowTile][kNb + 1]: Y·T
  const int j0 = p + kNb + blockIdx.x * kRowTile;
  const int rows = min(kRowTile, d - j0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int a = warp; a < kNb; a += kThreads / 32) {
    for (int q = lane; q < kp; q += 32) wm[at(a, q, ld)] = xt[at(p + a, q, kp)];
    tm[at(a, lane, kNb + 1)] = ws[kNb + at(a, lane, kNb)];
  }
  for (int r = warp; r < rows; r += kThreads / 32)
    for (int q = lane; q < kp; q += 32) xm[at(r, q, ld)] = xt[at(j0 + r, q, kp)];
  if (threadIdx.x < kNb) amr[threadIdx.x] = ws[threadIdx.x];
  __syncthreads();

  // thread (r, c0) owns columns c0 and c0 + 16 of row r of Y and of Y·T
  const int r = threadIdx.x / (kNb / 2);
  const int c0 = threadIdx.x % (kNb / 2);
  const bool live = r < rows;
  if (live) {
    T acc0 = amr[c0] * out[at(j0 + r, p + c0, d)];
    T acc1 = amr[c0 + 16] * out[at(j0 + r, p + c0 + 16, d)];
    for (int q = 0; q < kp; ++q) {
      const T xq = xm[at(r, q, ld)];
      acc0 = fma_(xq, wm[at(c0, q, ld)], acc0);
      acc1 = fma_(xq, wm[at(c0 + 16, q, ld)], acc1);
    }
    y[at(r, c0, kNb + 1)] = acc0;
    y[at(r, c0 + 16, kNb + 1)] = acc1;
  }
  __syncthreads();
  if (live) {
    T acc0 = T(0), acc1 = T(0);
    for (int a = 0; a <= c0; ++a) acc0 = fma_(y[at(r, a, kNb + 1)], tm[at(a, c0, kNb + 1)], acc0);
    for (int a = 0; a <= c0 + 16; ++a)
      acc1 = fma_(y[at(r, a, kNb + 1)], tm[at(a, c0 + 16, kNb + 1)], acc1);
    y2[at(r, c0, kNb + 1)] = acc0;
    y2[at(r, c0 + 16, kNb + 1)] = acc1;
    T* lj = out + at(j0 + r, p + c0, d);
    lj[0] = lj[0] - acc0 * amr[c0];
    lj[16] = lj[16] - acc1 * amr[c0 + 16];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * kp; e += kThreads) {
    const int rr = e / kp;
    const int q = e % kp;
    T acc = xm[at(rr, q, ld)];
#pragma unroll 8
    for (int a = 0; a < kNb; ++a) acc = fma_(-y2[at(rr, a, kNb + 1)], wm[at(a, q, ld)], acc);
    xt[at(j0 + rr, q, kp)] = acc;
  }
}

template <class T>
int rank_update(const T* l, const T* xs, T* out, T* xt, T* ws, int d, int k,
                cudaStream_t stream) {
  const int kmax = k < kPass ? k : kPass;
  cudaError_t err = cudaFuncSetAttribute(
      trailing_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, trail_bytes<T>(kmax));
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(out, l, static_cast<size_t>(d) * d * sizeof(T),
                          cudaMemcpyDeviceToDevice, stream);
  for (int k0 = 0; k0 < k && err == cudaSuccess; k0 += kPass) {
    const int kp = k - k0 < kPass ? k - k0 : kPass;
    const dim3 tgrid((d + kEdge - 1) / kEdge, (kp + kEdge - 1) / kEdge);
    transpose_kernel<T><<<tgrid, dim3(kEdge, 8), 0, stream>>>(xs + at(k0, 0, d), xt, d, kp);
    err = cudaGetLastError();
    for (int p = 0; p < d && err == cudaSuccess; p += kNb) {
      const int nbw = d - p < kNb ? d - p : kNb;
      err = static_cast<cudaError_t>(launch_panel(out, xt, ws, d, kp, p, nbw, stream));
      const int rest = d - p - nbw;
      if (rest > 0 && err == cudaSuccess) {
        trailing_kernel<T><<<(rest + kRowTile - 1) / kRowTile, kThreads, trail_bytes<T>(kp),
                             stream>>>(out, xt, ws, d, kp, p);
        err = cudaGetLastError();
      }
    }
  }
  return static_cast<int>(err);
}

}  // namespace

// xt is a (d, min(k, 256)) scratch and ws one of 32 + 32·32 values, both
// of the input's type.
#define AFL_RANK_UPDATE_ENTRY_POINT(T, SUFFIX)                                        \
  extern "C" int afl_chol_rank_update_##SUFFIX(const void* l, const void* xs,          \
                                               void* out, void* xt, void* ws, int d,   \
                                               int k, void* stream) {                  \
    return rank_update<T>(static_cast<const T*>(l), static_cast<const T*>(xs),         \
                          static_cast<T*>(out), static_cast<T*>(xt),                   \
                          static_cast<T*>(ws), d, k, static_cast<cudaStream_t>(stream)); \
  }

AFL_RANK_UPDATE_ENTRY_POINT(float, f32)
AFL_RANK_UPDATE_ENTRY_POINT(double, f64)
