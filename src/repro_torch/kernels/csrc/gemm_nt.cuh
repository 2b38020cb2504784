// One output tile of C = A·Bᵀ, or C = T − A·Bᵀ, computed by one block:
// A is (m, k) and B is (n, k), both with the reduction along their rows,
// so each operand is read where it lies (a pointer and a row stride, unit
// column stride). The epilogue is a template functor: `StoreProduct`
// writes the product, `SubtractFrom` writes T − product. T may be C
// itself: each element of T is read by the thread that writes it, before
// it writes it. panel.cu's panel_trsm and panel_update run on it, in f32
// and f64; blocked.cu keeps the tile loop of tile_gemm.cuh.
//
// f64 (DmmaTile, dmma_tile): the FP64 tensor cores (DMMA) through
// mma.sync.m16n8k16, the widest f64 shape sm_90's PTX has (m8n8k4,
// m16n8k4 and m16n8k8 are the others, at the same rate); its products and
// sums are f64. wgmma is no option in either type: it takes no f64
// operands, and f32 only as TF32. Each warp owns a 32×32 sub-tile (2 × 4
// mma tiles of 16×8), so each fragment read from shared memory feeds two
// or four mma. The operands come through a ring of shared-memory stages
// filled by cp.async: 16-byte cp.async.cg where an operand's base and row
// stride in bytes are multiples of 16, else one value at a time; rows are
// padded by 4 values, so the fragment reads of a half-warp hit 32
// different banks. T's tile is fetched into shared memory while the last
// slices compute, so the epilogue waits on no global load.
//
// f32 (FfmaTile, ffma_tile): IEEE FFMA (no TF32), one FMA chain over k in
// order for each output element. Each thread owns TM × TN outputs made of
// 4×4 blocks 4·TY rows (4·TX columns) apart, so a warp of 4 × 8 threads
// reads its operands as 16-byte words from 4 (8) neighbouring addresses:
// no bank conflicts, and one word feeds 4·TN (4·TM) FMAs. The operands are
// staged k-major, transposed on the way from registers to shared memory,
// in two stages: the next slice's global loads are in flight in registers
// while the current slice computes. (A cp.async ring cannot transpose but
// value by value, and its 4-byte copies ran slower than this.)
//
// Ragged edges are masked on the way in (zeros past m, n or k, which add
// nothing) and on the way out. Nothing is atomic, and the f64 tile's
// split sums (KS > 1) are added in a fixed order: the same inputs give the
// same bits on every run.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cp_async.cuh"

namespace afl_gemm {

// One operand or output: base, row stride, and whether 16-byte vector
// accesses are allowed (base and row stride in bytes multiples of 16).
template <class T>
struct Matrix {
  const T* p;
  int ld;
  bool vec;
};

template <class T>
struct Problem {
  Matrix<T> a;      // (m, k)
  Matrix<T> b;      // (n, k)
  Matrix<T> t;      // (m, n), read by SubtractFrom only
  T* c;             // (m, n), row stride ldc
  int ldc;
  bool c_vec;
  int m, n, k;
};

// The epilogues: out = f(T's value, the product's value).
struct StoreProduct {
  static constexpr bool kReadsT = false;
  template <class T>
  __device__ __forceinline__ T operator()(T, T v) const { return v; }
};

struct SubtractFrom {
  static constexpr bool kReadsT = true;
  template <class T>
  __device__ __forceinline__ T operator()(T t, T v) const { return t - v; }
};

__host__ inline bool vec16(const void* p, int ld, int itemsize) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0 &&
         (static_cast<long>(ld) * itemsize) % 16 == 0;
}

template <class T>
__device__ __forceinline__ const T* at(const Matrix<T>& x, int row, int col) {
  return x.p + static_cast<size_t>(row) * x.ld + col;
}

// ---- the output side, shared by both types ---------------------------------

// 16 bytes from and to aligned memory: four floats or two doubles.
__device__ __forceinline__ void load16(const float* s, float (&v)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(s);
  v[0] = w.x;
  v[1] = w.y;
  v[2] = w.z;
  v[3] = w.w;
}
__device__ __forceinline__ void load16(const double* s, double (&v)[2]) {
  const double2 w = *reinterpret_cast<const double2*>(s);
  v[0] = w.x;
  v[1] = w.y;
}
__device__ __forceinline__ void store16(float* d, const float (&v)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* d, const double (&v)[2]) {
  *reinterpret_cast<double2*>(d) = make_double2(v[0], v[1]);
}

// V consecutive outputs of row `row` from column `col` (a multiple of V):
// the epilogue on the product and T's staged values, then the store,
// masked past m and n; a 16-byte word where V = 16 / sizeof(T) and C is
// aligned.
template <class T, class Epi, int V>
__device__ __forceinline__ void write_out(const Problem<T>& p, Epi epi, int row, int col,
                                          const T (&v)[V], const T* staged) {
  constexpr bool kWord = V * sizeof(T) == 16;
  if (row >= p.m) return;
  T out[V];
#pragma unroll
  for (int q = 0; q < V; ++q) out[q] = epi(Epi::kReadsT ? staged[q] : T(0), v[q]);
  T* dst = p.c + static_cast<size_t>(row) * p.ldc + col;
  if (kWord && p.c_vec && col + V <= p.n) {
    if constexpr (kWord) store16(dst, out);
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q)
      if (col + q < p.n) dst[q] = out[q];
  }
}

// ---- cp.async (cp_async.cuh) -----------------------------------------------

using afl::cp_async16;
using afl::cp_async8;
using afl::cp_async_commit;
using afl::cp_async_wait;

// Stage rows r0 .. r0 + ROWS − 1 and columns c0 .. c0 + COLS − 1 of x into
// dst with row stride LD, zeros past `rows` and `cols`. Neighbouring
// threads copy neighbouring 16-byte words (two values) of a row; where x
// is not 16-byte aligned, each value on its own. The block's NT threads
// share the copies.
template <int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void stage_tile(double* dst, const Matrix<double>& x, int r0,
                                           int c0, int rows, int cols) {
  static_assert(COLS % 2 == 0 && LD % 2 == 0, "rows of whole words");
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * COLS / 2; e += NT) {
    const int r = e / (COLS / 2);
    const int c = (e % (COLS / 2)) * 2;
    const int gr = r0 + r;
    const int gc = c0 + c;
    double* d = dst + r * LD + c;
    if (x.vec) {
      const int n = gr < rows ? min(max(cols - gc, 0), 2) : 0;
      cp_async16(d, n ? at(x, gr, gc) : x.p, 8 * n);
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool ok = gr < rows && gc + q < cols;
        cp_async8(d + q, ok ? at(x, gr, gc + q) : x.p, ok ? 8 : 0);
      }
    }
  }
}

// ---- f64: DMMA -------------------------------------------------------------

// D (16×8) += A (16×16) · B (16×8), f64. Fragments (g = lane / 4,
// t = lane % 4): a[q] is A[g + 8·(q % 2)][t + 4·(q / 2)], b[q] is
// B[t + 4·q][g], d[q] is D[g + 8·(q / 2)][2t + q % 2].
__device__ __forceinline__ void dmma_16x8x16(double (&d)[4], const double (&a)[8],
                                             const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// KS groups of WM × WN warps, each warp owning a 32×32 sub-tile; the
// reduction runs BK indices per stage through a ring of S stages, A's rows
// then B's rows, each row padded by 4 values. With KS > 1 each group takes
// its own BK / KS indices of every slice, so a warp's chain of mma is KS
// times shorter, and the groups' sums are added in group order through
// shared memory (the ring, once it is spent) at the end. T's tile
// (SubtractFrom), rows padded to BN + 8 values, sits in the stages before
// the last where it fits and KS = 1, else in a region of its own after
// the ring.
template <int WM, int WN, int BK, int S, int KS = 1>
struct DmmaTile {
  static_assert(BK % (16 * KS) == 0 && S >= 2, "tile shape");
  static constexpr int kWarps = WM * WN;                   // warps of one group
  static constexpr int kThreads = 32 * kWarps * KS;
  static constexpr int kRows = 32 * WM, kCols = 32 * WN, kStep = BK, kStages = S;
  static constexpr int kSplit = KS;
  static constexpr int kLd = BK + 4;
  static constexpr int kStage = (kRows + kCols) * kLd;     // values per stage
  static constexpr int kLdT = kCols + 8;
  static constexpr bool kTInRing = KS == 1 && kRows * kLdT <= (S - 1) * kStage;
  static_assert((KS - 1) * kWarps * 32 * 32 <= S * kStage, "the groups' sums fit the ring");
  template <class Epi>
  static constexpr int smem_bytes() {
    return (S * kStage + (Epi::kReadsT && !kTInRing ? kRows * kLdT : 0)) *
           static_cast<int>(sizeof(double));
  }
};

// The block's tile at rows i0.., columns j0.. of C, f64. `smem` holds
// Tile::smem_bytes<Epi>(), 16-byte aligned.
//
// Stage kt holds slice kt; the ring is rotated so that the last slice
// sits in the last stage. T's tile is fetched once no operand slice is
// left to fetch: into the stages before the last while the last slice
// computes, or into its own region while the last S − 1 slices compute.
// Either way the epilogue reads T from shared memory: no output waits on
// a global load that a store before it might alias.
template <class Tile, class Epi>
__device__ __forceinline__ void dmma_tile(const Problem<double>& p, int i0, int j0, Epi epi,
                                          double* smem) {
  constexpr int BM = Tile::kRows, BN = Tile::kCols, BK = Tile::kStep, LD = Tile::kLd;
  constexpr int S = Tile::kStages, NT = Tile::kThreads, KS = Tile::kSplit;
  constexpr int kGroupK = BK / KS;                  // indices of a slice a group takes
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32 % Tile::kWarps;
  const int group = threadIdx.x / (32 * Tile::kWarps);
  const int g = lane / 4, t = lane % 4;
  const int wr = (warp % (BM / 32)) * 32, wc = (warp / (BM / 32)) * 32;   // the warp's sub-tile

  const int kt_n = (p.k + BK - 1) / BK;
  const int rot = S - 1 - (kt_n - 1) % S;
  auto stage = [&](int kt) { return smem + ((kt + rot) % S) * Tile::kStage; };
  auto load = [&](int kt) {
    double* s = stage(kt);
    stage_tile<BM, BK, LD, NT>(s, p.a, i0, kt * BK, p.m, p.k);
    stage_tile<BN, BK, LD, NT>(s + BM * LD, p.b, j0, kt * BK, p.n, p.k);
  };
  double* const t_tile = Tile::kTInRing ? smem : smem + S * Tile::kStage;
  const int kt_t = Tile::kTInRing ? kt_n - 1 : max(kt_n - S + 1, 0);

  double acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.0;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < kt_n) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<S - 2>();       // slice kt has landed
    __syncthreads();              // and every warp is done with slice kt − 1
    if (kt + S - 1 < kt_n) load(kt + S - 1);    // into the stage slice kt − 1 used
    if constexpr (Epi::kReadsT) {
      if (kt == kt_t) stage_tile<BM, BN, Tile::kLdT, NT>(t_tile, p.t, i0, j0, p.m, p.n);
    }
    cp_async_commit();
    const double* as = stage(kt);
    const double* bs = as + BM * LD;
#pragma unroll
    for (int k16 = 0; k16 < kGroupK; k16 += 16) {
      const int kk = group * kGroupK + k16;
      double af[2][8], bf[4][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          af[mi][q] = as[(wr + mi * 16 + g + 8 * (q % 2)) * LD + kk + t + 4 * (q / 2)];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) bf[ni][q] = bs[(wc + ni * 8 + g) * LD + kk + t + 4 * q];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) dmma_16x8x16(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  if constexpr (Epi::kReadsT || KS > 1) {
    cp_async_wait<0>();
    __syncthreads();
  }
  if constexpr (KS > 1) {
    // Groups 1.. leave their sums in the spent ring, one value a lane in
    // turn; group 0 adds them in group order and writes the tile.
    double* const sums = smem + warp * 32 * 32 + lane;
    if (group > 0) {
#pragma unroll
      for (int v = 0; v < 32; ++v)
        sums[((group - 1) * Tile::kWarps * 32 + v) * 32] = acc[v / 16][v / 4 % 4][v % 4];
    }
    __syncthreads();
    if (group > 0) return;
#pragma unroll
    for (int s = 0; s < KS - 1; ++s)
#pragma unroll
      for (int v = 0; v < 32; ++v)
        acc[v / 16][v / 4 % 4][v % 4] += sums[(s * Tile::kWarps * 32 + v) * 32];
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + mi * 16 + g + 8 * h;
        const int c = wc + ni * 8 + 2 * t;
        const double v[2] = {acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]};
        write_out(p, epi, i0 + r, j0 + c, v, t_tile + r * Tile::kLdT + c);
      }
}

// ---- f32: FFMA -------------------------------------------------------------

// TY × TX threads in warps of 4 × 8, each owning TM × TN outputs (4 or 8
// each way) made of 4×4 blocks 4·TY rows (4·TX columns) apart; the
// reduction runs kStep = BK indices per stage.
template <int TY, int TX, int TM, int TN, int BK>
struct FfmaTile {
  static_assert(TY % 4 == 0 && TX % 8 == 0 && TM % 4 == 0 && TN % 4 == 0 && BK % 4 == 0,
                "tile shape");
  static constexpr int kTY = TY, kTX = TX, kTM = TM, kTN = TN;
  static constexpr int kThreads = TY * TX;
  static constexpr int kRows = TY * TM, kCols = TX * TN, kStep = BK;
  template <class Epi>
  static constexpr int smem_bytes() {
    return 2 * BK * (kRows + kCols + 8) * static_cast<int>(sizeof(float));
  }
};

// Four values of row `row` from column `col` (a multiple of 4) of x, zeros
// past `rows` and `cols`; one 16-byte load where x is aligned.
__device__ __forceinline__ float4 load4(const Matrix<float>& x, int row, int col, int rows,
                                        int cols) {
  if (row >= rows) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* src = at(x, row, col);
  if (x.vec && col + 4 <= cols) return *reinterpret_cast<const float4*>(src);
  float4 v;
  v.x = col < cols ? src[0] : 0.f;
  v.y = col + 1 < cols ? src[1] : 0.f;
  v.z = col + 2 < cols ? src[2] : 0.f;
  v.w = col + 3 < cols ? src[3] : 0.f;
  return v;
}

// The block's tile at rows i0.., columns j0.. of C, f32. The operands are
// staged k-major (as[k][i], bs[k][j]; rows padded by 4, so the transposing
// stores and the 16-byte fragment reads are conflict-free) in two stages:
// the next slice's global loads are held in registers while the current
// slice computes, then stored into the other stage behind one barrier.
// `smem` holds Tile::smem_bytes<Epi>(), 16-byte aligned.
template <class Tile, class Epi>
__device__ __forceinline__ void ffma_tile(const Problem<float>& p, int i0, int j0, Epi epi,
                                          float* smem) {
  constexpr int TY = Tile::kTY, TX = Tile::kTX, TM = Tile::kTM, TN = Tile::kTN;
  constexpr int BM = Tile::kRows, BN = Tile::kCols, BK = Tile::kStep, NT = Tile::kThreads;
  constexpr int LA = BM + 4, LB = BN + 4;
  constexpr int kPer = BK / 4;                      // 16-byte words per staged row
  constexpr int kWordsA = BM * kPer, kWordsB = BN * kPer;
  constexpr int kLoadsA = (kWordsA + NT - 1) / NT, kLoadsB = (kWordsB + NT - 1) / NT;
  float* const as = smem;                           // [2][BK][LA]
  float* const bs = smem + 2 * BK * LA;             // [2][BK][LB]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tx = (warp % (TX / 8)) * 8 + lane % 8;
  const int ty = (warp / (TX / 8)) * 4 + lane / 8;

  float4 ra[kLoadsA], rb[kLoadsB];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kLoadsA; ++l) {
      const int e = threadIdx.x + l * NT;
      if (e < kWordsA) ra[l] = load4(p.a, i0 + e / kPer, k0 + (e % kPer) * 4, p.m, p.k);
    }
#pragma unroll
    for (int l = 0; l < kLoadsB; ++l) {
      const int e = threadIdx.x + l * NT;
      if (e < kWordsB) rb[l] = load4(p.b, j0 + e / kPer, k0 + (e % kPer) * 4, p.n, p.k);
    }
  };
  auto stash = [&](int buf) {
    float* a = as + buf * BK * LA;
    float* b = bs + buf * BK * LB;
#pragma unroll
    for (int l = 0; l < kLoadsA; ++l) {
      const int e = threadIdx.x + l * NT;
      if (e < kWordsA) {
        const int r = e / kPer, kc = (e % kPer) * 4;
        a[kc * LA + r] = ra[l].x;
        a[(kc + 1) * LA + r] = ra[l].y;
        a[(kc + 2) * LA + r] = ra[l].z;
        a[(kc + 3) * LA + r] = ra[l].w;
      }
    }
#pragma unroll
    for (int l = 0; l < kLoadsB; ++l) {
      const int e = threadIdx.x + l * NT;
      if (e < kWordsB) {
        const int r = e / kPer, kc = (e % kPer) * 4;
        b[kc * LB + r] = rb[l].x;
        b[(kc + 1) * LB + r] = rb[l].y;
        b[(kc + 2) * LB + r] = rb[l].z;
        b[(kc + 3) * LB + r] = rb[l].w;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int kt_n = (p.k + BK - 1) / BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < kt_n) fetch((kt + 1) * BK);     // in flight while this slice computes
    const float* a = as + buf * BK * LA + ty * 4;
    const float* b = bs + buf * BK * LB + tx * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        float w[4];
        load16(a + kk * LA + h * 4 * TY, w);
#pragma unroll
        for (int q = 0; q < 4; ++q) av[4 * h + q] = w[q];
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        float w[4];
        load16(b + kk * LB + h * 4 * TX, w);
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[4 * h + q] = w[q];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < kt_n) stash(buf ^ 1);           // the stage slice kt − 1 used
    __syncthreads();
  }

  // Four rows at a time: every load of T first, then the stores (T may be
  // C itself, so a load after a store would wait for it).
#pragma unroll
  for (int g = 0; g < TM / 4; ++g) {
    float t[4][TN] = {};
    if constexpr (Epi::kReadsT) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 w = load4(p.t, i0 + g * 4 * TY + ty * 4 + i, j0 + h * 4 * TX + tx * 4,
                                 p.m, p.n);
          t[i][4 * h] = w.x;
          t[i][4 * h + 1] = w.y;
          t[i][4 * h + 2] = w.z;
          t[i][4 * h + 3] = w.w;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float v[4] = {acc[4 * g + i][4 * h], acc[4 * g + i][4 * h + 1],
                            acc[4 * g + i][4 * h + 2], acc[4 * g + i][4 * h + 3]};
        write_out(p, epi, i0 + g * 4 * TY + ty * 4 + i, j0 + h * 4 * TX + tx * 4, v,
                  &t[i][4 * h]);
      }
  }
}

}  // namespace afl_gemm
