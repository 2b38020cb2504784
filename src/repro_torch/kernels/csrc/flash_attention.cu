// Flash attention: causal / GQA / sliding-window attention with the online
// softmax, so the Sq × Skv logits never reach device memory:
//
//   q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D)  ->  o (B, Hq, Sq, D)
//   o[b, h, s] = softmax_k(scale · q[b, h, s] · k[b, h / group, k]ᵀ, masked)
//                · v[b, h / group]
//
// with group = Hq / Hkv. Query row s sits at absolute position
// t = q_offset + s; key k is visible when k < Skv, k <= t (causal) and
// k > t − window (with a window). Masked logits are −1e30 and their
// probabilities exactly 0; a row that sees no key comes out as zeros.
// Inputs are f32 or bf16, each with its own strides (the head dim
// contiguous); bf16 stays bf16 in shared memory and is widened to f32 when
// read, every product is a plain f32 FMA (no TF32, no mma: the f32
// tolerance, rtol 2e-5 / atol 4e-4, is too tight for a 3×TF32 split), exp
// is the accurate expf, and the output is written in the input's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (kernel body _flash_kernel). The TPU version walks the kv
// tiles as the sequential innermost grid axis, carrying (m, l, acc) in VMEM
// scratch from one grid step to the next, takes causal, window, q_offset and
// the key length as compile-time constants (one compile per value), pads S
// and D to block multiples, and maps each query head onto its kv head in the
// BlockSpec index map. Here causal, window, q_offset and the lengths are
// runtime arguments (a decode step moves q_offset every token), and the rows
// of one (batch, kv head) are packed across its GQA group: row ρ is query
// position ρ / group of query head kv_head · group + ρ % group, so each key
// and value is read once for the whole group. With rows = group · Sq,
// launch() picks one of three regimes:
//
//   * rows <= 16, decode (split-KV): the band of keys some row sees, from
//     the first to the last visible key, is cut into chunks
//     (kernels/flash_attention.py:decode_plan, at least two blocks an SM),
//     and flash_decode_kernel's block (4 warps) streams one chunk of one
//     (batch, kv head) for all of its rows. Each warp takes 4 keys at a
//     time, their keys and values loaded together: each lane holds D/32
//     columns of them (16-byte loads, the warp's loads one contiguous run),
//     the dot products are summed across the warp by shuffles, and (m, l,
//     acc) stay in registers (templated on 2, 8 or 16 rows). The 4 warps merge
//     through shared memory; with several chunks the block writes its
//     partial (m, l, unnormalised acc) to a workspace the wrapper allocates,
//     and flash_merge_kernel rescales the partials by their max and writes
//     o. A chunk that sees no key adds nothing. Bound: the bytes of K and V
//     in the band.
//   * rows <= 32 (the trainer's forward, Sq = Skv = 32): flash_tile_kernel
//     with BQ = BK = 32 and 128 threads, so no thread's rows lie past the
//     end and no key tile is mostly padding; several blocks share an SM,
//     each with its Q, K and V loads in flight at once. Bound: bytes.
//   * otherwise (prefill): flash_tile_kernel with BQ = BK = 64 and 256
//     threads. Q, and K and V tiles through a ring of two slots, are staged
//     by cp.async as they lie (16 bytes of f32, 8 of bf16, value by value
//     where strides do not allow it): K of tile t + 1 is in flight while the
//     softmax and P·V of tile t run, V of tile t + 1 while S of tile t + 1
//     runs. 16 row lanes × 16 key lanes, a warp 4 row lanes × 8 key lanes:
//     each thread holds a 4 × 4 block of S in registers, and each of its 8
//     16-byte reads from shared memory a step is 4 (8) distinct words, one
//     wavefront each, for 64 FMAs. The row max and sum are shuffles across
//     a warp's 8 key lanes and one exchange with the pair's other warp; P
//     goes through shared memory to P·V, which adds into the thread's 4
//     rows × D/16 columns of acc. At D = 256 the block holds Q, two slots
//     and P, 214 KB. Bound: the f32 FMAs.
//
// In every regime q is staged as it is and the scale multiplies the logits;
// the block computes the key band its rows can see and
// loops over it only; keys outside a row's band are masked by position,
// and the ragged ends of Sq, Skv and D are bounds checks, not padding
// copies. The head dim is a template, D in {64, 128, 256}; another head dim
// (the reference tests use 80) runs in the next one with its extra columns
// zero on load and never stored, as the reference pads D to 128.
//
// Bound on an H100 SXM: the function needs 4·D flops for each visible
// (query, key) pair of each query head (QKᵀ and PV), at 67 TFLOP/s f32,
// against q, o and the keys and values some row sees, each moved once, at
// 3.35 TB/s. The serve path's prefill (B 4, Hq 16, Hkv 8, S 2048, D 256)
// is operations-bound: 137.6 GFLOP (2.05 ms) for a global layer, 103.2
// GFLOP (1.54 ms) for a window of 1024. Its decode step (Sq 1, Skv 2064)
// is bytes-bound: 134 MB of K and V (40 us) for a global layer, 67 MB (20
// us) for a local one. The trainer's forward (B 64, H 36, S 32, D 64) is
// bytes-bound: 75.5 MB (22.5 us).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Each entry point launches on the caller's stream (two kernels for a
// split decode), does not synchronise, allocates nothing and returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr float kMasked = -1e30f;
constexpr int kDecodeMaxRows = 16;   // kernels/flash_attention.py:DECODE_MAX_ROWS
constexpr int kShortMaxRows = 32;
constexpr int kDecodeWarps = 4;
constexpr int kDecodeKeys = 4;       // keys a decode warp takes at a time
constexpr unsigned kFull = 0xffffffffu;

// Element strides of dims 0..2 (batch, head, position); dim 3 is contiguous.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

struct Problem {
  int hkv, group, skv, d;
  int rows;              // group · sq packed rows per (batch, kv head)
  float scale;
  int causal, has_window, window, q_offset;
  int vec;               // rows and strides of q, k, v allow 4-element loads
  int vec_o;             // o allows 4-element stores
};

// decode: keys [lo, hi) in chunks of `chunk`; chunk s is blockIdx.x = s
struct Split {
  int lo, hi, chunk;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// four consecutive values (16 bytes of f32, 8 of bf16, aligned) as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// one 4-value chunk into shared memory: 16 bytes of f32, 8 of bf16; zeros
// where !ok
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  afl::cp_async16(dst, src, ok ? 16 : 0);
}
__device__ __forceinline__ void copy4(__nv_bfloat16* dst, const __nv_bfloat16* src, bool ok) {
  afl::cp_async8(dst, src, ok ? 8 : 0);
}
__device__ __forceinline__ void put(float* dst, const float* src, bool ok) {
  *dst = ok ? *src : 0.f;
}
__device__ __forceinline__ void put(__nv_bfloat16* dst, const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.f);
}

// Row ρ of q (or o) of kv head hk: query head hk · group + ρ % group,
// position ρ / group.
template <typename T>
__device__ __forceinline__ T* packed_row(T* base, const long long (&s)[3], const Problem& pb,
                                         int b, int hk, int rho) {
  const int h = hk * pb.group + rho % pb.group;
  return base + b * s[0] + h * s[1] + static_cast<long long>(rho / pb.group) * s[2];
}

// Rows r0 .. r0 + ROWS − 1 of a key (value) head into dst (row stride LD),
// zeros for rows past `limit` and columns past d: cp.async where `vec`,
// else value by value.
template <typename T, int D, int ROWS, int LD, int NT>
__device__ __forceinline__ void stage_kv(T* dst, const T* __restrict__ base, long long rs,
                                         int r0, int limit, int d, int vec) {
  constexpr int kChunks = ROWS * D / 4;
#pragma unroll
  for (int e = threadIdx.x; e < kChunks; e += NT) {
    const int r = e / (D / 4);
    const int c = (e % (D / 4)) * 4;
    const int kp = r0 + r;
    const bool row_ok = kp < limit;
    T* to = dst + r * LD + c;
    const T* from = base + static_cast<long long>(row_ok ? kp : 0) * rs + (c < d ? c : 0);
    if (vec) {
      copy4(to, from, row_ok && c < d);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) put(to + u, from + u, row_ok && c + u < d);
    }
  }
}

// Packed rows row0 .. row0 + ROWS − 1 of q into dst (row stride LD) as they
// are, zeros past nrows and d: cp.async where `vec`, else value by value.
template <typename T, int D, int ROWS, int LD, int NT>
__device__ __forceinline__ void stage_q(T* dst, const T* __restrict__ q, const Strides& st,
                                        const Problem& pb, int b, int hk, int row0, int nrows) {
  constexpr int kChunks = ROWS * D / 4;
#pragma unroll
  for (int e = threadIdx.x; e < kChunks; e += NT) {
    const int r = e / (D / 4);
    const int c = (e % (D / 4)) * 4;
    const bool row_ok = r < nrows;
    T* to = dst + r * LD + c;
    const T* from = packed_row(q, st.q, pb, b, hk, row0 + (row_ok ? r : 0)) + (c < pb.d ? c : 0);
    if (pb.vec) {
      copy4(to, from, row_ok && c < pb.d);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) put(to + u, from + u, row_ok && c + u < pb.d);
    }
  }
}

// ---- tile regimes (short sequences, prefill) -------------------------------

template <typename T, int D, int BQ, int BK, int NT>
struct TileShape {
  static constexpr int kCL = 16;                       // key lanes: 8 in each of two warps
  static constexpr int kRL = NT / kCL;                 // row lanes: 4 in each warp
  static constexpr int kTM = BQ / kRL;                 // rows a thread
  static constexpr int kTN = BK / kCL;                 // keys a thread in S
  static constexpr int kTC = D / (4 * kCL);            // 4-column chunks a thread in acc
  static constexpr int kLD = D + 16 / sizeof(T);       // Q, K, V rows: 16-byte shift a row
  static constexpr int kPS = BK + 8;                   // P rows (f32)
  static constexpr size_t kBytes = size_t(BQ + 2 * BK) * kLD * sizeof(T) +
                                   sizeof(float) * (size_t(BQ) * kPS + 4 * BQ);
  static_assert(kTM * kRL == BQ && kTN * kCL == BK && kTC >= 1 && NT % 64 == 0, "tile");
};

template <typename T, int D, int BQ, int BK, int NT>
__global__ void __launch_bounds__(NT)
flash_tile_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, Strides st, Problem pb, int tiles) {
  using S = TileShape<T, D, BQ, BK, NT>;
  constexpr int CL = S::kCL, RL = S::kRL, TM = S::kTM, TN = S::kTN, TC = S::kTC;
  constexpr int LD = S::kLD, PS = S::kPS;

  extern __shared__ float4 smem4[];
  T* sQ = reinterpret_cast<T*>(smem4);
  T* sK = sQ + BQ * LD;                              // ring slot 0: K tiles
  T* sV = sK + BK * LD;                              // ring slot 1: V tiles
  float* sP = reinterpret_cast<float*>(sV + BK * LD);  // [BQ][PS] probabilities
  float* sMax = sP + BQ * PS;                        // [2][BQ] each warp half's row max
  float* sSum = sMax + 2 * BQ;                       // [2][BQ] ... and row sum

  // a warp is 4 row lanes × 8 key lanes; the two warps of a pair hold the
  // 16 key lanes of the same 4 row lanes
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pair = warp & 1;
  const int cl = pair * 8 + (lane & 7);
  const int rl = (warp >> 1) * 4 + (lane >> 3);
  // late (long-band) tiles first: under a causal mask they have the most work
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x % tiles);
  const int bh = static_cast<int>(blockIdx.x / tiles);
  const int b = bh / pb.hkv;
  const int hk = bh % pb.hkv;
  const int row0 = tile * BQ;
  const int nrows = min(BQ, pb.rows - row0);

  // the keys this tile's rows can see
  const int s_lo = pb.q_offset + row0 / pb.group;
  const int s_hi = pb.q_offset + (row0 + nrows - 1) / pb.group;
  int kv_lo = 0;
  int kv_hi = pb.skv;
  if (pb.causal) kv_hi = min(kv_hi, s_hi + 1);
  if (pb.has_window) kv_lo = max(kv_lo, s_lo - pb.window + 1);
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;
  const T* kbase = k + b * st.k[0] + hk * st.k[1];
  const T* vbase = v + b * st.v[0] + hk * st.v[1];

  // groups: Q with the first K tile, then the first V tile
  stage_q<T, D, BQ, LD, NT>(sQ, q, st, pb, b, hk, row0, nrows);
  if (n_tiles > 0) stage_kv<T, D, BK, LD, NT>(sK, kbase, st.k[2], kv_lo, pb.skv, pb.d, pb.vec);
  afl::cp_async_commit();
  if (n_tiles > 0) stage_kv<T, D, BK, LD, NT>(sV, vbase, st.v[2], kv_lo, pb.skv, pb.d, pb.vec);
  afl::cp_async_commit();

  int pos[TM];
  float m[TM], l[TM], acc[TM][TC][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    pos[i] = pb.q_offset + (row0 + rl + RL * i) / pb.group;
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = kv_lo + t * BK;
    afl::cp_async_wait<1>();               // K of tile t has landed (V may be in flight)
    __syncthreads();

    // S = scale · Q Kᵀ: rows rl + RL·i, keys cl + CL·j
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qa[TM], kb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) qa[i] = load4(sQ + (rl + RL * i) * LD + c);
#pragma unroll
      for (int j = 0; j < TN; ++j) kb[j] = load4(sK + (cl + CL * j) * LD + c);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }
    __syncthreads();                       // every read of this K tile is done
    if (t + 1 < n_tiles)
      stage_kv<T, D, BK, LD, NT>(sK, kbase, st.k[2], kv0 + BK, pb.skv, pb.d, pb.vec);
    afl::cp_async_commit();

    // scale; mask only where the tile crosses the end of the keys or a row's band
    const bool edge = kv0 + BK > pb.skv || (pb.causal && kv0 + BK - 1 > s_lo) ||
                      (pb.has_window && kv0 <= s_hi - pb.window);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kp = kv0 + cl + CL * j;
        bool ok = !edge || kp < pb.skv;
        if (edge && pb.causal) ok = ok && kp <= pos[i];
        if (edge && pb.has_window) ok = ok && kp > pos[i] - pb.window;
        s[i][j] = ok ? s[i][j] * pb.scale : kMasked;
      }

    // online softmax: the row max over the warp's 8 key lanes, then the pair's
    float mx[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      mx[i] = kMasked;
#pragma unroll
      for (int j = 0; j < TN; ++j) mx[i] = fmaxf(mx[i], s[i][j]);
#pragma unroll
      for (int w = 4; w >= 1; w /= 2) mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], w));
      if ((lane & 7) == 0) sMax[pair * BQ + rl + RL * i] = mx[i];
    }
    __syncthreads();
    float alpha[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = rl + RL * i;
      const float m_new = fmaxf(m[i], fmaxf(sMax[r], sMax[BQ + r]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        // exactly 0 where masked, even while m_new is still the mask value
        const float p = s[i][j] > kMasked ? expf(s[i][j] - m_new) : 0.f;
        sP[r * PS + cl + CL * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 4; w >= 1; w /= 2) sum += __shfl_xor_sync(kFull, sum, w);
      if ((lane & 7) == 0) sSum[pair * BQ + r] = sum;
    }

    afl::cp_async_wait<1>();               // V of tile t has landed (K of t + 1 may not)
    __syncthreads();                       // ... and P and the sums are in

    // acc = acc · alpha + P V: rows rl + RL·i, columns 4·cl + 64·c
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = rl + RL * i;
      l[i] = alpha[i] * l[i] + (sSum[r] + sSum[BQ + r]);
#pragma unroll
      for (int c = 0; c < TC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha[i];
    }
#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      float p[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = sP[(rl + RL * i) * PS + key];
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float4 vv = load4(sV + key * LD + 4 * cl + 4 * CL * c);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][c][0] = fmaf(p[i], vv.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(p[i], vv.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(p[i], vv.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(p[i], vv.w, acc[i][c][3]);
        }
      }
    }
    __syncthreads();                       // every read of this V tile and of P is done
    if (t + 1 < n_tiles)
      stage_kv<T, D, BK, LD, NT>(sV, vbase, st.v[2], kv0 + BK, pb.skv, pb.d, pb.vec);
    afl::cp_async_commit();
  }
  afl::cp_async_wait<0>();

  // o = acc / l, 0 where no key was visible
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rl + RL * i;
    if (r >= nrows) continue;
    const float norm = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* out = packed_row(o, st.o, pb, b, hk, row0 + r);
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const int col = 4 * cl + 4 * CL * c;
      const float4 x = make_float4(acc[i][c][0] * norm, acc[i][c][1] * norm,
                                   acc[i][c][2] * norm, acc[i][c][3] * norm);
      if (pb.vec_o && col < pb.d) {
        store4(out + col, x);
      } else {
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < pb.d) narrow(out + col + e, xs[e]);
      }
    }
  }
}

// ---- decode regime (split-KV) ----------------------------------------------

// A decode lane's columns: NC chunks of W values, W·lane + 32·W·c.
template <int D>
struct Lanes {
  static constexpr int kW = D >= 128 ? 4 : 2;
  static constexpr int kNC = D / (32 * kW);
  static constexpr int kV = kW * kNC;                  // values a lane holds of a row
  static_assert(kNC >= 1 && kV * 32 == D, "head dim");
};

// One key (value) row's lane columns into x, zeros past d (or where !ok).
template <typename T, int D>
__device__ __forceinline__ void lane_row(float (&x)[Lanes<D>::kV], const T* __restrict__ row,
                                         bool ok, int d, int vec, int lane) {
  constexpr int W = Lanes<D>::kW;
#pragma unroll
  for (int c = 0; c < Lanes<D>::kNC; ++c) {
    const int col = W * lane + 32 * W * c;
    if (ok && vec && col < d) {
      if constexpr (W == 4) {
        const float4 f = load4(row + col);
        x[4 * c] = f.x;
        x[4 * c + 1] = f.y;
        x[4 * c + 2] = f.z;
        x[4 * c + 3] = f.w;
      } else {
        const float2 f = load2(row + col);
        x[2 * c] = f.x;
        x[2 * c + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < W; ++e) x[W * c + e] = ok && col + e < d ? widen(row[col + e]) : 0.f;
    }
  }
}

template <typename T, int D, int RB>
struct DecodeSmem {
  // RB rows of q as they are, then each warp's (m, l) and acc for the merge
  static size_t bytes(int rows) {
    return sizeof(T) * RB * D + sizeof(float) * kDecodeWarps * rows * (2 + D);
  }
};

// grid (chunks, B · Hkv); rows <= RB
template <typename T, int D, int RB>
__global__ void __launch_bounds__(32 * kDecodeWarps)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, Strides st, Problem pb, Split sp, float* __restrict__ ws) {
  constexpr int W = Lanes<D>::kW;
  constexpr int NV = Lanes<D>::kV;
  constexpr int NW = kDecodeWarps;
  constexpr int KS = kDecodeKeys;
  const int rows = pb.rows;
  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / pb.hkv;
  const int hk = bh % pb.hkv;
  const int k_begin = sp.lo + split * sp.chunk;
  const int k_end = min(k_begin + sp.chunk, sp.hi);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  extern __shared__ float4 smem4[];
  T* sq = reinterpret_cast<T*>(smem4);                // [RB][D]
  float* sm = reinterpret_cast<float*>(sq + RB * D);  // [NW][rows]
  float* sl = sm + NW * rows;                         // [NW][rows]
  float* sacc = sl + NW * rows;                       // [NW][rows][D]
  stage_q<T, D, RB, D, 32 * NW>(sq, q, st, pb, b, hk, 0, rows);
  afl::cp_async_commit();
  afl::cp_async_wait<0>();
  __syncthreads();

  int pos[RB];
  float m[RB], l[RB], acc[RB][NV];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    pos[r] = pb.q_offset + r / pb.group;
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < NV; ++e) acc[r][e] = 0.f;
  }
  const T* kbase = k + b * st.k[0] + hk * st.k[1];
  const T* vbase = v + b * st.v[0] + hk * st.v[1];

  for (int k0 = k_begin + KS * warp; k0 < k_end; k0 += KS * NW) {
    // the step's keys and values, all in flight together
    float kf[KS][NV], vf[KS][NV];
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      const long long kp = min(k0 + u, k_end - 1);
      lane_row<T, D>(kf[u], kbase + kp * st.k[2], k0 + u < k_end, pb.d, pb.vec, lane);
      lane_row<T, D>(vf[u], vbase + kp * st.v[2], k0 + u < k_end, pb.d, pb.vec, lane);
    }
    float s[RB][KS];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= rows) break;
      float qf[NV];
#pragma unroll
      for (int c = 0; c < Lanes<D>::kNC; ++c)
#pragma unroll
        for (int e = 0; e < W; ++e) qf[W * c + e] = widen(sq[r * D + W * lane + 32 * W * c + e]);
#pragma unroll
      for (int u = 0; u < KS; ++u) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < NV; ++e) a = fmaf(qf[e], kf[u][e], a);
#pragma unroll
        for (int w = 16; w >= 1; w /= 2) a += __shfl_xor_sync(kFull, a, w);
        const int kp = k0 + u;
        bool ok = kp < k_end;
        if (pb.causal) ok = ok && kp <= pos[r];
        if (pb.has_window) ok = ok && kp > pos[r] - pb.window;
        s[r][u] = ok ? a * pb.scale : kMasked;
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= rows) break;
      float mx = kMasked;
#pragma unroll
      for (int u = 0; u < KS; ++u) mx = fmaxf(mx, s[r][u]);
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float p[KS];
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < KS; ++u) {
        p[u] = s[r][u] > kMasked ? expf(s[r][u] - m_new) : 0.f;
        sum += p[u];
      }
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < NV; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int u = 0; u < KS; ++u) a = fmaf(p[u], vf[u][e], a);
        acc[r][e] = a;
      }
    }
  }

  // the warps' partials, merged in warp order
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= rows) break;
    if (lane == 0) {
      sm[warp * rows + r] = m[r];
      sl[warp * rows + r] = l[r];
    }
#pragma unroll
    for (int c = 0; c < Lanes<D>::kNC; ++c)
#pragma unroll
      for (int e = 0; e < W; ++e)
        sacc[(warp * rows + r) * D + W * lane + 32 * W * c + e] = acc[r][W * c + e];
  }
  __syncthreads();
  const bool direct = gridDim.x == 1;
  for (int e = threadIdx.x; e < rows * pb.d; e += 32 * NW) {
    const int r = e / pb.d;
    const int col = e % pb.d;
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm[w * rows + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm[w * rows + r] - mx);
      lsum = fmaf(f, sl[w * rows + r], lsum);
      a = fmaf(f, sacc[(w * rows + r) * D + col], a);
    }
    if (direct) {
      narrow(packed_row(o, st.o, pb, b, hk, r) + col, lsum > 0.f ? a / lsum : 0.f);
    } else {
      float* part = ws + ((static_cast<size_t>(split) * gridDim.y + bh) * rows + r) * (pb.d + 2);
      if (col == 0) {
        part[0] = mx;
        part[1] = lsum;
      }
      part[2 + col] = a;
    }
  }
}

// grid (B · Hkv): o from the chunks' partials, each rescaled by the max
template <typename T>
__global__ void __launch_bounds__(256)
flash_merge_kernel(const float* __restrict__ ws, T* __restrict__ o, Strides st, Problem pb,
                   int splits) {
  const int bh = blockIdx.x;
  const int b = bh / pb.hkv;
  const int hk = bh % pb.hkv;
  const size_t stride = static_cast<size_t>(gridDim.x) * pb.rows * (pb.d + 2);
  for (int e = threadIdx.x; e < pb.rows * pb.d; e += blockDim.x) {
    const int r = e / pb.d;
    const int col = e % pb.d;
    const float* part = ws + (static_cast<size_t>(bh) * pb.rows + r) * (pb.d + 2);
    float mx = kMasked;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part[s * stride]);
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float f = expf(part[s * stride] - mx);
      lsum = fmaf(f, part[s * stride + 1], lsum);
      a = fmaf(f, part[s * stride + 2 + col], a);
    }
    narrow(packed_row(o, st.o, pb, b, hk, r) + col, lsum > 0.f ? a / lsum : 0.f);
  }
}

// ---- launch ----------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, int BQ, int BK, int NT>
int run_tile(const T* q, const T* k, const T* v, T* o, const Strides& st, const Problem& pb,
             int b, cudaStream_t stream) {
  using S = TileShape<T, D, BQ, BK, NT>;
  const int tiles = (pb.rows + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(tiles) * b * pb.hkv;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(flash_tile_kernel<T, D, BQ, BK, NT>, S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_tile_kernel<T, D, BQ, BK, NT><<<static_cast<unsigned>(blocks), NT, S::kBytes, stream>>>(
      q, k, v, o, st, pb, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int RB>
int run_decode(const T* q, const T* k, const T* v, T* o, const Strides& st, const Problem& pb,
               const Split& sp, int splits, float* ws, int b, cudaStream_t stream) {
  const long long bhs = static_cast<long long>(b) * pb.hkv;
  if (bhs > 65535 || splits < 1 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = DecodeSmem<T, D, RB>::bytes(pb.rows);
  cudaError_t err = allow_smem(flash_decode_kernel<T, D, RB>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_kernel<T, D, RB><<<dim3(splits, static_cast<unsigned>(bhs)), 32 * kDecodeWarps,
                                  bytes, stream>>>(q, k, v, o, st, pb, sp, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  flash_merge_kernel<T><<<static_cast<unsigned>(bhs), 256, 0, stream>>>(ws, o, st, pb, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run(const T* q, const T* k, const T* v, T* o, const Strides& st, const Problem& pb,
        const Split& sp, int splits, float* ws, int b, cudaStream_t stream) {
  if (pb.rows <= 2)
    return run_decode<T, D, 2>(q, k, v, o, st, pb, sp, splits, ws, b, stream);
  if (pb.rows <= 8)
    return run_decode<T, D, 8>(q, k, v, o, st, pb, sp, splits, ws, b, stream);
  if (pb.rows <= kDecodeMaxRows)
    return run_decode<T, D, kDecodeMaxRows>(q, k, v, o, st, pb, sp, splits, ws, b, stream);
  if (pb.rows <= kShortMaxRows) return run_tile<T, D, 32, 32, 128>(q, k, v, o, st, pb, b, stream);
  return run_tile<T, D, 64, 64, 256>(q, k, v, o, st, pb, b, stream);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const void* qv, const void* kv, const void* vv, void* ov, const long long* strides,
           int b, int hq, int hkv, int sq, int skv, int d, float scale, int causal,
           int has_window, int window, int q_offset, int vec, int split_lo, int split_hi,
           int split_chunk, int splits, void* ws, void* stream_v) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || skv < 1 || d < 1 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  Problem pb{};
  pb.hkv = hkv;
  pb.group = hq / hkv;
  pb.skv = skv;
  pb.d = d;
  pb.rows = pb.group * sq;
  pb.scale = scale;
  pb.causal = causal;
  pb.has_window = has_window;
  pb.window = window;
  pb.q_offset = q_offset;
  pb.vec = vec;
  pb.vec_o = d % 4 == 0 && aligned(ov, 4 * sizeof(T)) && st.o[0] % 4 == 0 &&
             st.o[1] % 4 == 0 && st.o[2] % 4 == 0;
  const Split sp{split_lo, split_hi, split_chunk};
  if (pb.rows <= kDecodeMaxRows && (split_chunk < 1 || split_hi > skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  const T* v = static_cast<const T*>(vv);
  T* o = static_cast<T*>(ov);
  float* w = static_cast<float*>(ws);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  if (d <= 64) return run<T, 64>(q, k, v, o, st, pb, sp, splits, w, b, stream);
  if (d <= 128) return run<T, 128>(q, k, v, o, st, pb, sp, splits, w, b, stream);
  return run<T, 256>(q, k, v, o, st, pb, sp, splits, w, b, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v and o.
// has_window = 0: no window; q_offset: absolute position of query row 0;
// vec = 1 only if d % 4 == 0, every pointer of q, k and v is 16-byte (f32) /
// 8-byte (bf16) aligned and every stride is a multiple of 4. For
// group · sq <= 16 (decode), keys [split_lo, split_hi) in `splits` chunks of
// split_chunk, and with splits > 1 a workspace of splits · b · hkv ·
// group · sq · (d + 2) floats.
extern "C" int afl_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                       const long long* strides, int b, int hq, int hkv,
                                       int sq, int skv, int d, float scale, int causal,
                                       int has_window, int window, int q_offset, int vec,
                                       int split_lo, int split_hi, int split_chunk, int splits,
                                       void* ws, void* stream) {
  return launch<float>(q, k, v, o, strides, b, hq, hkv, sq, skv, d, scale, causal, has_window,
                       window, q_offset, vec, split_lo, split_hi, split_chunk, splits, ws,
                       stream);
}

extern "C" int afl_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                        const long long* strides, int b, int hq, int hkv,
                                        int sq, int skv, int d, float scale, int causal,
                                        int has_window, int window, int q_offset, int vec,
                                        int split_lo, int split_hi, int split_chunk,
                                        int splits, void* ws, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, strides, b, hq, hkv, sq, skv, d, scale, causal,
                               has_window, window, q_offset, vec, split_lo, split_hi,
                               split_chunk, splits, ws, stream);
}
