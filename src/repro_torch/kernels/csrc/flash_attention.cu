// Flash attention: causal / GQA / sliding-window attention with the online
// softmax, so the Sq × Skv logits never reach device memory:
//
//   q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D)  ->  o (B, Hq, Sq, D)
//   o[b, h, s] = softmax_k(scale · q[b, h, s] · k[b, h / group, k]ᵀ, masked)
//                · v[b, h / group]
//
// with group = Hq / Hkv. Query row s sits at absolute position
// t = q_offset + s; key k is visible when k < Skv, k <= t (causal) and
// k > t − window (with a window). With a logit softcap c > 0 each scaled
// logit x becomes tanh(x / c) · c before the mask, as the reference's sdpa
// caps them (grok1: c = 30). Masked logits are −1e30 and their
// probabilities exactly 0; a row that sees no key comes out as zeros.
// Inputs are f32 or bf16, each with its own strides (the head dim
// contiguous); the output is written in the input's type. Two instances:
//
//   * f32: every product a plain f32 FMA (no TF32, no mma: the f32
//     tolerance, rtol 2e-5 / atol 4e-4, is too tight for a 3×TF32 split),
//     exp the accurate expf; the three regimes below.
//   * bf16, on the tensor cores (its two regimes below). Its numerics:
//     every product bf16 × bf16 is exact in f32 and every sum is f32; the
//     scale multiplies the logits after the product; P is rounded once to
//     bf16 before P·V, and l is summed from that same rounded P, so the
//     weights applied to V sum to one; the output is rounded once to bf16.
//     Held to attention in f32 on the same bf16 inputs within 1e-2 of its
//     largest |value| (chip_smoke.py's ATTN_BF16_REL; the readings are in
//     PERF.md §6), and to the plain twins of its two schedules
//     (ref.mha_tile_bf16_ref, ref.mha_split_bf16_ref).
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
// launch() picks the instance's regime (kernels/flash_attention.py:regime
// names them). f32:
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
//     by cp.async as they lie (16 bytes at a time, value by value where
//     strides do not allow it): K of tile t + 1 is in flight while the
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
// bf16 (flash_mma_decode_kernel, flash_wgmma_kernel; tensor_core.cuh has
// the instructions and their fragment layouts):
//
//   * rows <= 16, decode (split-KV) on mma.sync m16n8k16: the same chunks
//     (decode_plan), workspace and flash_merge_kernel as f32. The packed
//     rows are the A tile, zeros past `rows` and never stored (wgmma's 64
//     rows would waste at least 75% of qwen3's 8 or granite's 3). A block
//     stages 64 keys and values a step by cp.async into a ring of two
//     slots, rows padded by 16 bytes (ldmatrix without bank conflicts);
//     each of its 4 warps takes 16 of them: S = Q Kᵀ as two n8 tiles over
//     D / 16 slices (Q and K by ldmatrix), the online softmax on the
//     fragment (a row's max and sum across the 4 threads of a quad), P
//     narrowed to bf16 as the A fragment of P·V, V by ldmatrix.trans. The
//     warps merge through shared memory, the max passed to the merge
//     kernel as a natural-log logit. Bound: the bytes of K and V in the band.
//   * otherwise on wgmma: prefill, the trainer's forwards, and the
//     17-32-row short regime (no main path gives bf16 so few rows: a
//     mostly empty 128-row block there spares a kernel of its own, and the
//     card tests hold it at 32 rows). A block of two consumer
//     warpgroups owns 128 packed rows (64 each, wgmma's M), walks the band
//     in 64-key tiles and keeps acc (64 rows × D, f32) in registers. S = Q
//     Kᵀ is m64n64k16 with Q and K both K-major from shared memory through
//     descriptors in the 128-byte swizzle; scale, softcap (CAP) and the
//     mask (edge tiles only) apply in f32 on the accumulator; the online
//     softmax works on the fragment with quad shuffles; P is narrowed to
//     bf16 in registers and is the A operand of P·V from registers (S's
//     accumulator layout is the A layout of the next product's k16
//     slices), V MN-major from shared memory (the transpose bit). P never
//     reaches shared memory. The products of tile t are P·V of tile t − 1
//     and S of tile t, issued back to back and waited for once; then the
//     softmax of t. The two warpgroups run half a step apart (FA3's
//     ping-pong, kept by the block's barrier at each half step), so one's
//     softmax runs while the other's products are on the tensor cores. K
//     of t + 1 and V of t land by cp.async two half steps ahead (Q, two K
//     and two V slots: 192 KB at D = 256). A softmax overlapped with P·V in
//     the same warpgroup (FA3's intra-warpgroup pipelining) made ptxas
//     serialise every product of the kernel (C7513: a register a product
//     reads defined while one is in flight), in every form tried. No TMA:
//     the inputs are strided views, and a tensor map a call would add host
//     work to decode steps the host already bounds. Bound: at D >= 64 the
//     bytes of q, o and the visible keys and values, once, at 3.35 TB/s,
//     above the flops at the bf16 tensor cores' 989 TFLOP/s (qwen3_32b's
//     prefill, (4, 64, 8, 512, 512, 128): 75.5 MB, 22.5 us, against 17.2
//     GFLOP, 17.4 us; FFMA could not go below 0.257 ms for those flops).
//
// In every regime q is staged as it is and the scale multiplies the logits
// (then the softcap caps them, where there is one);
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
#include <type_traits>

#include "cp_async.cuh"
#include "tensor_core.cuh"

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
  float softcap;         // > 0: logits x -> tanh(x / softcap) · softcap
  int causal, has_window, window, q_offset;
  int vec;               // rows and strides of q, k, v allow 4-element loads
  int vec8;              // ... and 8-element (16-byte) bf16 loads
  int vec_o;             // o allows 4-element stores
};

// decode: keys [lo, hi) in chunks of `chunk`; chunk s is blockIdx.x = s
struct Split {
  int lo, hi, chunk;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// a raw dot product as a logit: scaled, then capped (CAP: the problem's softcap
// > 0). CAP is a template parameter, so the uncapped kernels carry no tanhf.
template <bool CAP>
__device__ __forceinline__ float logit(float a, const Problem& pb) {
  const float x = a * pb.scale;
  return CAP ? tanhf(x / pb.softcap) * pb.softcap : x;
}

// four consecutive f32 values (16 bytes, aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// one 4-value f32 chunk (16 bytes) into shared memory; zeros where !ok
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  afl::cp_async16(dst, src, ok ? 16 : 0);
}
__device__ __forceinline__ void put(float* dst, const float* src, bool ok) {
  *dst = ok ? *src : 0.f;
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

template <typename T, int D, int BQ, int BK, int NT, bool CAP>
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
        s[i][j] = ok ? logit<CAP>(s[i][j], pb) : kMasked;
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
template <typename T, int D, int RB, bool CAP>
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
        s[r][u] = ok ? logit<CAP>(a, pb) : kMasked;
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

// ---- bf16 on the tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 16 bytes of a staged row: where 16-byte chunk c of row r goes. Sw128: the
// wgmma operands' swizzled blocks (tensor_core.cuh); Padded<LD>: row-major
// with rows LD values apart (LD = D + 8 shifts each row by 16 bytes, so
// ldmatrix's 8 rows hit 8 different banks).
template <int ROWS>
struct Sw128 {
  __device__ static int offset(int r, int c) { return afl_tc::sw128_offset(ROWS, r, c); }
};
template <int LD>
struct Padded {
  __device__ static int offset(int r, int c) { return 2 * (r * LD + 8 * c); }
};

// Rows 0 .. ROWS − 1 of a bf16 operand into shared memory at dst, laid out
// by L: row(r, ok) gives row r's first value and whether it exists; rows
// that do not and columns past d are zeros. vec: 2 for 16-byte cp.async (d
// % 8 == 0, rows 16-byte aligned), 1 for 8-byte (d % 4 == 0), 0 value by
// value.
template <typename L, int D, int ROWS, int NT, typename RowFn>
__device__ __forceinline__ void stage_rows(uint8_t* dst, RowFn row, int d, int vec) {
  constexpr int kChunks = ROWS * D / 8;
#pragma unroll
  for (int e = threadIdx.x; e < kChunks; e += NT) {
    const int r = e / (D / 8);
    const int c = e % (D / 8);
    const int col = 8 * c;
    bool ok;
    const bf16* src = row(r, ok);
    uint8_t* to = dst + L::offset(r, c);
    if (vec == 2) {
      afl::cp_async16(to, src + (col < d ? col : 0), ok && col < d ? 16 : 0);
    } else if (vec == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = col + 4 * h;
        afl::cp_async8(to + 8 * h, src + (cc < d ? cc : 0), ok && cc < d ? 8 : 0);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        reinterpret_cast<bf16*>(to)[u] = ok && col + u < d ? src[col + u] : __float2bfloat16(0.f);
    }
  }
}

// 2^x by the special-function unit (ex2.approx, relative error about
// 2^-22, far under P's bf16 rounding; subnormal results flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A raw dot product as a capped logit in log2 units, c · tanh(scale · a /
// c) · log2(e) with tanh(y) = 1 − 2 / (2^(2y·log2 e) + 1): two special-function
// operations for tanhf's dozens; its absolute error stays at f32 rounding,
// far under P's bf16 rounding
__device__ __forceinline__ float cap2(float a, const Problem& pb) {
  const float y = fminf(fmaxf(a * (2.f * kLog2e * pb.scale / pb.softcap), -64.f), 64.f);
  return (1.f - __fdividef(2.f, exp2_approx(y) + 1.f)) * (pb.softcap * kLog2e);
}

// A raw dot product as a logit in log2 units (the softmax takes exp2):
// scaled, capped where CAP (cap2), times log2(e).
template <bool CAP>
__device__ __forceinline__ float logit2(float a, const Problem& pb) {
  return CAP ? cap2(a, pb) : a * (pb.scale * kLog2e);
}

// two f32 values as one bf16 pair (the lower column in the low half), and
// the pair's sum as rounded
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  const float2 back = __bfloat1622float2(p);
  sum += back.x + back.y;
  return *reinterpret_cast<const uint32_t*>(&p);
}

// -- rows > 16 (prefill, trainer forwards): wgmma tile --------------------------

constexpr int kWgGroups = 2;                  // consumer warpgroups a block
constexpr int kWgBQ = 64 * kWgGroups;         // packed rows a block: 64 a warpgroup
constexpr int kWgBK = 64;                     // keys a tile
constexpr int kWgThreads = 128 * kWgGroups;

template <int D>
struct WgShape {
  static constexpr int kCB = D / 64;                    // 64-column blocks
  static constexpr int kQBytes = kWgBQ * D * 2;
  static constexpr int kTileBytes = kWgBK * D * 2;      // one K or V tile
  // Q, two K slots, two V slots, and slack to align the start to 1024 bytes
  static constexpr size_t kBytes = 1024 + kQBytes + 4 * size_t(kTileBytes);
};

// grid (tiles · B · Hkv); each block kWgBQ packed rows of one (batch, kv head)
template <int D, bool CAP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, Strides st, Problem pb,
                   int tiles) {
  using S = WgShape<D>;
  constexpr int CB = S::kCB;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // Q, then K slots 0 and 1, then V slots 0 and 1, from a 1024-byte boundary
  const uint32_t s_base = (afl::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* sQ = smem_raw + (s_base - afl::smem_u32(smem_raw));
  uint8_t* sK = sQ + S::kQBytes;
  uint8_t* sV = sK + 2 * S::kTileBytes;

  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  // late (long-band) tiles first: under a causal mask they have the most work
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x % tiles);
  const int bh = static_cast<int>(blockIdx.x / tiles);
  const int b = bh / pb.hkv;
  const int hk = bh % pb.hkv;
  const int row0 = tile * kWgBQ;
  const int nrows = min(kWgBQ, pb.rows - row0);

  // the keys this block's rows can see
  const int s_lo = pb.q_offset + row0 / pb.group;
  const int s_hi = pb.q_offset + (row0 + nrows - 1) / pb.group;
  int kv_lo = 0;
  int kv_hi = pb.skv;
  if (pb.causal) kv_hi = min(kv_hi, s_hi + 1);
  if (pb.has_window) kv_lo = max(kv_lo, s_lo - pb.window + 1);
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kWgBK - 1) / kWgBK : 0;
  const bf16* kbase = k + b * st.k[0] + hk * st.k[1];
  const bf16* vbase = v + b * st.v[0] + hk * st.v[1];
  const int vec = pb.vec8 ? 2 : pb.vec ? 1 : 0;

  // K of tile t into K slot t % 2, V of tile t into V slot t % 2
  auto stage_tile = [&](uint8_t* ring, const bf16* base, long long rs, int t) {
    const int kp0 = kv_lo + t * kWgBK;
    auto row = [&](int r, bool& ok) {
      ok = kp0 + r < pb.skv;
      return base + static_cast<long long>(ok ? kp0 + r : 0) * rs;
    };
    stage_rows<Sw128<kWgBK>, D, kWgBK, kWgThreads>(ring + (t & 1) * S::kTileBytes, row, pb.d,
                                                    vec);
  };
  auto qrow = [&](int r, bool& ok) {
    ok = r < nrows;
    return packed_row(q, st.q, pb, b, hk, row0 + (ok ? r : 0));
  };
  stage_rows<Sw128<kWgBQ>, D, kWgBQ, kWgThreads>(sQ, qrow, pb.d, vec);
  if (n_tiles > 0) stage_tile(sK, kbase, st.k[2], 0);
  afl::cp_async_commit();

  // this thread's two rows of the block (fragment rows i/4 and i/4 + 8)
  const int rw = 64 * wg + 16 * warp + lane / 4;
  const int t4 = lane % 4;
  int pos[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = pb.q_offset + (row0 + rw + 8 * h) / pb.group;
    m[h] = kMasked;
    l[h] = 0.f;                       // this thread's part of the row sum
  }
  float acc[CB][32];
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  uint32_t pa[4][4];                  // P of the previous tile: the A of its P·V
  // descriptors of the warpgroup's 64 rows of Q and of the K and V slots 0;
  // a slice or a slot is an offset in 16-byte units added to the start address
  const uint64_t q_desc = afl_tc::sw128_desc(s_base + wg * 64 * 128, 16, 1024);
  const uint64_t k_desc = afl_tc::sw128_desc(s_base + S::kQBytes, 16, 1024);
  const uint64_t v_desc =
      afl_tc::sw128_desc(s_base + S::kQBytes + 2 * S::kTileBytes, kWgBK * 128, 1024);

  // S = Q Kᵀ of tile t, 64 rows × 64 keys a warpgroup (the first k slice
  // overwrites s)
  auto chain_s = [&](float (&s)[32], int slot) {
    const uint64_t kt = k_desc + slot * (S::kTileBytes >> 4);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      afl_tc::wgmma_ss<0>(s, q_desc + ((kk / 4) * (kWgBQ * 128) + (kk % 4) * 32) / 16,
                          kt + ((kk / 4) * (kWgBK * 128) + (kk % 4) * 32) / 16, kk > 0);
  };
  // acc += P V of tile t: four k16 slices of keys, D in blocks of 64 columns
  auto chain_pv = [&](int slot) {
    const uint64_t vt = v_desc + slot * (S::kTileBytes >> 4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < CB; ++c)
        afl_tc::wgmma_rs<1>(acc[c], pa[j], vt + (c * (kWgBK * 128) + j * 2048) / 16, 1);
  };
  // the online softmax of tile t's S: the new max's factor alpha for the
  // rows, P rounded once to bf16 (the A of P·V), l summed from that P
  auto softmax = [&](float (&s)[32], int t, float (&alpha)[2], uint32_t (&pn)[4][4]) {
    // the logits in log2 units are s · s2: uncapped, the scale folds into
    // the exponent's FFMA; capped, s is the capped logit already
    const float s2 = CAP ? 1.f : pb.scale * kLog2e;
    // mask only where the tile crosses the end of the keys or a row's band
    const int kv0 = kv_lo + t * kWgBK;
    const bool edge = kv0 + kWgBK > pb.skv || (pb.causal && kv0 + kWgBK - 1 > s_lo) ||
                      (pb.has_window && kv0 <= s_hi - pb.window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kv0 + 8 * j + 2 * t4 + (e & 1);
        const int p = pos[e >> 1];
        bool ok = !edge || kp < pb.skv;
        if (edge && pb.causal) ok = ok && kp <= p;
        if (edge && pb.has_window) ok = ok && kp > p - pb.window;
        const float x = CAP ? cap2(s[4 * j + e], pb) : s[4 * j + e];
        s[4 * j + e] = ok ? x : kMasked;
      }
    // a row's 64 logits lie in the 4 threads of a quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[h], mx * s2);
      alpha[h] = exp2_approx(m[h] - m_new);
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * j + e];
        // exactly 0 where masked, even while m is still the mask value
        p[e] = x > kMasked ? exp2_approx(fmaf(x, s2, -m[e >> 1])) : 0.f;
      }
      pn[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1], sum[0]);
      pn[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3], sum[1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
  };
  // acc to the newest max before P·V adds the newest P (alpha of the last
  // softmax)
  float alpha[2];
  auto rescale = [&]() {
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e >> 1) & 1];
  };
  // the wait for a stage's products: P·V of tile t − 1 and S of tile t are
  // issued back to back and waited for once, and no other instruction of
  // the warpgroup runs while they are in flight (ptxas serialises every
  // product of the kernel if a register a product reads is defined while
  // one is in flight: a softmax overlapped with P·V did, in every form
  // tried)
  float s[32];
  auto wait_products = [&]() {
    afl_tc::wgmma_commit();
    afl_tc::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 32; ++e) afl_tc::fence_operand(s[e]);
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) afl_tc::fence_operand(acc[c][e]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) afl_tc::fence_operand(pa[j][e]);
  };
  // Half-steps h = 0, 1, ...: warpgroup 0 runs the products of tile t in
  // half 2t and the softmax of t in half 2t + 1; warpgroup 1 the same one
  // half later. So one warpgroup's softmax runs while the other's products
  // are on the tensor cores (FA3's ping-pong, by the block's barrier). Each
  // half opens at a barrier; at an even half 2t the block waits for the
  // loads of half 2t − 2 and stages K of tile t + 1 and V of tile t, which
  // the products of tile t + 1 read from half 2t + 2 on: a slot is reused
  // two halves after both warpgroups' last products on it.
  int h = 0;
  auto open_half = [&]() {
    const bool even = h % 2 == 0;
    if (even) {
      afl::cp_async_wait<0>();
      afl_tc::fence_proxy_async();
    }
    __syncthreads();
    if (even) {
      const int t = h / 2;
      if (t + 1 < n_tiles) stage_tile(sK, kbase, st.k[2], t + 1);
      if (t < n_tiles) stage_tile(sV, vbase, st.v[2], t);
      afl::cp_async_commit();
    }
    ++h;
  };
  if (n_tiles > 0) {
    open_half();
    if (wg == 1) open_half();              // warpgroup 1 idles in half 0
    afl_tc::wgmma_fence();
    chain_s(s, 0);
    wait_products();
    open_half();
    for (int t = 0; t + 1 < n_tiles; ++t) {
      softmax(s, t, alpha, pa);
      open_half();
      rescale();
      afl_tc::wgmma_fence();
      chain_pv(t & 1);
      chain_s(s, (t + 1) & 1);
      wait_products();
      open_half();
    }
    softmax(s, n_tiles - 1, alpha, pa);
    open_half();
    rescale();
    afl_tc::wgmma_fence();
    chain_pv((n_tiles - 1) & 1);
    wait_products();
    if (wg == 0) open_half();              // warpgroup 0 idles in the last half
  }
  afl::cp_async_wait<0>();

  // o = acc / l, 0 where no key was visible; rows past the end are not stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) afl_tc::fence_operand(acc[c][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + 8 * h;
    if (r >= nrows) continue;
    const float norm = l[h] > 0.f ? 1.f / l[h] : 0.f;
    bf16* out = packed_row(o, st.o, pb, b, hk, row0 + r);
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * t4;
        const float x0 = acc[c][4 * j + 2 * h] * norm;
        const float x1 = acc[c][4 * j + 2 * h + 1] * norm;
        if (pb.vec_o && col + 1 < pb.d) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(x0, x1);
        } else {
          if (col < pb.d) out[col] = __float2bfloat16(x0);
          if (col + 1 < pb.d) out[col + 1] = __float2bfloat16(x1);
        }
      }
  }
}

// -- rows <= 16 (decode, split-KV): mma.sync --------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaKeys = 16;                   // keys a warp takes at a step
constexpr int kMmaStep = kMmaWarps * kMmaKeys; // keys a block stages a step
constexpr int kMmaRows = 16;                   // the A tile: rows past pb.rows are zeros

template <int D>
struct MmaShape {
  static constexpr int kLD = D + 8;
  static constexpr int kQ = kMmaRows * kLD;           // values
  static constexpr int kTile = kMmaStep * kLD;        // values of one K or V step
  static constexpr size_t kRing = 2 * (size_t(kQ) + 4 * size_t(kTile));   // bytes
  // after the loop: each warp's (m, l) and acc for the merge
  static constexpr size_t kMerge = sizeof(float) * kMmaWarps * kMmaRows * (2 + D);
  static constexpr size_t kBytes = kRing > kMerge ? kRing : kMerge;
};

// grid (chunks, B · Hkv); rows <= 16
template <int D, bool CAP>
__global__ void __launch_bounds__(32 * kMmaWarps)
flash_mma_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, Strides st, Problem pb,
                        Split sp, float* __restrict__ ws) {
  using S = MmaShape<D>;
  constexpr int LD = S::kLD;
  constexpr int NT = 32 * kMmaWarps;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);         // [16][LD]
  bf16* sK = sQ + S::kQ;                             // [2][kMmaStep][LD]
  bf16* sV = sK + 2 * S::kTile;                      // [2][kMmaStep][LD]

  const int rows = pb.rows;
  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / pb.hkv;
  const int hk = bh % pb.hkv;
  const int k_begin = sp.lo + split * sp.chunk;
  const int k_end = min(k_begin + sp.chunk, sp.hi);
  const int n_steps = k_end > k_begin ? (k_end - k_begin + kMmaStep - 1) / kMmaStep : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const bf16* kbase = k + b * st.k[0] + hk * st.k[1];
  const bf16* vbase = v + b * st.v[0] + hk * st.v[1];
  const int vec = pb.vec8 ? 2 : pb.vec ? 1 : 0;

  auto stage_step = [&](int s) {
    const int slot = s & 1;
    const int kp0 = k_begin + s * kMmaStep;
    auto krow = [&](int r, bool& ok) {
      ok = kp0 + r < k_end;
      return kbase + static_cast<long long>(ok ? kp0 + r : 0) * st.k[2];
    };
    auto vrow = [&](int r, bool& ok) {
      ok = kp0 + r < k_end;
      return vbase + static_cast<long long>(ok ? kp0 + r : 0) * st.v[2];
    };
    stage_rows<Padded<LD>, D, kMmaStep, NT>(reinterpret_cast<uint8_t*>(sK + slot * S::kTile),
                                            krow, pb.d, vec);
    stage_rows<Padded<LD>, D, kMmaStep, NT>(reinterpret_cast<uint8_t*>(sV + slot * S::kTile),
                                            vrow, pb.d, vec);
  };
  auto qrow = [&](int r, bool& ok) {
    ok = r < rows;
    return packed_row(q, st.q, pb, b, hk, ok ? r : 0);
  };
  stage_rows<Padded<LD>, D, kMmaRows, NT>(reinterpret_cast<uint8_t*>(sQ), qrow, pb.d, vec);
  if (n_steps > 0) stage_step(0);
  afl::cp_async_commit();
  if (n_steps > 1) stage_step(1);
  afl::cp_async_commit();

  int pos[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    pos[h] = pb.q_offset + (lane / 4 + 8 * h) / pb.group;
    m[h] = kMasked;
    l[h] = 0.f;                       // this thread's part of the row sum
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int s = 0; s < n_steps; ++s) {
    const int slot = s & 1;
    afl::cp_async_wait<1>();               // step s has landed (s + 1 may be in flight)
    __syncthreads();
    const int key0 = k_begin + s * kMmaStep + kMmaKeys * warp;
    if (key0 < k_end) {
      // S (16 rows × 16 keys) = Q Kᵀ: two n8 tiles
      const bf16* kw = sK + slot * S::kTile + kMmaKeys * warp * LD;
      float c[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], bk[4];
        afl_tc::ldmatrix_x4<false>(a, sQ + (lane % 16) * LD + 16 * kk + (lane / 16) * 8);
        afl_tc::ldmatrix_x4<false>(bk, kw + (lane % 8 + (lane / 16) * 8) * LD + 16 * kk +
                                           (lane / 8 % 2) * 8);
        afl_tc::mma_m16n8k16(c[0], a, bk[0], bk[1]);
        afl_tc::mma_m16n8k16(c[1], a, bk[2], bk[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = key0 + 8 * n + 2 * t4 + (e & 1);
          const int p = pos[e >> 1];
          bool ok = kp < k_end;
          if (pb.causal) ok = ok && kp <= p;
          if (pb.has_window) ok = ok && kp > p - pb.window;
          c[n][e] = ok ? logit2<CAP>(c[n][e], pb) : kMasked;
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = fmaxf(fmaxf(c[0][2 * h], c[0][2 * h + 1]), fmaxf(c[1][2 * h], c[1][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
      }
      // P rounded once to bf16 as the A fragment of P·V; l sums the rounded P
      uint32_t pa[4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = c[n][e] > kMasked ? exp2f(c[n][e] - m[e >> 1]) : 0.f;
        pa[2 * n] = pack_bf16(p[0], p[1], sum[0]);
        pa[2 * n + 1] = pack_bf16(p[2], p[3], sum[1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
      // acc = acc · alpha + P V, 16 columns (two n8 tiles) at a time
      const bf16* vw = sV + slot * S::kTile + kMmaKeys * warp * LD;
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bv[4];
        afl_tc::ldmatrix_x4<true>(bv, vw + (lane % 8 + (lane / 8 % 2) * 8) * LD + 16 * n2 +
                                          (lane / 16) * 8);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float* a = acc[2 * n2 + u];
          a[0] *= alpha[0];
          a[1] *= alpha[0];
          a[2] *= alpha[1];
          a[3] *= alpha[1];
          afl_tc::mma_m16n8k16(acc[2 * n2 + u], pa, bv[2 * u], bv[2 * u + 1]);
        }
      }
    }
    __syncthreads();                       // every warp is done with this slot
    if (s + 2 < n_steps) stage_step(s + 2);
    afl::cp_async_commit();
  }
  afl::cp_async_wait<0>();
  __syncthreads();

  // the warps' partials through shared memory (over the ring), merged in warp order
  float* sm = reinterpret_cast<float*>(smem4);       // [NW][16]
  float* sl = sm + kMmaWarps * kMmaRows;             // [NW][16]
  float* sacc = sl + kMmaWarps * kMmaRows;           // [NW][16][D]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int r = warp * kMmaRows + lane / 4 + 8 * h;
    if (t4 == 0) {
      sm[r] = m[h];
      sl[r] = l[h];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      sacc[r * D + 8 * n + 2 * t4] = acc[n][2 * h];
      sacc[r * D + 8 * n + 2 * t4 + 1] = acc[n][2 * h + 1];
    }
  }
  __syncthreads();
  const bool direct = gridDim.x == 1;
  for (int e = threadIdx.x; e < rows * pb.d; e += NT) {
    const int r = e / pb.d;
    const int col = e % pb.d;
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) mx = fmaxf(mx, sm[w * kMmaRows + r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float f = exp2f(sm[w * kMmaRows + r] - mx);
      lsum = fmaf(f, sl[w * kMmaRows + r], lsum);
      a = fmaf(f, sacc[(w * kMmaRows + r) * D + col], a);
    }
    if (direct) {
      narrow(packed_row(o, st.o, pb, b, hk, r) + col, lsum > 0.f ? a / lsum : 0.f);
    } else {
      // flash_merge_kernel's partials: the max as a natural-log logit
      float* part = ws + ((static_cast<size_t>(split) * gridDim.y + bh) * rows + r) * (pb.d + 2);
      if (col == 0) {
        part[0] = mx * kLn2;
        part[1] = lsum;
      }
      part[2 + col] = a;
    }
  }
}

// ---- launch ----------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, int BQ, int BK, int NT, bool CAP>
int run_tile(const T* q, const T* k, const T* v, T* o, const Strides& st, const Problem& pb,
             int b, cudaStream_t stream) {
  using S = TileShape<T, D, BQ, BK, NT>;
  const int tiles = (pb.rows + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(tiles) * b * pb.hkv;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(flash_tile_kernel<T, D, BQ, BK, NT, CAP>, S::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_tile_kernel<T, D, BQ, BK, NT, CAP>
      <<<static_cast<unsigned>(blocks), NT, S::kBytes, stream>>>(q, k, v, o, st, pb, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int RB, bool CAP>
int run_decode(const T* q, const T* k, const T* v, T* o, const Strides& st, const Problem& pb,
               const Split& sp, int splits, float* ws, int b, cudaStream_t stream) {
  const long long bhs = static_cast<long long>(b) * pb.hkv;
  if (bhs > 65535 || splits < 1 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = DecodeSmem<T, D, RB>::bytes(pb.rows);
  cudaError_t err = allow_smem(flash_decode_kernel<T, D, RB, CAP>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_kernel<T, D, RB, CAP><<<dim3(splits, static_cast<unsigned>(bhs)),
                                       32 * kDecodeWarps, bytes, stream>>>(q, k, v, o, st, pb,
                                                                           sp, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  flash_merge_kernel<T><<<static_cast<unsigned>(bhs), 256, 0, stream>>>(ws, o, st, pb, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool CAP>
int run(const T* q, const T* k, const T* v, T* o, const Strides& st, const Problem& pb,
        const Split& sp, int splits, float* ws, int b, cudaStream_t stream) {
  if (pb.rows <= 2)
    return run_decode<T, D, 2, CAP>(q, k, v, o, st, pb, sp, splits, ws, b, stream);
  if (pb.rows <= 8)
    return run_decode<T, D, 8, CAP>(q, k, v, o, st, pb, sp, splits, ws, b, stream);
  if (pb.rows <= kDecodeMaxRows)
    return run_decode<T, D, kDecodeMaxRows, CAP>(q, k, v, o, st, pb, sp, splits, ws, b, stream);
  if (pb.rows <= kShortMaxRows)
    return run_tile<T, D, 32, 32, 128, CAP>(q, k, v, o, st, pb, b, stream);
  return run_tile<T, D, 64, 64, 256, CAP>(q, k, v, o, st, pb, b, stream);
}

template <int D, bool CAP>
int run_wgmma(const bf16* q, const bf16* k, const bf16* v, bf16* o, const Strides& st,
              const Problem& pb, int b, cudaStream_t stream) {
  const int tiles = (pb.rows + kWgBQ - 1) / kWgBQ;
  const long long blocks = static_cast<long long>(tiles) * b * pb.hkv;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(flash_wgmma_kernel<D, CAP>, WgShape<D>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_wgmma_kernel<D, CAP><<<static_cast<unsigned>(blocks), kWgThreads, WgShape<D>::kBytes,
                               stream>>>(q, k, v, o, st, pb, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAP>
int run_mma_decode(const bf16* q, const bf16* k, const bf16* v, bf16* o, const Strides& st,
                   const Problem& pb, const Split& sp, int splits, float* ws, int b,
                   cudaStream_t stream) {
  const long long bhs = static_cast<long long>(b) * pb.hkv;
  if (bhs > 65535 || splits < 1 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = MmaShape<D>::kBytes;
  cudaError_t err = allow_smem(flash_mma_decode_kernel<D, CAP>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_mma_decode_kernel<D, CAP><<<dim3(splits, static_cast<unsigned>(bhs)), 32 * kMmaWarps,
                                    bytes, stream>>>(q, k, v, o, st, pb, sp, ws);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  flash_merge_kernel<bf16><<<static_cast<unsigned>(bhs), 256, 0, stream>>>(ws, o, st, pb, splits);
  return static_cast<int>(cudaGetLastError());
}

// f32: the FFMA regimes; bf16: mma.sync decode for rows <= 16, else the wgmma tile
template <typename T, int D, bool CAP>
int run_regime(const T* q, const T* k, const T* v, T* o, const Strides& st, const Problem& pb,
               const Split& sp, int splits, float* ws, int b, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    if (pb.rows <= kDecodeMaxRows)
      return run_mma_decode<D, CAP>(q, k, v, o, st, pb, sp, splits, ws, b, stream);
    return run_wgmma<D, CAP>(q, k, v, o, st, pb, b, stream);
  } else {
    return run<T, D, CAP>(q, k, v, o, st, pb, sp, splits, ws, b, stream);
  }
}

template <typename T, bool CAP>
int run_width(const T* q, const T* k, const T* v, T* o, const Strides& st, const Problem& pb,
              const Split& sp, int splits, float* ws, int b, cudaStream_t stream) {
  if (pb.d <= 64) return run_regime<T, 64, CAP>(q, k, v, o, st, pb, sp, splits, ws, b, stream);
  if (pb.d <= 128) return run_regime<T, 128, CAP>(q, k, v, o, st, pb, sp, splits, ws, b, stream);
  return run_regime<T, 256, CAP>(q, k, v, o, st, pb, sp, splits, ws, b, stream);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const void* qv, const void* kv, const void* vv, void* ov, const long long* strides,
           int b, int hq, int hkv, int sq, int skv, int d, float scale, float softcap,
           int causal, int has_window, int window, int q_offset, int vec, int split_lo,
           int split_hi,
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
  pb.softcap = softcap;
  pb.causal = causal;
  pb.has_window = has_window;
  pb.window = window;
  pb.q_offset = q_offset;
  pb.vec = vec;
  bool strides8 = true;
  for (int i = 0; i < 9; ++i) strides8 = strides8 && strides[i] % 8 == 0;
  pb.vec8 = vec && d % 8 == 0 && strides8 && aligned(qv, 16) && aligned(kv, 16) &&
            aligned(vv, 16);
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
  if (softcap > 0.f) return run_width<T, true>(q, k, v, o, st, pb, sp, splits, w, b, stream);
  return run_width<T, false>(q, k, v, o, st, pb, sp, splits, w, b, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v and o.
// softcap <= 0: no logit cap; has_window = 0: no window; q_offset: absolute
// position of query row 0;
// vec = 1 only if d % 4 == 0, every pointer of q, k and v is 16-byte (f32) /
// 8-byte (bf16) aligned and every stride is a multiple of 4. For
// group · sq <= 16 (decode), keys [split_lo, split_hi) in `splits` chunks of
// split_chunk, and with splits > 1 a workspace of splits · b · hkv ·
// group · sq · (d + 2) floats.
extern "C" int afl_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                       const long long* strides, int b, int hq, int hkv,
                                       int sq, int skv, int d, float scale, float softcap,
                                       int causal, int has_window, int window, int q_offset,
                                       int vec, int split_lo, int split_hi, int split_chunk,
                                       int splits, void* ws, void* stream) {
  return launch<float>(q, k, v, o, strides, b, hq, hkv, sq, skv, d, scale, softcap, causal,
                       has_window, window, q_offset, vec, split_lo, split_hi, split_chunk,
                       splits, ws, stream);
}

extern "C" int afl_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                        const long long* strides, int b, int hq, int hkv,
                                        int sq, int skv, int d, float scale, float softcap,
                                        int causal, int has_window, int window, int q_offset,
                                        int vec, int split_lo, int split_hi, int split_chunk,
                                        int splits, void* ws, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, strides, b, hq, hkv, sq, skv, d, scale, softcap,
                               causal, has_window, window, q_offset, vec, split_lo, split_hi,
                               split_chunk, splits, ws, stream);
}
