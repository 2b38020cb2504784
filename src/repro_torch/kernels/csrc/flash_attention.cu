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
// contiguous); bf16 is widened to f32 on load, every product is a plain
// f32 FMA (no TF32, no mma), exp is the accurate expf, and the output is
// written in the input's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (kernel body _flash_kernel). The TPU version walks the kv
// tiles as the sequential innermost grid axis, carrying (m, l, acc) in VMEM
// scratch from one grid step to the next, takes causal, window, q_offset and
// the key length as compile-time constants (one compile per value), pads S
// and D to block multiples, and maps each query head onto its kv head in the
// BlockSpec index map. Here:
//   * one block of 256 threads owns a tile of BQ query rows of one (batch,
//     kv head) and loops over the kv tiles itself, with (m, l) in shared
//     memory and acc in registers, normalizing once at the end;
//   * the tile's rows pack the GQA group: row ρ is query position ρ / group
//     of query head kv_head · group + ρ % group, so each K/V tile is read
//     once for the whole group, and a decode step (Sq = 1) fills `group`
//     rows instead of one. BQ is 64, or 16 when group · Sq <= 16 (decode);
//   * causal, window, q_offset and the lengths are runtime arguments (a
//     decode step moves q_offset every token). From them the block computes
//     the first and last kv tile its rows can see (the reference's
//     `relevant` test) and loops over those only; rows whose band ends
//     inside a tile are masked by position, and the ragged ends of Sq, Skv
//     and D are bounds checks, not padding copies;
//   * the head dim is a template, D in {64, 128, 256}; another head dim
//     (the reference tests use 80) runs in the next one with its extra
//     columns zero on load and never stored, as the reference pads D to
//     128. kv tiles are BK = 64 rows, 32 at D = 256, so that the Q, K and V
//     tiles (rows padded by 4 floats against bank conflicts) fit the
//     block's dynamic shared memory: 143 KB at D = 256, raised with
//     cudaFuncSetAttribute;
//   * S = Q Kᵀ runs as a register-tiled product (each thread BQ/16 rows ×
//     BK/16 keys), goes through shared memory for the row-wise softmax
//     update (256 / BQ threads a row, shuffle reductions), and P V adds into
//     each thread's BQ/16 rows × D/16 columns of acc. Threads whose rows
//     are all past the end skip the products.
//
// Bound on an H100 SXM: the function needs 4·D flops for each visible
// (query, key) pair of each query head (QKᵀ and PV), at 67 TFLOP/s f32,
// against q, k, v and o each moved once at 3.35 TB/s. The serve path's
// prefill (B 4, Hq 16, Hkv 8, S 2048, D 256) is operations-bound: 137.6
// GFLOP (2.05 ms) for a global layer, 103.2 GFLOP (1.54 ms) for a window of
// 1024. Its decode step (Sq 1, Skv 2064) is bytes-bound: 135 MB of K and V
// (40 us). This first version meets neither bound on purpose: f32 FMA on
// the CUDA cores with synchronous loads, one block per SM at D = 256, and
// one block per (batch, kv head) at decode, 32 blocks for 132 SMs.
// wgmma with TMA staging for the prefill and a split-KV decode are the
// follow-ups.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Each entry point launches on the caller's stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;         // 16 row lanes × 16 column lanes
constexpr float kMasked = -1e30f;

// Element strides of dims 0..2 (batch, head, position); dim 3 is contiguous.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

struct Problem {
  int hkv, group, skv, d;
  int rows;              // group · sq packed rows per (batch, kv head)
  int tiles;             // ceil(rows / BQ)
  float scale;
  int causal, has_window, window, q_offset;
  int vec;               // rows and strides allow 4-element vector loads
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Tile staging in two steps, so that the loads of several tiles are in
// flight together: fetch NROWS rows of D (head-dim padded) columns into
// registers, zero where the row does not exist (row_ptr gives nullptr) or
// the column is past d; then put them, times `mul`, into shared memory
// rows of LD floats. Neighbouring threads read neighbouring 4-column chunks.
template <int D, int NROWS>
struct Stage {
  static constexpr int kChunks = NROWS * D / 4;
  static constexpr int kIters = kChunks / kThreads;
  static_assert(kChunks % kThreads == 0, "tile must split evenly over the block");
  float4 buf[kIters];

  template <typename T, typename RowPtr>
  __device__ __forceinline__ void fetch(RowPtr row_ptr, int d, int vec) {
#pragma unroll
    for (int u = 0; u < kIters; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e / (D / 4);
      const int c = (e % (D / 4)) * 4;
      const T* p = row_ptr(r);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p != nullptr && c < d) {
        if (vec) {
          x = load4(p + c);
        } else {
          x.x = widen(p[c]);
          if (c + 1 < d) x.y = widen(p[c + 1]);
          if (c + 2 < d) x.z = widen(p[c + 2]);
          if (c + 3 < d) x.w = widen(p[c + 3]);
        }
      }
      buf[u] = x;
    }
  }

  template <int LD>
  __device__ __forceinline__ void put(float* dst, float mul) const {
#pragma unroll
    for (int u = 0; u < kIters; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e / (D / 4);
      const int c = (e % (D / 4)) * 4;
      const float4 x = buf[u];
      *reinterpret_cast<float4*>(dst + r * LD + c) =
          make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
    }
  }
};

template <int D, int BQ, int BK>
struct Layout {
  static constexpr int LD = D + 4;        // Q, K, V rows: 16 B shift per row
  static constexpr int PS = BK + 16;      // S / P rows: two row lanes of a warp on disjoint banks
  static constexpr int kFloats = BQ * LD + 2 * BK * LD + BQ * PS + 3 * BQ;
  static constexpr size_t kBytes = (kFloats + BQ) * sizeof(float);
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Strides st, Problem pb) {
  using L = Layout<D, BQ, BK>;
  constexpr int LD = L::LD;
  constexpr int PS = L::PS;
  constexpr int TM = BQ / kLanes;       // rows per thread
  constexpr int TN = BK / kLanes;       // keys per thread in S
  constexpr int TC = D / (4 * kLanes);  // 4-column chunks per thread in acc
  constexpr int TPR = kThreads / BQ;    // threads per row in the softmax update
  constexpr int KPT = BK / TPR;         // keys per thread in the softmax update
  static_assert(TM >= 1 && TN >= 1 && TC >= 1 && KPT >= 1, "tile shape");

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  float* sM = sP + BQ * PS;
  float* sL = sM + BQ;
  float* sA = sL + BQ;
  int* sPos = reinterpret_cast<int*>(sA + BQ);

  const int t = threadIdx.x;
  const int cl = t % kLanes;
  const int rl = t / kLanes;
  // late (long-band) tiles first: under a causal mask they have the most work
  const int tile = pb.tiles - 1 - static_cast<int>(blockIdx.x % pb.tiles);
  const int bh = static_cast<int>(blockIdx.x / pb.tiles);
  const int b = bh / pb.hkv;
  const int hk = bh % pb.hkv;
  const int row0 = tile * BQ;
  const int nrows = min(BQ, pb.rows - row0);

  // the kv positions this tile's rows can see, whole BK tiles
  const int s_lo = row0 / pb.group;
  const int s_hi = (row0 + nrows - 1) / pb.group;
  int kv_lo = 0;
  int kv_hi = pb.skv;
  if (pb.causal) kv_hi = min(kv_hi, pb.q_offset + s_hi + 1);
  if (pb.has_window) kv_lo = max(kv_lo, pb.q_offset + s_lo - pb.window + 1);
  kv_lo = (kv_lo / BK) * BK;

  for (int r = t; r < BQ; r += kThreads) {
    sM[r] = kMasked;
    sL[r] = 0.f;
    sPos[r] = pb.q_offset + (row0 + r) / pb.group;
  }
  {
    Stage<D, BQ> sq_stage;
    sq_stage.template fetch<T>(
        [&](int r) -> const T* {
          if (r >= nrows) return nullptr;
          const int rho = row0 + r;
          const int h = hk * pb.group + rho % pb.group;
          return q + b * st.q[0] + h * st.q[1] + static_cast<long long>(rho / pb.group) * st.q[2];
        },
        pb.d, pb.vec);
    sq_stage.template put<LD>(sQ, pb.scale);     // q · scale, as the reference
  }

  float acc[TM][TC][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  const bool active = rl < nrows;       // row rl + 16 i exists for i = 0 at least
  const T* kbase = k + b * st.k[0] + hk * st.k[1];
  const T* vbase = v + b * st.v[0] + hk * st.v[1];
  __syncthreads();

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BK) {
    {
      Stage<D, BK> ks, vs;
      ks.template fetch<T>(
          [&](int r) -> const T* {
            const int kp = kv0 + r;
            return kp < pb.skv ? kbase + static_cast<long long>(kp) * st.k[2] : nullptr;
          },
          pb.d, pb.vec);
      vs.template fetch<T>(
          [&](int r) -> const T* {
            const int kp = kv0 + r;
            return kp < pb.skv ? vbase + static_cast<long long>(kp) * st.v[2] : nullptr;
          },
          pb.d, pb.vec);
      ks.template put<LD>(sK, 1.f);
      vs.template put<LD>(sV, 1.f);
    }
    __syncthreads();

    // S = (q · scale) Kᵀ: rows rl + 16 i, keys cl + 16 j
    if (active) {
      float s[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; c += 4) {
        float4 qa[TM], kb[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          qa[i] = *reinterpret_cast<const float4*>(sQ + (rl + kLanes * i) * LD + c);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          kb[j] = *reinterpret_cast<const float4*>(sK + (cl + kLanes * j) * LD + c);
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
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sP[(rl + kLanes * i) * PS + cl + kLanes * j] = s[i][j];
    }
    __syncthreads();

    // online softmax update of each row: TPR threads a row, KPT keys each
    {
      const int r = t / TPR;
      const int part = t % TPR;
      const int qp = sPos[r];
      const bool row_ok = r < nrows;
      float val[KPT];
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = part + TPR * j;
        const int kp = kv0 + key;
        bool ok = row_ok && kp < pb.skv;
        if (pb.causal) ok = ok && kp <= qp;
        if (pb.has_window) ok = ok && kp > qp - pb.window;
        val[j] = ok ? sP[r * PS + key] : kMasked;
        mx = fmaxf(mx, val[j]);
      }
#pragma unroll
      for (int w = TPR / 2; w >= 1; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int key = part + TPR * j;
        // exactly 0 where masked, even while m_new is still the mask value
        const float p = val[j] > kMasked ? expf(val[j] - m_new) : 0.f;
        sP[r * PS + key] = p;
        sum += p;
      }
#pragma unroll
      for (int w = TPR / 2; w >= 1; w /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        sA[r] = alpha;
        sL[r] = alpha * sL[r] + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc · alpha + P V: rows rl + 16 i, columns 4·cl + 64·c
    if (active) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float alpha = sA[rl + kLanes * i];
#pragma unroll
        for (int c = 0; c < TC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
      }
#pragma unroll 4
      for (int key = 0; key < BK; ++key) {
        float4 vv[TC];
#pragma unroll
        for (int c = 0; c < TC; ++c)
          vv[c] = *reinterpret_cast<const float4*>(sV + key * LD + 4 * cl + 4 * kLanes * c);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float p = sP[(rl + kLanes * i) * PS + key];
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            acc[i][c][0] = fmaf(p, vv[c].x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv[c].y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv[c].z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv[c].w, acc[i][c][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // o = acc / l, 0 where no key was visible
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rl + kLanes * i;
    if (r >= nrows) continue;
    const float l = sL[r];
    const float norm = l > 0.f ? 1.f / l : 0.f;
    const int rho = row0 + r;
    const int h = hk * pb.group + rho % pb.group;
    T* out = o + b * st.o[0] + h * st.o[1] + static_cast<long long>(rho / pb.group) * st.o[2];
#pragma unroll
    for (int c = 0; c < TC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * cl + 4 * kLanes * c + e;
        if (col < pb.d) narrow(out + col, acc[i][c][e] * norm);
      }
  }
}

template <typename T, int D, int BQ>
int run(const T* q, const T* k, const T* v, T* o, const Strides& st, Problem pb, int b,
        cudaStream_t stream) {
  constexpr int BK = D == 256 ? 32 : 64;
  using L = Layout<D, BQ, BK>;
  pb.tiles = (pb.rows + BQ - 1) / BQ;
  const long long blocks = static_cast<long long>(pb.tiles) * b * pb.hkv;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D, BQ, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_kernel<T, D, BQ, BK><<<static_cast<unsigned>(blocks), kThreads, L::kBytes, stream>>>(
      q, k, v, o, st, pb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* qv, const void* kv, const void* vv, void* ov, const long long* strides,
           int b, int hq, int hkv, int sq, int skv, int d, float scale, int causal,
           int has_window, int window, int q_offset, int vec, void* stream_v) {
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
  const T* q = static_cast<const T*>(qv);
  const T* k = static_cast<const T*>(kv);
  const T* v = static_cast<const T*>(vv);
  T* o = static_cast<T*>(ov);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const bool small = pb.rows <= 16;
  if (d <= 64)
    return small ? run<T, 64, 16>(q, k, v, o, st, pb, b, stream)
                 : run<T, 64, 64>(q, k, v, o, st, pb, b, stream);
  if (d <= 128)
    return small ? run<T, 128, 16>(q, k, v, o, st, pb, b, stream)
                 : run<T, 128, 64>(q, k, v, o, st, pb, b, stream);
  return small ? run<T, 256, 16>(q, k, v, o, st, pb, b, stream)
               : run<T, 256, 64>(q, k, v, o, st, pb, b, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v and o.
// has_window = 0: no window; q_offset: absolute position of query row 0;
// vec = 1 only if d % 4 == 0, every pointer is 16-byte (f32) / 8-byte
// (bf16) aligned and every stride is a multiple of 4.
extern "C" int afl_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                       const long long* strides, int b, int hq, int hkv,
                                       int sq, int skv, int d, float scale, int causal,
                                       int has_window, int window, int q_offset, int vec,
                                       void* stream) {
  return launch<float>(q, k, v, o, strides, b, hq, hkv, sq, skv, d, scale, causal,
                       has_window, window, q_offset, vec, stream);
}

extern "C" int afl_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                        const long long* strides, int b, int hq, int hkv,
                                        int sq, int skv, int d, float scale, int causal,
                                        int has_window, int window, int q_offset, int vec,
                                        void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, strides, b, hq, hkv, sq, skv, d, scale, causal,
                               has_window, window, q_offset, vec, stream);
}
