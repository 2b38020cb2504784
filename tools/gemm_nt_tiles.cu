// Every candidate tile of panel.cu's two products (csrc/gemm_nt.cuh) at
// the streamed paths' shapes, timed on the card; built and run by
// tools/gemm_nt_probe.sh. One JSON line per shape: the milliseconds of each
// tile (median of 7 trials of 20 calls queued behind a spin kernel), and
// of `panel`, the tile launch_gemm picks. Each tile's output is checked
// against tile 0's (the same bits: one FMA chain per element, in k order)
// and against an f64 reference; a mismatch is marked BAD. The first line
// is the card's f32 FMA rate.
#include "panel.cu"
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <algorithm>
#include <cstring>
#include <string>
#include <functional>

using namespace afl_gemm;

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}
template <class T>
__global__ void fill(T* x, size_t n, unsigned seed) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x) {
    unsigned h = (unsigned)(i * 2654435761u) ^ seed; h ^= h >> 13; h *= 0x5bd1e995; h ^= h >> 15;
    x[i] = (T)((h & 0xffffff) / 16777216.0 - 0.5);
  }
}
template <class T>
__global__ void naive(const T* t, int ldt, const T* a, int lda, const T* b, int ldb, double* c, int m, int n, int k) {
  int i = blockIdx.y * 16 + threadIdx.y, j = blockIdx.x * 16 + threadIdx.x;
  if (i >= m || j >= n) return;
  double s = 0;
  for (int q = 0; q < k; ++q) s += (double)a[(size_t)i * lda + q] * (double)b[(size_t)j * ldb + q];
  c[(size_t)i * n + j] = t ? (double)t[(size_t)i * ldt + j] - s : s;
}

template <class T>
struct Variant {
  std::string name;
  std::function<int(const Problem<T>&, bool)> run;   // bool: subtract
};

template <class Tile, class T>
Variant<T> tile_variant(const char* name) {
  return {name, [](const Problem<T>& p, bool sub) {
            return sub ? launch_tile<Tile>(p, SubtractFrom{}, nullptr)
                       : launch_tile<Tile>(p, StoreProduct{}, nullptr);
          }};
}

template <class T>
void run_case(const char* name, int m, int n, int k, bool sub, int lda, int ldb, int ldt,
              const std::vector<Variant<T>>& variants) {
  T *a, *b, *t, *c; double* ref;
  size_t na = (size_t)m * lda, nb = (size_t)n * ldb, nt = (size_t)m * ldt;
  cudaMalloc(&a, na * sizeof(T)); cudaMalloc(&b, nb * sizeof(T)); cudaMalloc(&t, nt * sizeof(T));
  cudaMalloc(&c, (size_t)m * n * sizeof(T)); cudaMalloc(&ref, (size_t)m * n * sizeof(double));
  fill<<<1024, 256>>>(a, na, 1); fill<<<1024, 256>>>(b, nb, 2); fill<<<1024, 256>>>(t, nt, 3);
  naive<<<dim3((n + 15) / 16, (m + 15) / 16), dim3(16, 16)>>>(sub ? t : (T*)nullptr, ldt, a, lda, b, ldb, ref, m, n, k);
  std::vector<double> href((size_t)m * n); cudaMemcpy(href.data(), ref, href.size() * 8, cudaMemcpyDeviceToHost);
  double refmax = 0; for (double v : href) refmax = std::max(refmax, fabs(v));
  if (refmax == 0) refmax = 1;
  Problem<T> p{{a, lda, vec16(a, lda, sizeof(T))}, {b, ldb, vec16(b, ldb, sizeof(T))},
               {t, ldt, sub && vec16(t, ldt, sizeof(T))}, c, n, vec16(c, n, sizeof(T)), m, n, k};
  std::vector<T> h0((size_t)m * n), h((size_t)m * n);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  printf("{\"case\": \"%s\", \"dtype\": \"%s\", \"m\": %d, \"n\": %d, \"k\": %d, \"ms\": {", name,
         sizeof(T) == 4 ? "f32" : "f64", m, n, k);
  for (size_t vi = 0; vi < variants.size(); ++vi) {
    auto call = [&]() { return variants[vi].run(p, sub); };
    int err = call();
    cudaError_t se = cudaDeviceSynchronize();
    if (err || se) { printf("%s\"%s\": \"error %d %s\"", vi ? ", " : "", variants[vi].name.c_str(), err, cudaGetErrorString(se)); continue; }
    cudaMemcpy(h.data(), c, h.size() * sizeof(T), cudaMemcpyDeviceToHost);
    if (vi == 0) h0 = h;
    double e = 0; for (size_t i = 0; i < h.size(); ++i) e = std::max(e, fabs((double)h[i] - href[i]));
    bool same = memcmp(h.data(), h0.data(), h.size() * sizeof(T)) == 0;
    for (int w = 0; w < 3; ++w) call();
    std::vector<float> trials;
    for (int tr = 0; tr < 7; ++tr) {
      spin<<<1, 1>>>(40000000LL);
      cudaEventRecord(e0);
      for (int r = 0; r < 20; ++r) call();
      cudaEventRecord(e1); cudaEventSynchronize(e1);
      float ms; cudaEventElapsedTime(&ms, e0, e1); trials.push_back(ms / 20);
    }
    std::sort(trials.begin(), trials.end());
    bool ok = same && e / refmax < (sizeof(T) == 4 ? 1e-5 : 1e-13);
    printf("%s\"%s\": %.2f%s", vi ? ", " : "", variants[vi].name.c_str(), trials[3] * 1e3, ok ? "" : "BAD");
    fflush(stdout);
  }
  printf("}}\n");
  cudaFree(a); cudaFree(b); cudaFree(t); cudaFree(c); cudaFree(ref);
}

__global__ void ffma_rate(float* out, int iters) {
  float a[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = threadIdx.x * 1e-3f + i;
  const float x = 1.0001f, y = 1e-7f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 32; ++i) a[i] = fmaf(a[i], x, y);
  float s = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += a[i];
  if (s == 1.2345f) out[0] = s;
}

int main() {
  {
    float* o; cudaMalloc(&o, 4);
    cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
    ffma_rate<<<132 * 8, 256>>>(o, 64);
    cudaEventRecord(e0);
    ffma_rate<<<132 * 8, 256>>>(o, 8192);
    cudaEventRecord(e1); cudaEventSynchronize(e1);
    float ms; cudaEventElapsedTime(&ms, e0, e1);
    printf("{\"ffma_tflops\": %.2f}\n", 2.0 * 32 * 8192 * 256.0 * 132 * 8 / ms / 1e9);
  }
  std::vector<Variant<float>> f32 = {
      {"panel", [](const Problem<float>& p, bool s) {
         return s ? launch_gemm<float, true>(p.t.p, p.t.ld, p.a.p, p.a.ld, p.b.p, p.b.ld, p.c,
                                             p.ldc, p.m, p.n, p.k, nullptr)
                  : launch_gemm<float, false>(nullptr, 0, p.a.p, p.a.ld, p.b.p, p.b.ld, p.c,
                                              p.ldc, p.m, p.n, p.k, nullptr);
       }},
      tile_variant<FfmaTile<16, 16, 8, 8, 8>, float>("128x128k8"),
      tile_variant<F32Mid, float>("128x64k16"),
      tile_variant<F32Narrow, float>("96x64k16"),
      tile_variant<FfmaTile<16, 16, 4, 4, 16>, float>("64x64k16"),
      tile_variant<FfmaTile<16, 8, 4, 4, 16>, float>("64x32k16"),
      tile_variant<FfmaTile<24, 16, 4, 4, 8>, float>("96x64k8"),
      tile_variant<FfmaTile<24, 8, 4, 4, 16>, float>("96x32k16"),
  };
  std::vector<Variant<double>> f64 = {
      {"panel", [](const Problem<double>& p, bool s) {
         return s ? launch_gemm<double, true>(p.t.p, p.t.ld, p.a.p, p.a.ld, p.b.p, p.b.ld, p.c,
                                              p.ldc, p.m, p.n, p.k, nullptr)
                  : launch_gemm<double, false>(nullptr, 0, p.a.p, p.a.ld, p.b.p, p.b.ld, p.c,
                                               p.ldc, p.m, p.n, p.k, nullptr);
       }},
      tile_variant<F64Mid, double>("64x64k16s3"),
      tile_variant<DmmaTile<2, 2, 64, 2>, double>("64x64k64s2"),
      tile_variant<DmmaTile<2, 2, 32, 3>, double>("64x64k32s3"),
      tile_variant<DmmaTile<4, 2, 16, 3>, double>("128x64k16s3"),
      tile_variant<DmmaTile<2, 2, 32, 3, 2>, double>("64x64k32s3x2"),
      tile_variant<DmmaTile<2, 2, 64, 2, 2>, double>("64x64k64s2x2"),
      tile_variant<DmmaTile<2, 2, 64, 2, 4>, double>("64x64k64s2x4"),
      tile_variant<DmmaTile<2, 1, 64, 2, 4>, double>("64x32k64s2x4"),
      tile_variant<DmmaTile<1, 2, 64, 2, 4>, double>("32x64k64s2x4"),
      tile_variant<DmmaTile<1, 1, 64, 2, 4>, double>("32x32k64s2x4"),
  };
  // trsm: A a slab of the (d, d) work matrix (row stride d), B = zinv (b, b);
  // update: A = lp (d, b), B = pt (w, b), T a slab of the work matrix;
  // then a ragged shape with unaligned strides, and one smaller than a tile
  run_case<float>("trsm", 2304, 256, 256, false, 2304, 256, 0, f32);
  for (int w : {2048, 1792, 1536, 1024, 512, 256})
    run_case<float>("update", 2304, w, 256, true, 256, 256, 2304, f32);
  run_case<float>("trsm", 6144, 256, 256, false, 6144, 256, 0, f32);
  for (int w : {5888, 2048, 512, 256})
    run_case<float>("update", 6144, w, 256, true, 256, 256, 6144, f32);
  run_case<float>("ragged", 1000, 777, 200, true, 201, 203, 977, f32);
  run_case<float>("small", 70, 40, 16, true, 16, 16, 40, f32);
  run_case<double>("trsm", 2304, 128, 128, false, 2304, 128, 0, f64);
  // the f64 trsm's time against its depth: k = 0 is the launch and the
  // stores alone
  for (int k : {0, 16, 64})
    run_case<double>("trsm_depth", 2304, 128, k, false, 2304, 128, 0, f64);
  for (int w : {2176, 1152, 384, 128})
    run_case<double>("update", 2304, w, 128, true, 128, 128, 2304, f64);
  run_case<double>("ragged", 1000, 777, 200, true, 201, 203, 977, f64);
  run_case<double>("small", 70, 40, 16, true, 16, 16, 40, f64);
  return 0;
}
