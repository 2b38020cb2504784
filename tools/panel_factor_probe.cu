// The measurements behind panel_factor's block and schedule (csrc/panel.cu
// on csrc/tri_blocked.cuh), built and run by tools/panel_factor_probe.sh.
//
// Variants, all of them panel.cu's own device code: "panel_factor" is the
// entry point (factor_kernel on 512 threads: load_factor_ahead's
// look-ahead, then invert_blocked); "256 ahead" and, in f32, "1024 ahead"
// are factor_kernel on other blocks (f64 at 1024 threads would have 64
// registers a thread for its 32-entry rows of doubles: not built);
// "512" and "256" are the factor without the look-ahead (load_rows and
// factor_blocked, as blocked.cu's diagonal step factors). One JSON line per
// case: each variant's milliseconds (median of 7 trials of 200 calls
// queued behind a spin kernel), its milliseconds from a cold L2 (median of
// 51 calls, each timed alone after a 128 MB memset, as the streamed
// factor's diagonal block may come from device memory) and its errors,
// and panel_tri_inv's time on the same L (the inverse alone). Each
// variant's L and Z are checked against a host f64 factor and inverse
// (relative to the largest entry), for exact zeros above the diagonal and
// for the bits of the entry point (every entry's sums run in one order,
// whichever warp takes them); the input's upper half is NaN, so a variant
// that read it would fail. A rank-3 block must give NaN.
//
// Phases: at the widest panel of each type, the entry point's kernel with
// a Marks functor (tri_blocked.cuh's marks) that stamps clock64() at each
// point, in one call with a hot L2 and one with a cold one, in
// microseconds from the kernel's start: the load, each
// sub-panel's rows below, the next diagonal sub-block's update, warp 0's
// chain and the latest end of the rest of the update, then the inverse's
// steps and the stores. The stamped kernel must give the same bits.
#include "panel.cu"

#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <functional>
#include <random>
#include <vector>

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

// The factor without the look-ahead: factor_kernel's steps with load_rows
// and factor_blocked in place of load_factor_ahead.
template <class T, int kThreads>
__global__ void __launch_bounds__(kThreads)
no_ahead_kernel(const T* __restrict__ a, int lda, int b, T* __restrict__ l_out,
                T* __restrict__ z_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int bp = afl_tri::padded(b);
  T* s = reinterpret_cast<T*>(smem_raw);
  T* scratch = s + tri(bp);
  afl_tri::load_rows<kThreads, kMaxPanel<T>>(a, lda, b, s, 0, 0);
  afl_tri::factor_blocked<kThreads, kMaxPanel<T>>(s, scratch, bp);
  afl_tri::store_lower<kThreads>(s, b, l_out, b);
  afl_tri::invert_blocked<kThreads>(s, scratch, bp);
  afl_tri::store_lower<kThreads>(s, b, z_out, b);
}

using Launch = int (*)(const void*, int, int, void*, void*, void*);

template <class T, int kThreads, bool kAhead>
int launch_variant(const void* a, int lda, int b, void* l, void* z, void*) {
  const int bytes = tri_bytes<T>(b);
  const auto in = static_cast<const T*>(a);
  const auto lo = static_cast<T*>(l), zo = static_cast<T*>(z);
  if constexpr (kAhead) {
    auto kernel = factor_kernel<T, kThreads, afl_tri::NoMarks>;
    if (int err = prepare(kernel, bytes)) return err;
    kernel<<<1, kThreads, bytes>>>(in, lda, b, lo, zo, afl_tri::NoMarks{});
  } else {
    auto kernel = no_ahead_kernel<T, kThreads>;
    if (int err = prepare(kernel, bytes)) return err;
    kernel<<<1, kThreads, bytes>>>(in, lda, b, lo, zo);
  }
  return static_cast<int>(cudaGetLastError());
}

struct Variant {
  const char* name;
  Launch f32;
  Launch f64;
};

// An SPD (b, b) block XᵀX / rank from rank normal rows (at rank 4b, a
// condition number near 9), or a rank-3 one; f64, row-major.
std::vector<double> spd(int b, int rank, unsigned seed) {
  std::mt19937_64 gen(seed);
  std::normal_distribution<double> normal;
  std::vector<double> x(static_cast<size_t>(rank) * b), a(static_cast<size_t>(b) * b, 0.0);
  for (double& v : x) v = normal(gen);
  for (int r = 0; r < rank; ++r)
    for (int i = 0; i < b; ++i)
      for (int j = 0; j < b; ++j) a[i * b + j] += x[r * b + i] * x[r * b + j];
  for (double& v : a) v /= rank;
  return a;
}

void host_factor(const std::vector<double>& a, int b, std::vector<double>& l,
                 std::vector<double>& z) {
  l.assign(static_cast<size_t>(b) * b, 0.0);
  z.assign(static_cast<size_t>(b) * b, 0.0);
  for (int j = 0; j < b; ++j) {
    double d = a[j * b + j];
    for (int k = 0; k < j; ++k) d -= l[j * b + k] * l[j * b + k];
    l[j * b + j] = std::sqrt(d);
    for (int i = j + 1; i < b; ++i) {
      double v = a[i * b + j];
      for (int k = 0; k < j; ++k) v -= l[i * b + k] * l[j * b + k];
      l[i * b + j] = v / l[j * b + j];
    }
  }
  for (int c = 0; c < b; ++c)
    for (int i = c; i < b; ++i) {
      double v = i == c ? 1.0 : 0.0;
      for (int m = c; m < i; ++m) v -= l[i * b + m] * z[m * b + c];
      z[i * b + c] = v / l[i * b + i];
    }
}

float time_ms(const std::function<int()>& call) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int w = 0; w < 3; ++w) call();
  cudaDeviceSynchronize();
  std::vector<float> trials;
  for (int t = 0; t < 7; ++t) {
    spin<<<1, 1>>>(20000000LL);
    cudaEventRecord(e0);
    for (int r = 0; r < 200; ++r) call();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0;
    cudaEventElapsedTime(&ms, e0, e1);
    trials.push_back(ms / 200);
  }
  std::sort(trials.begin(), trials.end());
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return trials[3];
}

// Overwrites 128 MB, more than the 50 MB L2, so that what follows reads
// its inputs from device memory.
void flush_l2() {
  constexpr size_t kFlush = size_t(128) << 20;
  static void* flush = nullptr;
  static int fill = 0;
  if (flush == nullptr) cudaMalloc(&flush, kFlush);
  cudaMemsetAsync(flush, ++fill & 0xff, kFlush);
}

float time_cold_ms(const std::function<int()>& call) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  std::vector<float> trials;
  for (int t = 0; t < 51; ++t) {
    flush_l2();
    cudaEventRecord(e0);
    call();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0;
    cudaEventElapsedTime(&ms, e0, e1);
    trials.push_back(ms);
  }
  std::sort(trials.begin(), trials.end());
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return trials[25];
}

// Lane 0 of each warp that reaches a point raises its stamp to the warp's
// clock64(): the latest warp's arrival. One block, so one SM's clock.
struct Stamps {
  unsigned long long* t;
  __device__ void operator()(int point) const {
    if (threadIdx.x % 32 == 0) atomicMax(t + point, static_cast<unsigned long long>(clock64()));
  }
};

template <class T>
void run_phases(const T* in, int lda, int b, T* l, T* z, const std::vector<T>& l0,
                const std::vector<T>& z0) {
  namespace mk = afl_tri::marks;
  unsigned long long* d_st;
  cudaMalloc(&d_st, mk::kPoints * sizeof(unsigned long long));
  auto kernel = factor_kernel<T, kFactorThreads, Stamps>;
  const int bytes = tri_bytes<T>(b);
  prepare(kernel, bytes);
  auto call = [&]() {
    kernel<<<1, kFactorThreads, bytes>>>(in, lda, b, l, z, Stamps{d_st});
    return static_cast<int>(cudaGetLastError());
  };
  const float ms = time_ms(call);
  for (const bool cold : {false, true}) {
    if (cold) flush_l2();
    cudaMemset(d_st, 0, mk::kPoints * sizeof(unsigned long long));
    const int err = call();   // the stamps of one call
    cudaDeviceSynchronize();
    const size_t nb = static_cast<size_t>(b) * b;
    std::vector<T> hl(nb), hz(nb);
    cudaMemcpy(hl.data(), l, nb * sizeof(T), cudaMemcpyDeviceToHost);
    cudaMemcpy(hz.data(), z, nb * sizeof(T), cudaMemcpyDeviceToHost);
    const bool same = !err && std::memcmp(hl.data(), l0.data(), nb * sizeof(T)) == 0 &&
                      std::memcmp(hz.data(), z0.data(), nb * sizeof(T)) == 0;
    std::vector<unsigned long long> st(mk::kPoints);
    cudaMemcpy(st.data(), d_st, mk::kPoints * sizeof(unsigned long long), cudaMemcpyDeviceToHost);
    int khz = 0;
    cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
    auto us = [&](int i) {
      return st[i] ? static_cast<double>(st[i] - st[mk::kStart]) / (khz * 1e-3) : -1.0;
    };
    printf("{\"phases\": \"panel_factor\", \"threads\": %d, \"dtype\": \"%s\", \"b\": %d, "
           "\"l2\": \"%s\", \"stamped_ms\": %.5f, \"same_bits\": %s, \"us\": {\"loaded\": %.2f, "
           "\"sub_panels\": [",
           kFactorThreads, sizeof(T) == 4 ? "f32" : "f64", b, cold ? "cold" : "hot", ms,
           same ? "true" : "false", us(mk::kLoaded));
    const int bp = afl_tri::padded(b);
    for (int o = 0; o + afl_tri::kSub < bp; o += afl_tri::kSub)
      printf("%s{\"below\": %.2f, \"next\": %.2f, \"chain\": %.2f, \"update\": %.2f}",
             o ? ", " : "", us(mk::step(o, 0)), us(mk::step(o, 1)), us(mk::step(o, 2)),
             us(mk::step(o, 3)));
    printf("], \"factored\": %.2f, \"l_stored\": %.2f, \"sub_blocks\": %.2f, \"merge32\": %.2f, "
           "\"merge64\": %.2f, \"merge128\": %.2f, \"z_stored\": %.2f}}\n",
           us(mk::kFactored), us(mk::kInverting), us(mk::kSubBlocks), us(mk::kMerged),
           us(mk::kMerged + 1), us(mk::kMerged + 2), us(mk::kDone));
    fflush(stdout);
  }
  cudaFree(d_st);
}

template <class T>
bool run_case(int b, int lda, const std::vector<Variant>& variants) {
  const bool f32 = sizeof(T) == 4;
  const double tol = f32 ? 1e-4 : 1e-10;
  const std::vector<double> a = spd(b, 4 * b, 1000u + b);
  std::vector<double> l_ref, z_ref;
  host_factor(a, b, l_ref, z_ref);
  double l_max = 0, z_max = 0;
  for (double v : l_ref) l_max = std::max(l_max, std::fabs(v));
  for (double v : z_ref) z_max = std::max(z_max, std::fabs(v));
  // the block at a row stride, NaN above its diagonal and right of it
  std::vector<T> h_in(static_cast<size_t>(b) * lda, static_cast<T>(NAN));
  for (int i = 0; i < b; ++i)
    for (int j = 0; j <= i; ++j) h_in[static_cast<size_t>(i) * lda + j] = static_cast<T>(a[i * b + j]);
  const std::vector<double> r3 = spd(b, 3, 7u + b);
  std::vector<T> h_r3(static_cast<size_t>(b) * lda, static_cast<T>(NAN));
  for (int i = 0; i < b; ++i)
    for (int j = 0; j <= i; ++j) h_r3[static_cast<size_t>(i) * lda + j] = static_cast<T>(r3[i * b + j]);
  T *in, *in_r3, *l, *z;
  const size_t nb = static_cast<size_t>(b) * b;
  cudaMalloc(&in, h_in.size() * sizeof(T));
  cudaMalloc(&in_r3, h_r3.size() * sizeof(T));
  cudaMalloc(&l, nb * sizeof(T));
  cudaMalloc(&z, nb * sizeof(T));
  cudaMemcpy(in, h_in.data(), h_in.size() * sizeof(T), cudaMemcpyHostToDevice);
  cudaMemcpy(in_r3, h_r3.data(), h_r3.size() * sizeof(T), cudaMemcpyHostToDevice);
  std::vector<T> l0(nb), z0(nb), hl(nb), hz(nb);
  bool ok = true;
  printf("{\"dtype\": \"%s\", \"b\": %d, \"lda\": %d, \"ms\": {", f32 ? "f32" : "f64", b, lda);
  bool first = true;
  for (const Variant& v : variants) {
    const Launch fn = f32 ? v.f32 : v.f64;
    if (fn == nullptr) continue;
    auto call = [&]() { return fn(in, lda, b, l, z, nullptr); };
    const int err = call();
    const cudaError_t se = cudaDeviceSynchronize();
    printf("%s\"%s\": ", first ? "" : ", ", v.name);
    if (err || se) {
      printf("\"error %d %s\"", err, cudaGetErrorString(se));
      ok = false;
      first = false;
      continue;
    }
    cudaMemcpy(hl.data(), l, nb * sizeof(T), cudaMemcpyDeviceToHost);
    cudaMemcpy(hz.data(), z, nb * sizeof(T), cudaMemcpyDeviceToHost);
    double el = 0, ez = 0;
    bool upper_zero = true;
    for (int i = 0; i < b; ++i)
      for (int j = 0; j < b; ++j) {
        const size_t k = static_cast<size_t>(i) * b + j;
        if (j > i && (hl[k] != T(0) || hz[k] != T(0))) upper_zero = false;
        el = std::max(el, std::fabs(static_cast<double>(hl[k]) - l_ref[k]) / l_max);
        ez = std::max(ez, std::fabs(static_cast<double>(hz[k]) - z_ref[k]) / z_max);
        if (std::isnan(el) || std::isnan(ez)) el = ez = INFINITY;
      }
    if (first) {
      l0 = hl;
      z0 = hz;
    }
    const bool same = std::memcmp(l0.data(), hl.data(), nb * sizeof(T)) == 0 &&
                      std::memcmp(z0.data(), hz.data(), nb * sizeof(T)) == 0;
    fn(in_r3, lda, b, l, z, nullptr);
    cudaDeviceSynchronize();
    cudaMemcpy(hl.data(), l, nb * sizeof(T), cudaMemcpyDeviceToHost);
    bool nan = false;
    for (T x : hl) nan = nan || std::isnan(x);
    const bool good = el < tol && ez < tol && upper_zero && same && nan;
    ok = ok && good;
    printf("[%.5f, %.5f, %.2e, %.2e, \"%s\"]", time_ms(call), time_cold_ms(call), el, ez,
           good ? "ok" : (!same ? "BAD bits" : !nan ? "BAD no NaN" : "BAD"));
    first = false;
  }
  // the inverse alone, on the entry point's L
  cudaMemcpy(l, l0.data(), nb * sizeof(T), cudaMemcpyHostToDevice);
  auto inv = [&]() {
    return f32 ? afl_panel_tri_inv_f32(l, b, b, z, nullptr) : afl_panel_tri_inv_f64(l, b, b, z, nullptr);
  };
  printf("}, \"panel_tri_inv_ms\": %.5f}\n", time_ms(inv));
  fflush(stdout);
  if (b == kMaxPanel<T>) run_phases<T>(in, lda, b, l, z, l0, z0);
  cudaFree(in);
  cudaFree(in_r3);
  cudaFree(l);
  cudaFree(z);
  return ok;
}

int main() {
  const std::vector<Variant> variants = {
      {"panel_factor", afl_panel_factor_f32, afl_panel_factor_f64},
      {"256 ahead", launch_variant<float, 256, true>, launch_variant<double, 256, true>},
      {"1024 ahead", launch_variant<float, 1024, true>, nullptr},
      {"512", launch_variant<float, 512, false>, launch_variant<double, 512, false>},
      {"256", launch_variant<float, 256, false>, launch_variant<double, 256, false>}};
  bool ok = true;
  ok = run_case<float>(256, 2304, variants) && ok;
  ok = run_case<float>(200, 2304, variants) && ok;
  ok = run_case<float>(33, 64, variants) && ok;
  ok = run_case<double>(128, 2304, variants) && ok;
  ok = run_case<double>(100, 2304, variants) && ok;
  printf("%s\n", ok ? "all variants ok" : "BAD: a variant failed");
  return ok ? 0 : 1;
}
