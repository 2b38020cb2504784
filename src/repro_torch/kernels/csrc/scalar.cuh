// Scalar helpers that the solve-side kernels share across their f32 and
// f64 instances: one name for each operation, overloaded on the type, so
// that a kernel templated on T says fma_(a, b, c) and sqrt_(x) and gets
// fmaf / sqrtf in f32 and the native FP64 fma / sqrt in f64. Both are
// IEEE (no fast math, no mixed precision): an f64 instance rounds only in
// f64.

#pragma once

namespace afl {

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ double sqrt_(double a) { return sqrt(a); }

// The split products of precision "f32_x2" (src/repro/kernels/solve.py:
// _split, _make_mm). split is the reference's Dekker split of an f32 value,
// t = a·4097, hi = t − (t − a), lo = a − hi: a == hi + lo exactly, each
// half with at most 12 significant bits, so every product of two halves is
// exact in f32 and an FMA chain of them rounds only its sums. Each step
// rounds on its own: nvcc (-fmad=true, its default) may contract a written
// a·4097 − a into one FMA, which would leave hi more than 12 bits, and the
// _rn intrinsics are never contracted.
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float t = __fmul_rn(a, 4097.0f);
  hi = __fsub_rn(t, __fsub_rn(t, a));
  lo = __fsub_rn(a, hi);
}

// One output's sums over k, each an FMA chain in k's order: the product
// (native), or (X2, f32 only) its three sums of split halves, hi·hi, hi·lo
// and lo·hi, which sum() adds as the reference adds them: hh + (hl + lh).
// add(ah, al, bh, bl) takes both operands' halves (native: the values and
// anything, which it does not read).
template <class T, bool X2>
struct Sums {
  T hh = T(0);
  __device__ __forceinline__ void add(T a, T, T b, T) { hh = fma_(a, b, hh); }
  __device__ __forceinline__ T sum() const { return hh; }
};
template <>
struct Sums<float, true> {
  float hh = 0.f, hl = 0.f, lh = 0.f;
  __device__ __forceinline__ void add(float ah, float al, float bh, float bl) {
    hh = fmaf(ah, bh, hh);
    hl = fmaf(ah, bl, hl);
    lh = fmaf(al, bh, lh);
  }
  __device__ __forceinline__ float sum() const { return __fadd_rn(hh, __fadd_rn(hl, lh)); }
};

// Four consecutive values from shared memory, 16-byte aligned: one float4
// in f32, two double2 in f64.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

}  // namespace afl
