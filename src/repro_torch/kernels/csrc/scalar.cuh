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
