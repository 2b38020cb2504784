// cp.async between device memory and shared memory, shared by the kernels
// that stage their operands through a ring of shared-memory slots
// (gemm_nt.cuh's tiles, gram.cu, flash_attention.cu). A copy of 16 or 8
// bytes reads its first `bytes` and zero-fills the rest, so `bytes` = 0
// writes zeros and reads nothing: the ragged edges of a tile cost no branch
// around the copy. Copies complete in the order of their commit groups;
// wait<N> returns once at most N groups are still in flight, and a
// __syncthreads() after it makes the landed data visible to the block.

#pragma once

namespace afl {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace afl
