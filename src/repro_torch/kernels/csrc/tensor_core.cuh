// bf16 products on Hopper's tensor cores, for flash_attention.cu's bf16
// instance: products of bf16 values are exact in f32 and every sum is f32.
//
// wgmma (sm_90a): a warpgroup (4 warps, 128 threads) issues an asynchronous
// m64n64k16 product, D (64 × 64, f32) += A (64 × 16) · B (16 × 64), B from
// shared memory through a descriptor, A from shared memory (wgmma_ss) or
// from registers (wgmma_rs). Thread i of warp w holds D's rows 16w + i/4
// and 16w + i/4 + 8 at columns 8j + 2(i%4) and one more, j = 0 .. 7:
//
//   d[4j + 0], d[4j + 1]: row 16w + i/4,     columns 8j + 2(i%4), + 1
//   d[4j + 2], d[4j + 3]: row 16w + i/4 + 8, the same columns
//
// and the register A of a k16 slice in the same places (a[0]: row i/4,
// columns 2(i%4), + 1; a[1]: row + 8; a[2], a[3]: columns + 8), so D's
// columns 16s .. 16s + 15, narrowed to bf16 pairs, are the A of the next
// product's slice s: P goes from the first product to the second in
// registers.
//
// Shared-memory operands use the 128-byte swizzle: an operand is blocks of
// 64 columns (128 bytes of bf16), each block its rows of 128 bytes one
// after the other, and the 16-byte chunk c of row r sits at chunk c ^ (r %
// 8) of its row (sw128_offset). A block starts on a 1024-byte boundary, as
// the swizzle is a function of the address. The same bytes serve as a
// K-major operand (the 16 values of a k slice contiguous in a row: Q and K
// of Q·Kᵀ; a slice s is the block's start + 32·s bytes, 8-row groups 1024
// bytes apart) and as an MN-major one (rows are k, the 64 columns N: V of
// P·V, with the transpose bit; a slice s is the start + 2048·s bytes, k
// groups of 8 rows 1024 bytes apart).
//
// Async-proxy ordering: shared memory written by threads (cp.async, plain
// stores) is made visible to wgmma by fence.proxy.async, then a barrier;
// wgmma_fence orders register writes before the next wgmma reads them;
// commit / wait<N> bound the products in flight, and fence_operand keeps
// the compiler from reading an accumulator before the wait, or from reusing
// an A register while a product may still read it.
//
// mma.sync (the decode): m16n8k16 with A row-major and B column-major
// (a[0..3] as above for 16 rows, b[0]: k 2(i%4), + 1 at column i/4, b[1]:
// k + 8), C (16 × 8, f32): c[0], c[1] row i/4, columns 2(i%4), + 1; c[2],
// c[3] row + 8. Operands come from shared memory by ldmatrix (.trans for
// the value rows of P·V).

#pragma once

#include <cstdint>

#include "cp_async.cuh"

namespace afl_tc {

// byte offset of 16-byte chunk c (columns 8c .. 8c + 7) of row r in an
// operand of `rows` rows in the 128-byte swizzle
__device__ __forceinline__ int sw128_offset(int rows, int r, int c) {
  return (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// A shared-memory matrix descriptor in the 128-byte swizzle: start address,
// leading and stride byte offsets (each >> 4), layout type 1 (128B)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d (+)= A · B, A and B from shared memory (TRANS_B: B is MN-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// d (+)= A · B, A (bf16 pairs) from registers, B from shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(TRANS_B));
}

// c += a · b, m16n8k16, bf16 in, f32 sums
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 × 8 matrices of 16-bit values: lane l gives the address of row l %
// 8 of matrix l / 8; r[j] is this thread's part of matrix j (TRANS: of its
// transpose)
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const unsigned addr = afl::smem_u32(row);
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  }
}

}  // namespace afl_tc
