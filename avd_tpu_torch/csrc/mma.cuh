// Thin wrappers over the PTX that the port's kernels are built from:
// asynchronous global→shared copies (cp.async), 8×8 matrix loads from
// shared memory into mma fragments (ldmatrix) and the warp-level bf16
// product mma.sync.m16n8k16 with float32 accumulation.
//
// Fragment layouts, with g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix
// fragments for mma.m16n8k16"):
//   A (16×16, row major), 4 registers of two bf16 each:
//     a0 = A[g][2t, 2t+1]      a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, 2t+9]    a3 = A[g+8][2t+8, 2t+9]
//   B (16×8, column major), 2 registers:
//     b0 = B[2t, 2t+1][g]      b1 = B[2t+8, 2t+9][g]
//   C, D (16×8, float32), 4 registers:
//     c0, c1 = C[g][2t, 2t+1]  c2, c3 = C[g+8][2t, 2t+1]
// ldmatrix.x4 reads four 8×8 bf16 matrices; lanes 8i … 8i+7 give the row
// addresses of matrix i and every lane receives, in register i, the two
// elements [g][2t, 2t+1] of matrix i (of its transpose with .trans).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace avd {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, bypassing L1; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// 4 bytes global → shared; both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// Close the group of cp.async this thread has started since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait for every cp.async this thread has started.  The copies of other
// threads need a barrier on top (__syncwarp / __syncthreads).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem_row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(smem_row))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem_row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(smem_row))
      : "memory");
}

// c += A·B on the tensor cores: A 16×16 bf16 (a[0..3]), B 16×8 bf16
// (b0, b1), c 16×8 float32.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace avd
