// Hopper (sm_90a) building blocks of the tensor-core kernels
// (sclad_matmul.cu, flash_attention.cu, paged_prefill.cu,
// decode_attention.cuh): 16- and 4-byte asynchronous copies into shared
// memory with a zero-fill form, their commit / wait groups, ldmatrix
// (plain and transposed), the bf16 m16n8k16 tensor-core product with fp32
// sums, packing two fp32 values into one bf16x2 register, and 2^x on the
// special-function unit.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t, g < 8, t < 4):
//   A (16 x 16, row-major):  a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..),
//                            a[2] = (g, 8 + 2t..), a[3] = (g + 8, 8 + 2t..);
//   B (16 x 8, k x n):       b[0] = (k 2t..2t+1, n g),
//                            b[1] = (k 8 + 2t..8 + 2t + 1, n g);
//   C/D (16 x 8, fp32):      d[0..1] = (g, 2t..2t+1), d[2..3] = (g + 8, 2t..).
// ldmatrix.x4 gives lane l row l / 4, columns 2 (l % 4)..+1 of each of four
// 8 x 8 matrices whose row addresses lanes 8i..8i+7 supply; .trans gives the
// transposed element pair, so a B tile stored k-major (row k, columns n)
// comes out as B fragments.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace repro_torch {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until a wait on its group.  With
// `pred` false nothing is read and the 16 bytes are zero-filled (src-size
// 0); `src` must still be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// 4 bytes global -> shared (through L1; the 4-byte form has no .cg), as
// cp_async16; both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a @ b: bf16 products, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to nearest-even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (ex2.approx.ftz: 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mma
}  // namespace repro_torch
