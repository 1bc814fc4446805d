// mma.sync primitives shared by the kernels that run a channel mix on it
// (amp_layer_tc.cu, amp_block.cu): ldmatrix, the bf16 and TF32 MMAs, and
// the 3xTF32 product (a float32 operand split into a TF32 part and its
// remainder; amp_layer_tc.cu's header gives the reasons).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ptts {

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v (float32 bits) -> big, v rounded to nearest (ties away from zero)
// with 11 significant bits, a TF32 value, in v's place, and small =
// v - big, exact in float32 and at most 2^-11 |v|. small goes to the
// tensor cores as it is: they read its top 11 bits, which leaves an error
// below 2^-21 |v|.
__device__ __forceinline__ void split_tf32(uint32_t& v, uint32_t& small) {
  const float f = __uint_as_float(v);
  uint32_t big;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(f));
  v = big;
  small = __float_as_uint(__fsub_rn(f, __uint_as_float(big)));
}

// acc += a * b to float32 precision: small*big, big*small, then big*big.
__device__ __forceinline__ void mma_tf32x3(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           uint32_t b0, uint32_t b1,
                                           uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(c, a_small, b0, b1);
  mma_tf32(c, a_big, b0_small, b1_small);
  mma_tf32(c, a_big, b0, b1);
}

}  // namespace ptts
