// Warp-level bf16 tensor-core helpers (mma.sync.m16n8k16, sm_80 and
// later): the product of a 16 x 16 A tile and a 16 x 8 B tile summed
// into a 16 x 8 f32 tile, all held in registers spread over the warp.
//
// Fragments, with g = lane / 4 and t = lane % 4 (PTX ISA, "Matrix
// fragments for mma.m16n8k16"):
//   A (row-major, 4 x 32 bits): a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t,
//     2t+1], a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9];
//   B (4 bf16 in 2 x 32 bits): b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   C (4 f32): c[0], c[1] = C[g][2t, 2t+1]; c[2], c[3] = C[g+8][2t, 2t+1].
// The first element of a pair sits in the low 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {

// c += A B
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16, lo in the low 16 bits
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 (4-byte aligned) as one 32-bit word
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace ptt
