// Helpers shared by the int8 product kernels (s8_matmul.cu, s8_gemm.cu).
#pragma once

#include <stdint.h>

// rows r0..r3 hold 4 byte columns each (byte c = column c); returns in
// col[c] the 4 rows of column c (byte j = row j): the layout that dp4a and
// the k-packed mma fragments read.
__device__ __forceinline__ void transpose4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                           uint32_t* col) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t u0 = __byte_perm(r2, r3, 0x5140), u1 = __byte_perm(r2, r3, 0x7362);
  col[0] = __byte_perm(t0, u0, 0x5410);
  col[1] = __byte_perm(t0, u0, 0x7632);
  col[2] = __byte_perm(t1, u1, 0x5410);
  col[3] = __byte_perm(t1, u1, 0x7632);
}
