// Split-TF32 products on Hopper's tensor cores through mma.sync (the cube
// kernels cube_coef.cu and cube_accel.cu, and the accumulation probe
// probe_tf32_accum.cu).
//
// A finite float x is split as x = hi + lo + r with hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest, ties away from zero:
// x - hi is exact in f32, |lo| <= 2^-11 |x| and |r| <= 2^-22 |x|.  A product
// of two split values is taken as hi hi' + hi lo' + lo hi' (three mma
// passes), which drops lo lo' and the r terms, about 3 2^-22 of |x x'|; the
// tensor core multiplies TF32 values exactly and adds in f32.
//
// The fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 for
// lane = 4 g + t (g = groupID, t = threadID_in_group), as PTX defines them:
//   A (16 x 8, rows x k):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4);
//   B (8 x 8, k x cols):   b0 (t, g), b1 (t + 4, g);
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tf32 {

// x rounded to TF32 (10 explicit mantissa bits), nearest, ties away from
// zero: cvt.rna.tf32.f32 for finite x, in two integer operations (adding
// half an ulp to the magnitude carries into the exponent as it should);
// cvt's own code adds a test for inf and NaN, four operations in all.
__device__ __forceinline__ uint32_t round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = round(x);
  return {hi, round(x - __uint_as_float(hi))};
}

// d += a b on the tensor cores, one m16n8k8 TF32 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += (ah + al)(bh + bl) less al bl: the three passes, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

}  // namespace tf32
