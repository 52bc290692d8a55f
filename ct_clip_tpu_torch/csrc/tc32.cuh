// tc32.cuh — the 3xTF32 arithmetic of the f32 tensor-core kernels
// (attention_tc32.cu, qknorm_attention_tc32.cu): the hi/lo split of an f32
// operand and the m16n8k8 TF32 `mma.sync` products with f32 accumulators.
//
// Each f32 operand x splits into hi = tf32(x) (round to nearest, ties away,
// 10 mantissa bits) and lo = x - hi (read as TF32, truncated), and A B ~
// hi hi + hi lo + lo hi, accumulated in f32 (lo lo, ~2^-22 of the product,
// is dropped).  Built with CT_TC32_PASSES=1 a source runs hi hi alone, plain
// TF32: the copy the card checks hold it against to show that the tolerance
// tells the two apart.
#pragma once

#include <stdint.h>

#ifndef CT_TC32_PASSES
#define CT_TC32_PASSES 3  // 3: hi hi + hi lo + lo hi; 1: hi hi alone (plain TF32)
#endif

namespace {

// x = hi + lo as TF32 operands: hi is x rounded to 10 mantissa bits, to
// nearest with ties away from zero (cvt.rna.tf32.f32's result, in two
// integer operations: cvt runs on the conversion unit at a fraction of their
// rate, and two per element cost the kernel ~25% on the card); lo = x - hi
// is exact in f32, and the tensor core reads a TF32 operand from the top 19
// bits of its register, so lo enters truncated (|error| < 2^-22 |x|, the
// order of the lo lo term 3xTF32 drops).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = CT_TC32_PASSES == 3 ? __float_as_uint(x - __uint_as_float(hi)) : 0u;
}

// d += A B: m16 n8 k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (CT_TC32_PASSES == 3) {
    mma(d, al, bh);
    mma(d, ah, bl);
  }
  mma(d, ah, bh);
}

}  // namespace
