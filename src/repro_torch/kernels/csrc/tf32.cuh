// 3xTF32 on Hopper's tensor cores: float32 products at float32 accuracy
// through mma.sync TF32, shared by ssm_scan.cu and flash_attention.cu.
//
// Every product operand v is split into two TF32 values, v_hi = rna(v) and
// v_lo = rna(v - v_hi), where rna rounds to 10 mantissa bits, ties away
// from zero: the bits of cvt.rna.tf32.f32, computed on the integer units
// ((bits + 0x1000) & ~0x1fff), which issue at full rate where the
// conversion does not.  A product a b then runs as three TF32 products with
// float32 sums, a_lo b_hi + a_hi b_lo + a_hi b_hi; a_lo b_lo (~2^-22
// relative) is dropped.  One plain TF32 product is ~2^-11 relative.
//
// A build's library hash covers this header (repro_torch/kernels/build.py).

#pragma once

#include <stdint.h>

// cvt.rna.tf32.f32 on the integer units: round the magnitude to 10
// mantissa bits, ties away from zero (the same bits for every finite x)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// the 3xTF32 split: x = hi + lo + O(2^-22 x), hi and lo TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], hi[i], lo[i]);
}

// d += a b, a 16 x 8 (row) and b 8 x 8 (col) TF32 fragments, f32 sums.
// Fragments of lane = 4 g + t: a = (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b = (t, g), (t + 4, g); d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
