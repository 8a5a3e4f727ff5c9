// Float32 products on Hopper's tensor cores by split precision (3xTF32).
//
// A float32 operand x is split into two TF32 parts, hi = rn(x) and
// lo = rn(x - hi), each with 11 significant bits (round to nearest, ties
// away from zero), so hi + lo keeps 22 bits of x.  A product of two split
// operands is three mma.sync.m16n8k8 TF32 products, lo*hi + hi*lo + hi*hi
// (the lo*lo term is below float32's last bit); an operand that is exact
// in TF32 (a bfloat16 value) is not split and takes two, lo*b + hi*b.
// The tensor cores add the products of one mma with truncation, not
// rounding, so each k-step of 8 is summed in a fresh accumulator and added
// to the running sum by an ordinary (rounded) float32 add: the truncation
// then acts on an 8-term partial sum, not on the whole sum.
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product whose k index is summed over may take its k in any order that
// A and B share.  The kernels use two: the natural one above, and the
// "paired" order k = t <-> column 2t, k = t + 4 <-> column 2t + 1, in
// which a lane's two k values are neighbouring columns and load as one
// 8-byte word.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tf32 {

// x rounded to TF32 (nearest, ties away from zero), as float32 bits with
// the 13 low mantissa bits clear.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// An A fragment split into its two parts.
struct FragA {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  const Split s0 = split(a0), s1 = split(a1), s2 = split(a2), s3 = split(a3);
  return {{s0.hi, s1.hi, s2.hi, s3.hi}, {s0.lo, s1.lo, s2.lo, s3.lo}};
}

// A B fragment: split (lo != 0) or exact in TF32 (lo unused).
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  return {{s0.hi, s1.hi}, {s0.lo, s1.lo}};
}

// A bfloat16 value as TF32 bits: exact (8 significant bits of 11).
__device__ __forceinline__ uint32_t from_bf16(__nv_bfloat16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A B over one k-step of 8; A split unless kExactA, B split
// unless kExactB (an exact operand's lo part is not read).
template <bool kExactB, bool kExactA = false>
__device__ __forceinline__ void mma_step(float (&acc)[4], const FragA& a,
                                         const FragB& b) {
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  if (!kExactA) mma(part, a.lo, b.hi);
  if (!kExactB) mma(part, a.hi, b.lo);
  mma(part, a.hi, b.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// One pass of mma_step: pass 0 is lo*hi (skipped when A is exact), 1 is
// hi*lo (skipped when B is exact), 2 is hi*hi.  A loop over the passes
// outside a loop over independent tiles keeps several mma in flight where
// mma_step, one tile at a time, waits on each.
template <bool kExactB, bool kExactA = false>
__device__ __forceinline__ void mma_pass(float (&part)[4], const FragA& a,
                                         const FragB& b, int pass) {
  if (pass == 0) {
    if (!kExactA) mma(part, a.lo, b.hi);
  } else if (pass == 1) {
    if (!kExactB) mma(part, a.hi, b.lo);
  } else {
    mma(part, a.hi, b.hi);
  }
}

}  // namespace tf32
