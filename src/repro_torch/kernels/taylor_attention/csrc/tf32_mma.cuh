// Split-precision TF32 tensor-core products (mma.sync m16n8k8, f32 accumulation), shared
// by taylor_fwd.cu and taylor_bwd.cu.
//
// Fragments (lane = 4·g + t): A (16×8, row-major) a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); B (8×8) b0 (t, g), b1 (t+4, g); C (16×8) c0 (g, 2t), c1 (g, 2t+1),
// c2 (g+8, 2t), c3 (g+8, 2t+1).
//
// Split precision: one TF32 product keeps ~11 bits.  An f32 operand x is split as
// hi = x rounded to TF32 (to nearest, on the bits) and lo = x − hi (exact), of which the
// tensor core reads the top 19 bits, so x = hi + lo up to 2^-21·|x|; a·b is then summed
// as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (a_lo·b_lo, ~2^-22, is dropped), ~2e-7 relative.
// An operand whose values are exact in TF32 (bf16 inputs) is not split.

#pragma once

#include <cstdint>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo exactly: hi is x rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna rounds finite values; cvt.rna itself compiles to a longer sequence), lo the
// rest, of which the tensor core reads the top 19 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// An operand fragment (4 values for A, 2 for B): split when it holds f32 data, taken
// as it is when its values are exact in TF32 (bf16 inputs).
template <int N, bool SPLIT>
struct Frag {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int u, float x) {
    if constexpr (SPLIT) split(x, hi[u], lo[u]);
    else hi[u] = __float_as_uint(x);
  }
};

// d += a·b over the products the split keeps: a_hi·b_hi, and a_lo·b_hi / a_hi·b_lo where
// a / b is split (a_lo·b_lo is dropped); the small terms first.
template <bool SA, bool SB>
__device__ __forceinline__ void mma_split(float (&d)[4], const Frag<4, SA>& a,
                                          const Frag<2, SB>& b) {
  if constexpr (SA) mma(d, a.lo, b.hi[0], b.hi[1]);
  if constexpr (SB) mma(d, a.hi, b.lo[0], b.lo[1]);
  mma(d, a.hi, b.hi[0], b.hi[1]);
}
