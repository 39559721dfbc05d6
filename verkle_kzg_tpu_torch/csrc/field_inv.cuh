// The inverse of one Fq or Fr element on one thread: the binary extended
// Euclid of K1INV (field_inv.cu), shared with FSX (fiat_shamir.cu), which
// converts the IPA round's two points to affine with it.
#pragma once
#include "bn254_field.cuh"

namespace vkzg {

__device__ __forceinline__ bool is_one_raw(const uint32_t a[8]) {
  uint32_t acc = a[0] ^ 1u;
#pragma unroll
  for (int j = 1; j < 8; ++j) acc |= a[j];
  return acc == 0;
}

__device__ __forceinline__ void shr1(uint32_t a[8]) {
#pragma unroll
  for (int j = 0; j < 7; ++j) a[j] = __funnelshift_r(a[j], a[j + 1], 1);
  a[7] >>= 1;
}

// x / 2 mod m for x in [0, m): an odd x takes x + m first (below 2^255).
template <class F>
__device__ __forceinline__ void half_mod(uint32_t x[8]) {
  if (x[0] & 1u) {
    uint32_t k[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = F::m(j);
    add_raw(x, x, k);
  }
  shr1(x);
}

// r = a^-1 R for a Montgomery element a R in [1, m): the binary extended
// Euclid of (a R, m) (x1 a R = u, x2 a R = v mod m throughout) gives
// (a R)^-1 mod m in about 2 x 254 shifts and 254 subtractions of 256-bit
// words, a few dozen instructions each, where Fermat's a^(m - 2) chains 381
// Montgomery products of ~500; a Montgomery product by R^3 then gives
// a^-1 R. The iteration cap only bounds the loop for an input outside
// [1, m), which the callers never pass.
template <class F>
__device__ void finv(uint32_t r[8], const uint32_t a[8]) {
  uint32_t u[8], v[8], x1[8], x2[8], d[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    u[j] = a[j];
    v[j] = F::m(j);
    x1[j] = j == 0;
    x2[j] = 0;
  }
  for (int it = 0; it < 1024 && !is_one_raw(u) && !is_one_raw(v); ++it) {
    while (!(u[0] & 1u) && !is_zero(u)) {
      shr1(u);
      half_mod<F>(x1);
    }
    while (!(v[0] & 1u) && !is_zero(v)) {
      shr1(v);
      half_mod<F>(x2);
    }
    if (!sub_raw(d, u, v)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) u[j] = d[j];
      fsub<F, false>(x1, x1, x2);
    } else {
      sub_raw(v, v, u);
      fsub<F, false>(x2, x2, x1);
    }
  }
  const bool first = is_one_raw(u);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r[j] = first ? x1[j] : x2[j];
    d[j] = F::r3(j);
  }
  fmul<F, false>(r, r, d);
}

}  // namespace vkzg
