// BN254 Fq / Fr arithmetic as __device__ functions: eight little-endian
// 32-bit words per element, Montgomery radix R = 2^256. Shared by every
// kernel of the port (K1-K4).
//
// Replaces the kernel-body helpers of verkle_kzg_tpu/ops/pallas_field.py:
// k_mont_mul / k_add / k_sub / k_cond_sub (reduced domain [0, m)) and
// k_mont_mul_lazy / k_add_lazy / k_sub_lazy / k_mul9_lazy (lazy domain
// [0, 2m), valid because 4m < 2^256 for both BN254 fields, so a Montgomery
// product of two lazy values lands below 2m with no final subtraction).
//
// Every function returns the same integer as the JAX kernels and as the
// plain versions in ops/field.py: a reduced value is unique, and the lazy
// forms follow the same rule (subtract 2m only when the sum reaches it; a
// difference gets 2m added only when it borrows).
#pragma once
#include <stdint.h>

namespace vkzg {

struct Fq {
  static __device__ __forceinline__ uint32_t m(int i) {
    const uint32_t v[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  static __device__ __forceinline__ uint32_t m2(int i) {
    const uint32_t v[8] = {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u,
                           0x0302b0bbu, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return v[i];
  }
  // R mod m: Montgomery one.
  static __device__ __forceinline__ uint32_t one(int i) {
    const uint32_t v[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                           0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
  static constexpr uint32_t n0 = 0xe4866389u;  // -m^-1 mod 2^32
};

struct Fr {
  static __device__ __forceinline__ uint32_t m(int i) {
    const uint32_t v[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return v[i];
  }
  static __device__ __forceinline__ uint32_t m2(int i) {
    const uint32_t v[8] = {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u,
                           0x0302b0bau, 0x70a08b6du, 0xc2634053u, 0x60c89ce5u};
    return v[i];
  }
  static __device__ __forceinline__ uint32_t one(int i) {
    const uint32_t v[8] = {0x4ffffffbu, 0xac96341cu, 0x9f60cd29u, 0x36fc7695u,
                           0x7879462eu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return v[i];
  }
  static constexpr uint32_t n0 = 0xefffffffu;
};

// r = a + b over 256 bits; returns the carry out.
__device__ __forceinline__ uint32_t add_raw(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8]) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)a[j] + b[j];
    r[j] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// r = a - b over 256 bits; returns the borrow out.
__device__ __forceinline__ uint32_t sub_raw(uint32_t r[8], const uint32_t a[8],
                                            const uint32_t b[8]) {
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t d = (uint64_t)a[j] - b[j] - br;
    r[j] = (uint32_t)d;
    br = (uint32_t)(d >> 63);
  }
  return br;
}

// x -= k if x >= k, for k = m (TWO = false) or 2m (TWO = true).
template <class F, bool TWO>
__device__ __forceinline__ void cond_sub(uint32_t x[8]) {
  uint32_t k[8], t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) k[j] = TWO ? F::m2(j) : F::m(j);
  uint32_t br = sub_raw(t, x, k);
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = br ? x[j] : t[j];
}

// Modular add: reduced [0, m) (LAZY = false) or lazy [0, 2m) (LAZY = true).
template <class F, bool LAZY>
__device__ __forceinline__ void fadd(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  add_raw(r, a, b);  // a + b < 4m < 2^256: no carry out
  cond_sub<F, LAZY>(r);
}

// Modular subtract in either domain: a - b, plus m (2m) when it borrows.
template <class F, bool LAZY>
__device__ __forceinline__ void fsub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t br = sub_raw(r, a, b);
  if (br) {
    uint32_t k[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = LAZY ? F::m2(j) : F::m(j);
    add_raw(r, r, k);
  }
}

// Montgomery product a * b / R by CIOS over 32-bit words. Inputs below 2m
// give a result below 2m; LAZY = false reduces it to [0, m). r may alias
// a or b.
template <class F, bool LAZY>
__device__ __forceinline__ void fmul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t q = t[0] * F::n0;
    c = ((uint64_t)q * F::m(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)q * F::m(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = t[j];
  if (!LAZY) cond_sub<F, false>(r);
}

// 9x as x8 + x (b3 = 3 * 3 for BN254 G1), in either domain; each doubling
// stays below 4m < 2^256 before its conditional subtract.
template <class F, bool LAZY>
__device__ __forceinline__ void fmul9(uint32_t r[8], const uint32_t x[8]) {
  uint32_t t[8];
  fadd<F, LAZY>(t, x, x);
  fadd<F, LAZY>(t, t, t);
  fadd<F, LAZY>(t, t, t);
  fadd<F, LAZY>(r, t, x);
}

__device__ __forceinline__ bool is_zero(const uint32_t a[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc |= a[j];
  return acc == 0;
}

__device__ __forceinline__ void load8(uint32_t r[8], const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 lo = q[0], hi = q[1];
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void store8(uint32_t* p, const uint32_t a[8]) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(a[0], a[1], a[2], a[3]);
  q[1] = make_uint4(a[4], a[5], a[6], a[7]);
}

// Word w of the scalar by a chain of selects: a register array indexed at
// run time would be placed in local memory.
__device__ __forceinline__ uint32_t pick_word(const uint32_t k[8], int w) {
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) out = (j == w) ? k[j] : out;
  return out;
}

// The highest set bit over the scalars of the whole warp, -1 if all are 0.
__device__ __forceinline__ int warp_top_bit(const uint32_t k[8]) {
  int top = -1;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (k[j]) top = 32 * j + 31 - __clz(k[j]);
  return __reduce_max_sync(0xFFFFFFFFu, top);
}

}  // namespace vkzg
