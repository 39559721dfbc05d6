// The inverse of one Fq or Fr element on one thread, shared by K1INV
// (field_inv.cu), K1AFF (affine.cu) and FSX (fiat_shamir.cu), whose time at
// small sizes is this function's dependent chain.
//
// Pornin's optimized binary GCD ("Optimized Binary GCD for Modular
// Inversion", IACR ePrint 2020/972, algorithm 2, with k = 32): the binary
// GCD of (a R, m) runs 31 steps at a time on 64-bit approximations of its
// two values (their 31 low bits and 33 top bits, in registers), which give
// the steps' 2 x 2 matrix of factors below 2^31; each outer iteration then
// applies the matrix to the 256-bit values (dividing by 2^31, exactly) and
// to their cofactors mod m (each a Montgomery reduction by 2^32). 18 outer
// iterations cover the 2 x 254 - 1 steps that the binary GCD of a 254-bit
// modulus needs, with one to spare (a finished GCD stays as it is). A step
// on 256-bit words is a few dozen dependent instructions; here only 18 of
// the 558 steps touch them. An inverse is unique, so the words are those
// of any other method.
#pragma once
#include "bn254_field.cuh"

namespace vkzg {

constexpr int INV_STEPS = 31;  // binary GCD steps an outer iteration (k - 1)
constexpr int INV_OUTER = 18;  // outer iterations

// 2^INV_OUTER R^3 mod m: the cofactor's 2^(32 - 31) an outer iteration
// back, and (a R)^-1 to a^-1 R, in one Montgomery product.
template <class F>
__device__ __forceinline__ uint32_t inv_fix(int i);
template <>
__device__ __forceinline__ uint32_t inv_fix<Fq>(int i) {
  const uint32_t v[8] = {0x5e2aa5e6u, 0xcdfd1419u, 0xbace4921u, 0x61eafd5bu,
                         0x5fe0c4a6u, 0x7736909eu, 0xec1e39dbu, 0x13bcbd83u};
  return v[i];
}
template <>
__device__ __forceinline__ uint32_t inv_fix<Fr>(int i) {
  const uint32_t v[8] = {0x40feed8cu, 0xc84b3513u, 0x385efdd8u, 0xacd5a0cfu,
                         0x2084e9e4u, 0xaa959930u, 0x6e08eac5u, 0x1bc37e1cu};
  return v[i];
}

__device__ __forceinline__ int bit_length(const uint32_t a[8]) {
  int len = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (a[j]) len = 32 * j + 32 - __clz(a[j]);
  return len;
}

// The 64-bit approximation of a for the common length n >= 64: its 31 low
// bits, then its bits [n - 33, n).
__device__ __forceinline__ uint64_t approx(const uint32_t a[8], int n) {
  const int s = n - 33, w = s >> 5, r = s & 31;
  const uint64_t lo = (uint64_t)pick_word(a, w) | ((uint64_t)pick_word(a, w + 1) << 32);
  uint64_t top = lo >> r;
  if (r) top |= (uint64_t)pick_word(a, w + 2) << (64 - r);
  return (uint64_t)(a[0] & 0x7fffffffu) | ((top & 0x1ffffffffull) << 31);
}

// r (9 words) = x * s for s < 2^32.
__device__ __forceinline__ void mul_word(uint32_t r[9], const uint32_t x[8], uint32_t s) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c += (uint64_t)x[j] * s;
    r[j] = (uint32_t)c;
    c >>= 32;
  }
  r[8] = (uint32_t)c;
}

// |x f + y g| (9 words) and its sign, for 256-bit x, y and |f|, |g| <= 2^31.
__device__ __forceinline__ bool lin_comb(uint32_t r[9], const uint32_t x[8], int64_t f,
                                         const uint32_t y[8], int64_t g) {
  uint32_t p[9], q[9];
  mul_word(p, x, (uint32_t)(f < 0 ? -f : f));
  mul_word(q, y, (uint32_t)(g < 0 ? -g : g));
  if ((f < 0) == (g < 0)) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      c += (uint64_t)p[j] + q[j];
      r[j] = (uint32_t)c;
      c >>= 32;
    }
    return f < 0;
  }
  uint32_t br = 0;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const uint64_t d = (uint64_t)p[j] - q[j] - br;
    r[j] = (uint32_t)d;
    br = (uint32_t)(d >> 63);
  }
  if (br) {  // q > p: negate
    uint32_t c = 1;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const uint64_t t = (uint64_t)(~r[j]) + c;
      r[j] = (uint32_t)t;
      c = (uint32_t)(t >> 32);
    }
  }
  return (f < 0) != (br != 0);
}

// out = |x f + y g| / 2^31, exact; returns whether x f + y g was negative.
__device__ __forceinline__ bool lin_shift(uint32_t out[8], const uint32_t x[8], int64_t f,
                                          const uint32_t y[8], int64_t g) {
  uint32_t r[9];
  const bool neg = lin_comb(r, x, f, y, g);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __funnelshift_r(r[j], r[j + 1], 31);
  return neg;
}

// out = (x f + y g) 2^-32 mod m, in [0, m), for x, y in [0, m): a
// Montgomery reduction by one word of |x f + y g| (< m 2^32), then the sign.
template <class F>
__device__ __forceinline__ void lin_mod(uint32_t out[8], const uint32_t x[8], int64_t f,
                                        const uint32_t y[8], int64_t g) {
  uint32_t r[9];
  const bool neg = lin_comb(r, x, f, y, g);
  const uint32_t q = r[0] * F::n0;
  uint64_t c = ((uint64_t)q * F::m(0) + r[0]) >> 32;
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    c += (uint64_t)q * F::m(j) + r[j];
    out[j - 1] = (uint32_t)c;
    c >>= 32;
  }
  out[7] = (uint32_t)(c + r[8]);  // (|x f + y g| + q m) / 2^32 < 2m < 2^256
  cond_sub<F, false>(out);
  if (neg && !is_zero(out)) {
    uint32_t k[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = F::m(j);
    sub_raw(out, k, out);
  }
}

// r = a^-1 R for a Montgomery element a R in [1, m).
template <class F>
__device__ void finv(uint32_t r[8], const uint32_t a_in[8]) {
  uint32_t a[8], b[8], u[8], v[8], t[8], w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j] = a_in[j];
    b[j] = F::m(j);
    u[j] = j == 0;
    v[j] = 0;
  }
#pragma unroll 1
  for (int it = 0; it < INV_OUTER; ++it) {
    int n = bit_length(a), nb = bit_length(b);
    n = n > nb ? n : nb;
    n = n > 64 ? n : 64;
    uint64_t xa = approx(a, n), xb = approx(b, n);
    int64_t f0 = 1, g0 = 0, f1 = 0, g1 = 1;
#pragma unroll
    for (int j = 0; j < INV_STEPS; ++j) {
      const bool odd = xa & 1;
      const bool swap = odd && xa < xb;
      const uint64_t ta = swap ? xb : xa, tb = swap ? xa : xb;
      const int64_t tf0 = swap ? f1 : f0, tg0 = swap ? g1 : g0;
      const int64_t tf1 = swap ? f0 : f1, tg1 = swap ? g0 : g1;
      xa = (odd ? ta - tb : ta) >> 1;
      xb = tb;
      f0 = odd ? tf0 - tf1 : tf0;
      g0 = odd ? tg0 - tg1 : tg0;
      f1 = tf1 * 2;
      g1 = tg1 * 2;
    }
    if (lin_shift(t, a, f0, b, g0)) {
      f0 = -f0;
      g0 = -g0;
    }
    if (lin_shift(w, a, f1, b, g1)) {
      f1 = -f1;
      g1 = -g1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] = t[j];
      b[j] = w[j];
    }
    lin_mod<F>(t, u, f0, v, g0);
    lin_mod<F>(w, u, f1, v, g1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      u[j] = t[j];
      v[j] = w[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = inv_fix<F>(j);
  fmul<F, false>(r, v, t);
}

}  // namespace vkzg
