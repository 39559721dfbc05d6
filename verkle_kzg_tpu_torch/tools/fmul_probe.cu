// Probe of Montgomery products on the card, built and read by
// tools/fmul_probe.py: csrc/bn254_field.cuh's fmul (every kernel's) against
// fmul_cc, the same CIOS over PTX carry chains (below). One kernel per
// product holding a single Fq product (for its SASS), a kernel comparing
// the two products' words over many pairs, and a one-thread chain of
// dependent products (for the latency of one product on a lone warp).
#include <cuda_runtime.h>

#include "bn254_field.cuh"

using namespace vkzg;

// fmul's CIOS product on Fq over PTX carry chains, with m and n0 as
// compile-time words: per round, t += a * b[i] as one chain of low halves
// and one of high halves, then t += q m (q = t0 n0) the same way, and a
// one-word shift. Each asm block starts and ends its own carry chain. The
// 9-word accumulator cannot overflow: t < a + m < 3m before a round, and
// t + a b[i] + q m < 3m + 3m 2^32 < 2^288. The result is the same integer
// as fmul's, since a quotient in [0, 2^256) is unique. No kernel calls it:
// on the card it took more instructions and more time than fmul (PERF.md).
__device__ __forceinline__ void mac_row(uint32_t t[9], const uint32_t a[8], uint32_t b) {
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b));
}

// t += q m with q = t[0] n0 mod 2^32, which clears t[0].
__device__ __forceinline__ void reduce_row(uint32_t t[9]) {
  asm("{\n\t.reg .u32 q;\n\t"
      "mul.lo.u32 q, %0, %9;\n\t"
      "mad.lo.cc.u32 %0, q, %10, %0;\n\t"
      "madc.lo.cc.u32 %1, q, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, q, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, q, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, q, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, q, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, q, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, q, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, q, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, q, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, q, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, q, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, q, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, q, %15, %6;\n\t"
      "madc.hi.cc.u32 %7, q, %16, %7;\n\t"
      "madc.hi.u32 %8, q, %17, %8;\n\t"
      "}"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]),
        "+r"(t[7]), "+r"(t[8])
      : "r"(Fq::n0), "r"(0xd87cfd47u), "r"(0x3c208c16u), "r"(0x6871ca8du), "r"(0x97816a91u),
        "r"(0x8181585du), "r"(0xb85045b6u), "r"(0xe131a029u), "r"(0x30644e72u));
}

template <bool LAZY>
__device__ __forceinline__ void fmul_cc(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mac_row(t, a, b[i]);
    reduce_row(t);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
    t[8] = 0;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = t[j];
  if (!LAZY) cond_sub<Fq, false>(r);
}

template <bool CC>
__global__ void one_product(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                            uint32_t* __restrict__ r) {
  uint32_t x[8], y[8];
  load8(x, a + 8 * threadIdx.x);
  load8(y, b + 8 * threadIdx.x);
  if constexpr (CC) {
    fmul_cc<true>(x, x, y);
  } else {
    fmul<Fq, true>(x, x, y);
  }
  store8(r + 8 * threadIdx.x, x);
}
template __global__ void one_product<false>(const uint32_t*, const uint32_t*, uint32_t*);
template __global__ void one_product<true>(const uint32_t*, const uint32_t*, uint32_t*);

// out (n, 4, 8): fmul and fmul_cc of each pair, lazy, then both reduced
__global__ void compare_products(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], r[8];
  load8(x, a + 8 * i);
  load8(y, b + 8 * i);
  fmul<Fq, true>(r, x, y);
  store8(out + 8 * (4 * i), r);
  fmul_cc<true>(r, x, y);
  store8(out + 8 * (4 * i + 1), r);
  fmul<Fq, false>(r, x, y);
  store8(out + 8 * (4 * i + 2), r);
  fmul_cc<false>(r, x, y);
  store8(out + 8 * (4 * i + 3), r);
}

// one thread: x = x * y, n times
template <bool CC>
__global__ void product_chain(uint32_t* io, int n) {
  uint32_t x[8], y[8];
  load8(x, io);
  load8(y, io + 8);
  for (int i = 0; i < n; ++i) {
    if constexpr (CC) {
      fmul_cc<true>(x, x, y);
    } else {
      fmul<Fq, true>(x, x, y);
    }
  }
  store8(io, x);
}

extern "C" int probe_compare(const void* a, const void* b, void* out, int n, void* stream) {
  compare_products<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int probe_chain(void* io, int n, int cc, void* stream) {
  if (cc) {
    product_chain<true><<<1, 1, 0, (cudaStream_t)stream>>>((uint32_t*)io, n);
  } else {
    product_chain<false><<<1, 1, 0, (cudaStream_t)stream>>>((uint32_t*)io, n);
  }
  return (int)cudaGetLastError();
}
