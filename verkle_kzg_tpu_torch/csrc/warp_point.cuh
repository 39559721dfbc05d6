// Point operations run by a group of threads: each RCB16 step's
// independent Montgomery products on separate threads of the group, the
// operands in the group's WarpScratch in shared memory, __syncwarp()
// between the levels, and every thread that takes a product forming the
// sums between the levels itself. warp_double and warp_add run in either
// domain: the same field operations in the same order as
// bn254_curve.cuh's point_double / point_add give the same words, lazy
// (LAZY = true; warp_mixed_add is lazy only) or reduced (LAZY = false).
//
// Shared by the MSM tail's Horner (msm_tail.cuh: one warp a lane, the warp
// the group, lazy), K5 (scalar_mul.cu: one warp a lane below the regime
// switch, groups of 4 threads above it, lazy), K2 / K11 (curve.cu: a
// group of 4, 8 or 32 threads a point, reduced) and G1SMUL / G1BFLY
// (g1_chain.cu: a group of threads a lane, lazy). A group has at least 4
// threads; warp_add runs a level's six products in two passes on 4 of
// them. Groups sharing a warp run the same steps together, so every thread
// of the warp calls each operation.
#pragma once
#include <cuda_runtime.h>

#include "bn254_curve.cuh"

namespace vkzg {
namespace {

// A group's scratch: the accumulator (X, Y, Z), the addend (projective, or
// affine x, y in its first 16 words) and the two levels of products.
struct __align__(16) WarpScratch {
  uint32_t acc[24], q[24], p1[48], p2[48];
};

// Lazy Fq sums over PTX carry chains, one instruction a word:
// add_lazy is fadd<Fq, true> (a + b, less 2m when that reaches 2m),
// sub_lazy fsub<Fq, true> (a - b, plus 2m when it borrows), mul9_lazy
// fmul9<Fq, true>; the same integers, so the same words. Both read 2m from
// Fq::m2, as fadd and fsub do.
__device__ __forceinline__ void add_lazy(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t s[8], d[8], k[8], borrow;
#pragma unroll
  for (int j = 0; j < 8; ++j) k[j] = Fq::m2(j);
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]), "=r"(s[5]), "=r"(s[6]),
        "=r"(s[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "=r"(borrow)
      : "r"(s[0]), "r"(s[1]), "r"(s[2]), "r"(s[3]), "r"(s[4]), "r"(s[5]), "r"(s[6]), "r"(s[7]),
        "r"(k[0]), "r"(k[1]), "r"(k[2]), "r"(k[3]), "r"(k[4]), "r"(k[5]), "r"(k[6]), "r"(k[7]));
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = borrow ? s[j] : d[j];
}

__device__ __forceinline__ void sub_lazy(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t d[8], k[8], borrow;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]), "=r"(d[6]),
        "=r"(d[7]), "=r"(borrow)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]), "r"(a[7]),
        "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
#pragma unroll
  for (int j = 0; j < 8; ++j) k[j] = Fq::m2(j) & borrow;
  asm("add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]), "=r"(r[5]), "=r"(r[6]),
        "=r"(r[7])
      : "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]), "r"(d[4]), "r"(d[5]), "r"(d[6]), "r"(d[7]),
        "r"(k[0]), "r"(k[1]), "r"(k[2]), "r"(k[3]), "r"(k[4]), "r"(k[5]), "r"(k[6]), "r"(k[7]));
}

__device__ __forceinline__ void mul9_lazy(uint32_t r[8], const uint32_t x[8]) {
  uint32_t t[8];
  add_lazy(t, x, x);
  add_lazy(t, t, t);
  add_lazy(t, t, t);
  add_lazy(r, t, x);
}

// The sums of a domain: LAZY = true the carry-chain forms above, LAZY =
// false bn254_field.cuh's fadd / fsub / fmul9<Fq, false>, whose results are
// canonical whatever the order, so they are point_add<false>'s and
// point_double<false>'s words.
template <bool LAZY>
__device__ __forceinline__ void dom_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  if constexpr (LAZY) {
    add_lazy(r, a, b);
  } else {
    fadd<Fq, false>(r, a, b);
  }
}

template <bool LAZY>
__device__ __forceinline__ void dom_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  if constexpr (LAZY) {
    sub_lazy(r, a, b);
  } else {
    fsub<Fq, false>(r, a, b);
  }
}

template <bool LAZY>
__device__ __forceinline__ void dom_mul9(uint32_t r[8], const uint32_t x[8]) {
  if constexpr (LAZY) {
    mul9_lazy(r, x);
  } else {
    fmul9<Fq, false>(r, x);
  }
}

// acc = 2 acc (RCB16 algorithm 9) in the lazy (LAZY = true) or the reduced
// domain, products on threads 0-3 of the group.
template <bool LAZY>
__device__ __forceinline__ void warp_double(WarpScratch& s, int t) {
  const uint32_t *X = s.acc, *Y = s.acc + 8, *Z = s.acc + 16;
  if (t < 4) {  // Y Y, Y Z, Z Z, X Y
    uint32_t a[8], b[8];
    load8(a, t == 3 ? X : (t == 2 ? Z : Y));
    load8(b, t == 0 || t == 3 ? Y : Z);
    fmul<Fq, LAZY>(a, a, b);
    store8(s.p1 + 8 * t, a);
  }
  __syncwarp();
  if (t < 4) {
    uint32_t t0[8], t2[8], z3[8], y3[8], u[8], a[8], b[8];
    load8(t0, s.p1);
    load8(t2, s.p1 + 16);
    dom_add<LAZY>(z3, t0, t0);
    dom_add<LAZY>(z3, z3, z3);
    dom_add<LAZY>(z3, z3, z3);  // Z3 = 8 t0
    dom_mul9<LAZY>(t2, t2);     // t2 = 9 t2
    dom_add<LAZY>(y3, t0, t2);  // Y3 = t0 + t2
    dom_add<LAZY>(u, t2, t2);
    dom_add<LAZY>(u, u, t2);
    dom_sub<LAZY>(t0, t0, u);   // t0 = t0 - 3 t2
    uint32_t t1[8], txy[8];
    load8(t1, s.p1 + 8);
    load8(txy, s.p1 + 24);
    // t 0: t2 Z3, t 1: t1 Z3, t 2: t0 Y3, t 3: t0 (X Y)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a[j] = t == 0 ? t2[j] : (t == 1 ? t1[j] : t0[j]);
      b[j] = t < 2 ? z3[j] : (t == 2 ? y3[j] : txy[j]);
    }
    fmul<Fq, LAZY>(a, a, b);
    store8(s.p2 + 8 * t, a);
  }
  __syncwarp();
  if (t < 3) {  // X = 2 (t0 X Y), Y = t2 Z3 + t0 Y3, Z = t1 Z3 (+ 0)
    uint32_t a[8], b[8];
    load8(a, s.p2 + 8 * (t == 0 ? 3 : (t == 1 ? 0 : 1)));
    if (t == 2) {
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = 0;
    } else {
      load8(b, s.p2 + 8 * (t == 0 ? 3 : 2));
    }
    dom_add<LAZY>(a, a, b);
    store8(s.acc + 8 * t, a);
  }
  __syncwarp();
}

// acc = acc + q (RCB16 algorithm 7) in the lazy or the reduced domain: each
// level's six products on the group's G threads, one pass when G >= 6 (the
// products on threads 0-5), two when G = 4. keep = false leaves acc as it
// was (warp_mixed_add's flag): a group that does not take this add rides
// along with the others of its warp.
template <bool LAZY, int G>
__device__ __forceinline__ void warp_add(WarpScratch& s, int t, bool keep = true) {
  static_assert(G >= 4, "a group has at least 4 threads");
  // X1 X2, Y1 Y2, Z1 Z2, (X1 + Y1)(X2 + Y2), (Y1 + Z1)(Y2 + Z2), (X1 + Z1)(X2 + Z2)
  for (int p = t; p < 6; p += G) {
    const int i = p < 3 ? p : (p == 4 ? 1 : 0);
    const int k = p == 3 ? 1 : 2;
    uint32_t a[8], b[8];
    load8(a, s.acc + 8 * i);
    load8(b, s.q + 8 * i);
    if (p >= 3) {
      uint32_t u[8];
      load8(u, s.acc + 8 * k);
      dom_add<LAZY>(a, a, u);
      load8(u, s.q + 8 * k);
      dom_add<LAZY>(b, b, u);
    }
    fmul<Fq, LAZY>(a, a, b);
    store8(s.p1 + 8 * p, a);
    if (G >= 6) break;
  }
  __syncwarp();
  if (t < 6) {
    uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], y3[8], z3[8], u[8];
    load8(t0, s.p1);
    load8(t1, s.p1 + 8);
    load8(t2, s.p1 + 16);
    load8(t3, s.p1 + 24);
    load8(t4, s.p1 + 32);
    load8(y3, s.p1 + 40);
    dom_add<LAZY>(u, t0, t1);
    dom_sub<LAZY>(t3, t3, u);  // t3 = t3 - (t0 + t1)
    dom_add<LAZY>(u, t1, t2);
    dom_sub<LAZY>(t4, t4, u);  // t4 = t4 - (t1 + t2)
    dom_add<LAZY>(u, t0, t2);
    dom_sub<LAZY>(y3, y3, u);
    dom_mul9<LAZY>(y3, y3);    // Y3 = 9 (X3 - (t0 + t2))
    dom_add<LAZY>(u, t0, t0);
    dom_add<LAZY>(t0, u, t0);  // t0 = 3 t0
    dom_mul9<LAZY>(t2, t2);
    dom_add<LAZY>(z3, t1, t2);  // Z3 = t1 + 9 t2
    dom_sub<LAZY>(t1, t1, t2);  // t1 = t1 - 9 t2
    // 0: t4 Y3, 1: t3 t1, 2: Y3 t0, 3: t1 Z3, 4: t0 t3, 5: Z3 t4
    for (int p = t; p < 6; p += G) {
      uint32_t a[8], b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a[j] = p == 0 ? t4[j] : p == 1 ? t3[j] : p == 2 ? y3[j] : p == 3 ? t1[j]
             : p == 4 ? t0[j] : z3[j];
        b[j] = p == 0 ? y3[j] : p == 1 ? t1[j] : p == 2 ? t0[j] : p == 3 ? z3[j]
             : p == 4 ? t3[j] : t4[j];
      }
      fmul<Fq, LAZY>(a, a, b);
      store8(s.p2 + 8 * p, a);
      if (G >= 6) break;
    }
  }
  __syncwarp();
  if (t < 3 && keep) {  // X = t3 t1 - t4 Y3, Y = t1 Z3 + Y3 t0, Z = Z3 t4 + t0 t3
    uint32_t a[8], b[8];
    load8(a, s.p2 + 8 * (2 * t + 1));
    load8(b, s.p2 + 8 * (2 * t));
    if (t == 0) {
      dom_sub<LAZY>(a, a, b);
    } else {
      dom_add<LAZY>(a, a, b);
    }
    store8(s.acc + 8 * t, a);
  }
  __syncwarp();
}

// acc = acc + (x, y), the affine addend in q[0..15] fully reduced and not
// the (0, 0) sentinel (RCB16 algorithm 8, lazy): level 1's five products
// and level 2's six on the group's threads, G threads a group (two passes
// a level when G = 4). keep = false leaves acc as it was: a group whose
// lane does not take this bit rides along with the others of its warp.
template <int G>
__device__ __forceinline__ void warp_mixed_add(WarpScratch& s, int t, bool keep) {
  // X1 x, Y1 y, (X1 + Y1)(x + y), Z1 y, Z1 x
  for (int p = t; p < 5; p += G) {
    uint32_t a[8], b[8];
    load8(a, s.acc + 8 * (p == 1 ? 1 : (p >= 3 ? 2 : 0)));
    load8(b, s.q + 8 * (p == 1 || p == 3 ? 1 : 0));
    if (p == 2) {
      uint32_t u[8];
      load8(u, s.acc + 8);
      add_lazy(a, a, u);
      load8(u, s.q + 8);
      add_lazy(b, b, u);
    }
    fmul<Fq, true>(a, a, b);
    store8(s.p1 + 8 * p, a);
  }
  __syncwarp();
  if (t < 6) {
    uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], y3[8], z3[8], u[8];
    load8(t0, s.p1);
    load8(t1, s.p1 + 8);
    load8(t3, s.p1 + 16);
    load8(t4, s.p1 + 24);
    load8(y3, s.p1 + 32);
    add_lazy(u, t0, t1);
    sub_lazy(t3, t3, u);   // t3 = t3 - (t0 + t1)
    load8(u, s.acc + 8);
    add_lazy(t4, t4, u);   // t4 = y Z1 + Y1
    load8(u, s.acc);
    add_lazy(y3, y3, u);   // Y3 = x Z1 + X1
    add_lazy(u, t0, t0);
    add_lazy(t0, u, t0);   // t0 = 3 t0
    load8(u, s.acc + 16);
    mul9_lazy(t2, u);      // t2 = 9 Z1
    add_lazy(z3, t1, t2);  // Z3 = t1 + t2
    sub_lazy(t1, t1, t2);  // t1 = t1 - t2
    mul9_lazy(y3, y3);     // Y3 = 9 Y3
    // 0: t4 Y3, 1: t3 t1, 2: Y3 t0, 3: t1 Z3, 4: t0 t3, 5: Z3 t4 (warp_add's)
    for (int p = t; p < 6; p += G) {
      uint32_t a[8], b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a[j] = p == 0 ? t4[j] : p == 1 ? t3[j] : p == 2 ? y3[j] : p == 3 ? t1[j]
             : p == 4 ? t0[j] : z3[j];
        b[j] = p == 0 ? y3[j] : p == 1 ? t1[j] : p == 2 ? t0[j] : p == 3 ? z3[j]
             : p == 4 ? t3[j] : t4[j];
      }
      fmul<Fq, true>(a, a, b);
      store8(s.p2 + 8 * p, a);
    }
  }
  __syncwarp();
  if (t < 3 && keep) {  // X = t3 t1 - t4 Y3, Y = t1 Z3 + Y3 t0, Z = Z3 t4 + t0 t3
    uint32_t a[8], b[8];
    load8(a, s.p2 + 8 * (2 * t + 1));
    load8(b, s.p2 + 8 * (2 * t));
    if (t == 0) {
      sub_lazy(a, a, b);
    } else {
      add_lazy(a, a, b);
    }
    store8(s.acc + 8 * t, a);
  }
  __syncwarp();
}

}  // namespace
}  // namespace vkzg
