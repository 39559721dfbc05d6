// BN254 G1 group law as __device__ functions: the complete projective
// formulas of Renes-Costello-Batina 2016 (algorithms 7, 8 and 9 with a = 0,
// b3 = 9). One branch-free sequence is right for every input, the identity
// (0 : 1 : 0) included.
//
// Replaces the kernel bodies of verkle_kzg_tpu/ops/pallas_curve.py:
// k_point_add, k_point_mixed_add and k_point_double (LAZY = false), their
// _lazy forms (LAZY = true) and k_point_reduce. Each function runs the same
// sequence of field operations as its Pallas twin, so in the same domain
// it yields the same projective representative.
//
// A projective point is 24 words (X, Y, Z); RCB16 keeps about a dozen
// field temporaries alive, so callers pin their block size with
// __launch_bounds__ and the build prints spills (-Xptxas -v).
#pragma once
#include "bn254_field.cuh"

namespace vkzg {

struct Point {
  uint32_t x[8], y[8], z[8];
};

__device__ __forceinline__ void set_infinity(Point& p) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p.x[j] = 0;
    p.y[j] = Fq::one(j);
    p.z[j] = 0;
  }
}

__device__ __forceinline__ void load_point(Point& p, const uint32_t* src) {
  load8(p.x, src);
  load8(p.y, src + 8);
  load8(p.z, src + 16);
}

__device__ __forceinline__ void store_point(uint32_t* dst, const Point& p) {
  store8(dst, p.x);
  store8(dst + 8, p.y);
  store8(dst + 16, p.z);
}

// [0, 2m) coordinates -> [0, m) (k_point_reduce).
__device__ __forceinline__ void reduce_point(Point& p) {
  cond_sub<Fq, false>(p.x);
  cond_sub<Fq, false>(p.y);
  cond_sub<Fq, false>(p.z);
}

// r = p + q, RCB16 algorithm 7. r may alias p or q.
template <bool LAZY>
__device__ __forceinline__ void point_add(Point& r, const Point& p, const Point& q) {
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], X3[8], Y3[8], Z3[8];
  fmul<Fq, LAZY>(t0, p.x, q.x);
  fmul<Fq, LAZY>(t1, p.y, q.y);
  fmul<Fq, LAZY>(t2, p.z, q.z);
  fadd<Fq, LAZY>(t3, p.x, p.y);
  fadd<Fq, LAZY>(t4, q.x, q.y);
  fmul<Fq, LAZY>(t3, t3, t4);
  fadd<Fq, LAZY>(t4, t0, t1);
  fsub<Fq, LAZY>(t3, t3, t4);
  fadd<Fq, LAZY>(t4, p.y, p.z);
  fadd<Fq, LAZY>(X3, q.y, q.z);
  fmul<Fq, LAZY>(t4, t4, X3);
  fadd<Fq, LAZY>(X3, t1, t2);
  fsub<Fq, LAZY>(t4, t4, X3);
  fadd<Fq, LAZY>(X3, p.x, p.z);
  fadd<Fq, LAZY>(Y3, q.x, q.z);
  fmul<Fq, LAZY>(X3, X3, Y3);
  fadd<Fq, LAZY>(Y3, t0, t2);
  fsub<Fq, LAZY>(Y3, X3, Y3);
  fadd<Fq, LAZY>(X3, t0, t0);
  fadd<Fq, LAZY>(t0, X3, t0);
  fmul9<Fq, LAZY>(t2, t2);
  fadd<Fq, LAZY>(Z3, t1, t2);
  fsub<Fq, LAZY>(t1, t1, t2);
  fmul9<Fq, LAZY>(Y3, Y3);
  fmul<Fq, LAZY>(X3, t4, Y3);
  fmul<Fq, LAZY>(t2, t3, t1);
  fsub<Fq, LAZY>(X3, t2, X3);
  fmul<Fq, LAZY>(Y3, Y3, t0);
  fmul<Fq, LAZY>(t1, t1, Z3);
  fadd<Fq, LAZY>(Y3, t1, Y3);
  fmul<Fq, LAZY>(t0, t0, t3);
  fmul<Fq, LAZY>(Z3, Z3, t4);
  fadd<Fq, LAZY>(Z3, Z3, t0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r.x[j] = X3[j];
    r.y[j] = Y3[j];
    r.z[j] = Z3[j];
  }
}

// p += (ax, ay) with the affine point fully reduced, RCB16 algorithm 8.
// The caller skips the (0, 0) infinity sentinel (the Pallas kernels select
// p there, which leaves p as it was).
template <bool LAZY>
__device__ __forceinline__ void point_mixed_add(Point& p, const uint32_t ax[8],
                                                const uint32_t ay[8]) {
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], X3[8], Y3[8], Z3[8];
  fmul<Fq, LAZY>(t0, p.x, ax);
  fmul<Fq, LAZY>(t1, p.y, ay);
  fadd<Fq, LAZY>(t3, ax, ay);
  fadd<Fq, LAZY>(t4, p.x, p.y);
  fmul<Fq, LAZY>(t3, t3, t4);
  fadd<Fq, LAZY>(t4, t0, t1);
  fsub<Fq, LAZY>(t3, t3, t4);
  fmul<Fq, LAZY>(t4, ay, p.z);
  fadd<Fq, LAZY>(t4, t4, p.y);
  fmul<Fq, LAZY>(Y3, ax, p.z);
  fadd<Fq, LAZY>(Y3, Y3, p.x);
  fadd<Fq, LAZY>(X3, t0, t0);
  fadd<Fq, LAZY>(t0, X3, t0);
  fmul9<Fq, LAZY>(t2, p.z);
  fadd<Fq, LAZY>(Z3, t1, t2);
  fsub<Fq, LAZY>(t1, t1, t2);
  fmul9<Fq, LAZY>(Y3, Y3);
  fmul<Fq, LAZY>(X3, t4, Y3);
  fmul<Fq, LAZY>(t2, t3, t1);
  fsub<Fq, LAZY>(X3, t2, X3);
  fmul<Fq, LAZY>(Y3, Y3, t0);
  fmul<Fq, LAZY>(t1, t1, Z3);
  fadd<Fq, LAZY>(Y3, t1, Y3);
  fmul<Fq, LAZY>(t0, t0, t3);
  fmul<Fq, LAZY>(Z3, Z3, t4);
  fadd<Fq, LAZY>(Z3, Z3, t0);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p.x[j] = X3[j];
    p.y[j] = Y3[j];
    p.z[j] = Z3[j];
  }
}

// p = 2p, RCB16 algorithm 9.
template <bool LAZY>
__device__ __forceinline__ void point_double(Point& p) {
  uint32_t t0[8], t1[8], t2[8], X3[8], Y3[8], Z3[8];
  fmul<Fq, LAZY>(t0, p.y, p.y);
  fadd<Fq, LAZY>(Z3, t0, t0);
  fadd<Fq, LAZY>(Z3, Z3, Z3);
  fadd<Fq, LAZY>(Z3, Z3, Z3);
  fmul<Fq, LAZY>(t1, p.y, p.z);
  fmul<Fq, LAZY>(t2, p.z, p.z);
  fmul9<Fq, LAZY>(t2, t2);
  fmul<Fq, LAZY>(X3, t2, Z3);
  fadd<Fq, LAZY>(Y3, t0, t2);
  fmul<Fq, LAZY>(Z3, t1, Z3);
  fadd<Fq, LAZY>(t1, t2, t2);
  fadd<Fq, LAZY>(t2, t1, t2);
  fsub<Fq, LAZY>(t0, t0, t2);
  fmul<Fq, LAZY>(Y3, t0, Y3);
  fadd<Fq, LAZY>(Y3, X3, Y3);
  fmul<Fq, LAZY>(t1, p.x, p.y);
  fmul<Fq, LAZY>(X3, t0, t1);
  fadd<Fq, LAZY>(X3, X3, X3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p.x[j] = X3[j];
    p.y[j] = Y3[j];
    p.z[j] = Z3[j];
  }
}

}  // namespace vkzg
