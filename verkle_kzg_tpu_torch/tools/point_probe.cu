// Variants of K2, K11, K12, G1SMUL and G1BFLY, built and timed by
// tools/point_regimes.py and chip_smoke.py beside the path's kernels
// (csrc/curve.cu, csrc/g1_chain.cu); no path runs them.
//
// - one point a thread with a floor of MINB blocks of 128 threads an SM in
//   __launch_bounds__ (so at most 65,536 / (128 MINB) registers a thread),
//   in the reduced domain (K2's and K11's body; K12's before its lazy
//   regimes, a (0, 0) sentinel lane keeping p) or the lazy one (point_add
//   / point_double / point_mixed_add<true>, then one reduction);
// - a group of G threads a point on the warp point operations in the lazy
//   domain, reduced once at the end (K2 and K11; K12's few-point regime is
//   this on the path);
// - G1SMUL and G1BFLY's one-thread design, the one before the path's
//   groups (a lane a thread, 64 threads a block, K11's and K2's reduced
//   device functions in the scan's order), kept to time against them;
// - G1SMUL and G1BFLY on a group of 8 threads a lane (csrc/g1_group.cuh's
//   kernels, which the path runs with 4 and 32), timed beside them.
//
// Every intermediate of the lazy domain lies in [0, 2m) and is congruent
// to the reduced domain's, so one final reduction gives the reduced
// domain's canonical words: the variants differ in time, not in words.
#include <cuda_runtime.h>

#include "g1_group.cuh"
#include "warp_point.cuh"

namespace vkzg {
namespace {

// The operation: 0 doubles p, 1 adds projective q, 2 adds affine q.
template <int OP, bool LAZY, int MINB>
__global__ void __launch_bounds__(128, MINB) probe_thread_kernel(const uint32_t* __restrict__ p,
                                                                 const uint32_t* __restrict__ q,
                                                                 uint32_t* __restrict__ out,
                                                                 int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point a;
  load_point(a, p + 24 * i);
  if constexpr (OP == 2) {
    uint32_t ax[8], ay[8];
    load8(ax, q + 16 * i);
    load8(ay, q + 16 * i + 8);
    if (is_zero(ax) && is_zero(ay)) {
      store_point(out + 24 * i, a);
      return;
    }
    point_mixed_add<LAZY>(a, ax, ay);
  } else if constexpr (OP == 1) {
    Point b;
    load_point(b, q + 24 * i);
    point_add<LAZY>(a, a, b);
  } else {
    point_double<LAZY>(a);
  }
  if (LAZY) reduce_point(a);
  store_point(out + 24 * i, a);
}

template <bool ADD, int G>
__global__ void __launch_bounds__(128) probe_lazy_group_kernel(const uint32_t* __restrict__ p,
                                                               const uint32_t* __restrict__ q,
                                                               uint32_t* __restrict__ out,
                                                               int64_t n) {
  constexpr int PER_BLOCK = 128 / G;
  __shared__ WarpScratch scratch[PER_BLOCK];
  const int slot = threadIdx.x / G, t = threadIdx.x % G;
  const int64_t first = (int64_t)blockIdx.x * PER_BLOCK;
  if (first + (threadIdx.x / 32) * (32 / G) >= n) return;
  const int64_t g = first + slot;
  const int64_t i = g < n ? g : n - 1;
  WarpScratch& s = scratch[slot];
  for (int j = t; j < 24; j += G) s.acc[j] = p[24 * i + j];
  if constexpr (ADD) {
    for (int j = t; j < 24; j += G) s.q[j] = q[24 * i + j];
    __syncwarp();
    warp_add<true, G>(s, t);
  } else {
    __syncwarp();
    warp_double<true>(s, t);
  }
  if (g < n && t < 3) {
    uint32_t a[8];
    load8(a, s.acc + 8 * t);
    cond_sub<Fq, false>(a);
    store8(out + 24 * g + 8 * t, a);
  }
}

// acc = k p on one thread, MSB-first double-and-add in the reduced domain
// with the warp-wide skips of g1_chain.cu (above the warp's top bit every
// accumulator is the identity; an add no lane takes is jumped over by the
// branch). Every lane of the warp must call it.
__device__ __forceinline__ void thread_scalar_mul(Point& acc, const Point& p, const uint32_t k[8]) {
  set_infinity(acc);
  const int top = warp_top_bit(k);
  if (top < 0) return;
  bool doubling = false;
  for (int w = top >> 5; w >= 0; --w) {
    const uint32_t word = pick_word(k, w);
    for (int b = (w == top >> 5) ? (top & 31) : 31; b >= 0; --b) {
      if (doubling) point_double<false>(acc);
      doubling = true;
      if ((word >> b) & 1u) point_add<false>(acc, acc, p);
    }
  }
}

__global__ void __launch_bounds__(128) probe_g1_scalar_mul_thread_kernel(const uint32_t* __restrict__ p,
                                                                         const uint32_t* __restrict__ k,
                                                                         uint32_t* __restrict__ out,
                                                                         int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  Point a, acc;
  uint32_t s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (live) {
    load_point(a, p + 24 * i);
    load8(s, k + 8 * i);
  } else {
    set_infinity(a);
  }
  thread_scalar_mul(acc, a, s);
  if (live) store_point(out + 24 * i, acc);
}

// A butterfly a thread, blk-major within j as g1_chain.cu's groups are.
__global__ void __launch_bounds__(128) probe_g1_butterfly_thread_kernel(const uint32_t* __restrict__ x,
                                                                        const uint32_t* __restrict__ tw,
                                                                        uint32_t* __restrict__ out,
                                                                        int64_t n, int stage) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t half = (int64_t)1 << stage;
  const int64_t nblk = n >> (stage + 1);
  const bool live = t < (n >> 1);
  const int64_t j = live ? t / nblk : 0;
  const int64_t lo = live ? (t % nblk) * 2 * half + j : 0;
  Point v, prod;
  uint32_t s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (live) {
    load_point(v, x + 24 * (lo + half));
    load8(s, tw + 8 * j);
  } else {
    set_infinity(v);
  }
  thread_scalar_mul(prod, v, s);
  if (!live) return;
  Point u, r;
  load_point(u, x + 24 * lo);
  point_add<false>(r, u, prod);
  store_point(out + 24 * lo, r);
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  fsub<Fq, false>(prod.y, zero, prod.y);
  point_add<false>(r, u, prod);
  store_point(out + 24 * (lo + half), r);
}

template <int OP, bool LAZY, int MINB>
int thread_launch(const uint32_t* p, const uint32_t* q, uint32_t* o, int64_t n, cudaStream_t st) {
  probe_thread_kernel<OP, LAZY, MINB><<<(unsigned)((n + 127) / 128), 128, 0, st>>>(p, q, o, n);
  return (int)cudaGetLastError();
}

template <int OP, bool LAZY>
int thread_minb(int minb, const uint32_t* p, const uint32_t* q, uint32_t* o, int64_t n,
                cudaStream_t st) {
  switch (minb) {
    case 1: return thread_launch<OP, LAZY, 1>(p, q, o, n, st);
    case 4: return thread_launch<OP, LAZY, 4>(p, q, o, n, st);
    case 6: return thread_launch<OP, LAZY, 6>(p, q, o, n, st);
    case 8: return thread_launch<OP, LAZY, 8>(p, q, o, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int OP>
int probe(int lazy, int group, int minb, const uint32_t* p, const uint32_t* q, uint32_t* o,
          int64_t n, cudaStream_t st) {
  if (group == 1) {
    return lazy ? thread_minb<OP, true>(minb, p, q, o, n, st)
                : thread_minb<OP, false>(minb, p, q, o, n, st);
  }
  if constexpr (OP == 2) {
    return (int)cudaErrorInvalidValue;  // K12's lazy groups are the path's (vkzg_point_mixed_add)
  } else {
    if (!lazy) return (int)cudaErrorInvalidValue;
    if (group == 8) {
      probe_lazy_group_kernel<OP == 1, 8><<<(unsigned)((n + 15) / 16), 128, 0, st>>>(p, q, o, n);
    } else if (group == 32) {
      probe_lazy_group_kernel<OP == 1, 32><<<(unsigned)((n + 3) / 4), 128, 0, st>>>(p, q, o, n);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
}

}  // namespace
}  // namespace vkzg

// op: 0 for K11's doubling (q unused), 1 for K2's add, 2 for K12's mixed
// add (q affine, (n, 2, 8)); lazy: 0 or 1; group: 1 (one point a thread,
// minb in {1, 4, 6, 8}) or, lazy only and not K12, 8 or 32 (minb unused).
extern "C" int point_probe(int op, int lazy, int group, int minb, const void* p, const void* q,
                           void* out, int64_t n, void* stream) {
  const uint32_t* a = (const uint32_t*)p;
  const uint32_t* b = (const uint32_t*)q;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case 0: return vkzg::probe<0>(lazy, group, minb, a, b, o, n, st);
    case 1: return vkzg::probe<1>(lazy, group, minb, a, b, o, n, st);
    case 2: return vkzg::probe<2>(lazy, group, minb, a, b, o, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The one-thread G1SMUL (op 0: x the points, tw the scalars, stage unused)
// or G1BFLY (op 1) over n lanes or n points, 64 threads a block.
extern "C" int g1_thread_probe(int op, const void* x, const void* tw, void* out, int64_t n, int stage,
                               void* stream) {
  const uint32_t* a = (const uint32_t*)x;
  const uint32_t* w = (const uint32_t*)tw;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (op == 0) {
    vkzg::probe_g1_scalar_mul_thread_kernel<<<(unsigned)((n + 63) / 64), 64, 0, st>>>(a, w, o, n);
  } else if (op == 1) {
    vkzg::probe_g1_butterfly_thread_kernel<<<(unsigned)((n / 2 + 63) / 64), 64, 0, st>>>(a, w, o, n, stage);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// G1SMUL (op 0) or G1BFLY (op 1) as g1_thread_probe takes them, on a group
// of 8 threads a lane.
extern "C" int g1_group8_probe(int op, const void* x, const void* tw, void* out, int64_t n, int stage,
                               void* stream) {
  const uint32_t* a = (const uint32_t*)x;
  const uint32_t* w = (const uint32_t*)tw;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (op == 0) return vkzg::launch_scalar_mul<8>(a, w, o, n, st);
  if (op == 1) return vkzg::launch_butterfly<8>(a, w, o, n, stage, st);
  return (int)cudaErrorInvalidValue;
}
