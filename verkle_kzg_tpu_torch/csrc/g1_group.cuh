// G1SMUL's and G1BFLY's group kernels (a group of G threads a lane on the
// lazy warp point operations of warp_point.cuh, each coordinate reduced
// once at the end) and their launches, as templates on G. g1_chain.cu
// instantiates the two sizes the path's regimes run (ops/cuda_g1_chain.py);
// tools/point_probe.cu instantiates a group of 8 to time beside them.
#pragma once
#include <cuda_runtime.h>

#include "warp_point.cuh"

// Inside vkzg, as warp_point.cuh's unnamed namespace is (scalar_mul.cu).
namespace vkzg {
namespace {

// s.acc = k q for the group's scalar k and its point in s.q, in the order
// of the XLA scan (verkle_kzg_tpu/ops/curve.py::scalar_mul): MSB first, a
// doubling a round, then an add where the bit is set, on warp_double<true>
// and warp_add<true, G>. s.acc must hold the identity (0 : R : 0). What is
// skipped leaves the words as they are: above the warp's top bit every
// group's accumulator is the identity, whose doubling gives its own words,
// and the doubling at the top bit is of identities only. The add runs on a
// round where any group of the warp has the bit set (a warp-uniform test
// on the OR of the warp's scalars, taken once before the loop), and a
// group whose own bit is 0 keeps its accumulator, as the scan's select
// does. Every thread of the warp must call this with its group's scalar.
template <int G>
__device__ __forceinline__ void group_scalar_mul(WarpScratch& s, int t, const uint32_t k[8]) {
  uint32_t any[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) any[j] = __reduce_or_sync(0xFFFFFFFFu, k[j]);
  const int top = warp_top_bit(k);
  bool doubling = false;
  for (int w = top >> 5; top >= 0 && w >= 0; --w) {
    const uint32_t word = pick_word(k, w), bits = pick_word(any, w);
    for (int b = (w == top >> 5) ? (top & 31) : 31; b >= 0; --b) {
      if (doubling) warp_double<true>(s, t);
      doubling = true;
      if ((bits >> b) & 1u) warp_add<true, G>(s, t, (word >> b) & 1u);
    }
  }
}

// Threads 0-2 of a group: coordinate t of s.acc reduced once, in c.
__device__ __forceinline__ void reduced_coord(uint32_t c[8], const WarpScratch& s, int t) {
  load8(c, s.acc + 8 * t);
  cond_sub<Fq, false>(c);
}

__device__ __forceinline__ void set_identity(WarpScratch& s, int t) {
  if (t == 0) {
    Point id;
    set_infinity(id);
    store_point(s.acc, id);
  }
}

// p (n, 3, 8) reduced projective, k (n, 8) standard-form scalar words ->
// out (n, 3, 8) = k p, group g of the launch on lane g. A warp whose first
// lane is past n returns whole; a group of a live warp past n takes the
// scalar 0 and stores nothing.
template <int G>
__global__ void __launch_bounds__(128) g1_scalar_mul_kernel(const uint32_t* __restrict__ p,
                                                            const uint32_t* __restrict__ k,
                                                            uint32_t* __restrict__ out, int64_t n) {
  constexpr int PER_BLOCK = 128 / G;
  __shared__ WarpScratch scratch[PER_BLOCK];
  const int slot = threadIdx.x / G, t = threadIdx.x % G;
  const int64_t first = (int64_t)blockIdx.x * PER_BLOCK;
  if (first + (threadIdx.x / 32) * (32 / G) >= n) return;
  const int64_t g = first + slot;
  const bool live = g < n;
  WarpScratch& s = scratch[slot];
  uint32_t sc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (live) {
    load8(sc, k + 8 * g);
    for (int j = t; j < 24; j += G) s.q[j] = p[24 * g + j];
  }
  set_identity(s, t);
  __syncwarp();
  group_scalar_mul<G>(s, t, sc);
  if (live && t < 3) {
    uint32_t c[8];
    reduced_coord(c, s, t);
    store8(out + 24 * g + 8 * t, c);
  }
}

// Stage `stage` of a decimation-in-time G1 NTT over n points, x in the
// order the stage reads it: butterfly (blk, j) with half = 2^stage takes
// t = tw[j] x[blk + j + half], then out[blk + j] = x[blk + j] + t and
// out[blk + j + half] = x[blk + j] + (-t), -t negating Y as 0 - y mod m
// (ops/ntt.py::_g1_stage's order; 0 stays 0). A group a butterfly: t by
// group_scalar_mul, reduced once; each sum by warp_add<true, G>, reduced
// once. Groups are j-major, so a warp's groups share one twiddle while
// n / 2^(stage + 1) >= 32 / G, and its skips are then those of one scalar.
template <int G>
__global__ void __launch_bounds__(128) g1_butterfly_kernel(const uint32_t* __restrict__ x,
                                                           const uint32_t* __restrict__ tw,
                                                           uint32_t* __restrict__ out, int64_t n,
                                                           int stage) {
  constexpr int PER_BLOCK = 128 / G;
  __shared__ WarpScratch scratch[PER_BLOCK];
  const int slot = threadIdx.x / G, t = threadIdx.x % G;
  const int64_t pairs = n >> 1, first = (int64_t)blockIdx.x * PER_BLOCK;
  if (first + (threadIdx.x / 32) * (32 / G) >= pairs) return;
  const int64_t g = first + slot, half = (int64_t)1 << stage, nblk = n >> (stage + 1);
  const bool live = g < pairs;
  const int64_t j = live ? g / nblk : 0;
  const int64_t lo = live ? (g % nblk) * 2 * half + j : 0;
  WarpScratch& s = scratch[slot];
  uint32_t sc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (live) {
    load8(sc, tw + 8 * j);
    for (int i = t; i < 24; i += G) s.q[i] = x[24 * (lo + half) + i];
  }
  set_identity(s, t);
  __syncwarp();
  group_scalar_mul<G>(s, t, sc);
  // threads 0-2: q = t reduced (coordinate t; Y kept for -t), acc = u
  uint32_t c[8];
  if (t < 3) {
    reduced_coord(c, s, t);
    store8(s.q + 8 * t, c);
    if (live) {
      uint32_t u[8];
      load8(u, x + 24 * lo + 8 * t);
      store8(s.acc + 8 * t, u);
    }
  }
  __syncwarp();
  warp_add<true, G>(s, t);
  if (t < 3) {
    uint32_t r[8];
    reduced_coord(r, s, t);
    if (live) {
      store8(out + 24 * lo + 8 * t, r);
      load8(r, x + 24 * lo + 8 * t);
      store8(s.acc + 8 * t, r);
    }
    if (t == 1) {
      const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      fsub<Fq, false>(c, zero, c);
      store8(s.q + 8, c);
    }
  }
  __syncwarp();
  warp_add<true, G>(s, t);
  if (live && t < 3) {
    uint32_t r[8];
    reduced_coord(r, s, t);
    store8(out + 24 * (lo + half) + 8 * t, r);
  }
}

unsigned blocks_for(int64_t lanes, int group) {
  const int64_t per_block = 128 / group;
  return (unsigned)((lanes + per_block - 1) / per_block);
}

template <int G>
int launch_scalar_mul(const uint32_t* p, const uint32_t* k, uint32_t* out, int64_t n, cudaStream_t st) {
  g1_scalar_mul_kernel<G><<<blocks_for(n, G), 128, 0, st>>>(p, k, out, n);
  return (int)cudaGetLastError();
}

template <int G>
int launch_butterfly(const uint32_t* x, const uint32_t* tw, uint32_t* out, int64_t n, int stage,
                     cudaStream_t st) {
  g1_butterfly_kernel<G><<<blocks_for(n >> 1, G), 128, 0, st>>>(x, tw, out, n, stage);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vkzg
