// G1SMUL and G1BFLY: the G1 scalar multiplication of the NTT butterflies
// and of FK's pointwise product as ONE launch a call (G1SMUL) and one
// launch a butterfly stage (G1BFLY), in place of 256 rounds of K11, K2 and
// a select. See ops/cuda_g1_chain.py for what they replace and why they
// are shaped so.
#include <cuda_runtime.h>

#include "bn254_curve.cuh"

using namespace vkzg;

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

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
  return __reduce_max_sync(FULL, top);
}

// acc = k p by MSB-first double-and-add in the reduced domain, with K11's
// point_double and K2's point_add in the order of the XLA scan
// (verkle_kzg_tpu/ops/curve.py::scalar_mul), so the words are the scan's.
// What is skipped leaves the words as they are: above the warp's top bit
// every lane's accumulator is the identity (0 : R : 0), which a doubling
// maps to its own words and whose add no lane keeps; the doubling at the
// top bit is the identity's too; and an add that no lane of the warp keeps
// is not computed: a lane whose bit is 0 skips its add, as the scan's
// select discards it, and a warp jumps over a branch that none of its
// lanes takes. (The same skip written as an __any_sync vote around the
// branch crashed cicc, CUDA 12.8.) Every lane of the warp must call this
// (the top bit is a warp reduction).
__device__ __forceinline__ void scalar_mul_warp(Point& acc, const Point& p, const uint32_t k[8]) {
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

// p (n, 3, 8) reduced projective, k (n, 8) standard-form scalar words ->
// out (n, 3, 8) = k p. Lanes past n take the scalar 0 and store nothing.
__global__ void __launch_bounds__(128) g1_scalar_mul_kernel(const uint32_t* __restrict__ p,
                                                            const uint32_t* __restrict__ k,
                                                            uint32_t* __restrict__ out,
                                                            int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  Point a, acc;
  uint32_t s[8];
  if (live) {
    load_point(a, p + 24 * i);
    load8(s, k + 8 * i);
  } else {
    set_infinity(a);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0;
  }
  scalar_mul_warp(acc, a, s);
  if (live) store_point(out + 24 * i, acc);
}

// Stage `stage` of a decimation-in-time G1 NTT over n points, x in the
// order the stage reads it: butterfly (blk, j) with half = 2^stage takes
// t = tw[j] x[blk + j + half], then out[blk + j] = x[blk + j] + t and
// out[blk + j + half] = x[blk + j] + (-t), -t negating Y as 0 - y mod m
// (ops/ntt.py::_g1_stage's order; 0 stays 0). Threads are j-major, so a
// warp shares one twiddle while n / 2^(stage + 1) >= 32.
__global__ void __launch_bounds__(128) g1_butterfly_kernel(const uint32_t* __restrict__ x,
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
  uint32_t s[8];
  if (live) {
    load_point(v, x + 24 * (lo + half));
    load8(s, tw + 8 * j);
  } else {
    set_infinity(v);
#pragma unroll
    for (int w = 0; w < 8; ++w) s[w] = 0;
  }
  scalar_mul_warp(prod, v, s);
  if (!live) return;
  Point u, r;
  load_point(u, x + 24 * lo);
  point_add<false>(r, u, prod);
  store_point(out + 24 * lo, r);
  uint32_t zero[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) zero[w] = 0;
  fsub<Fq, false>(prod.y, zero, prod.y);
  point_add<false>(r, u, prod);
  store_point(out + 24 * (lo + half), r);
}

bool valid_block(int threads) { return threads == 32 || threads == 64 || threads == 128; }

}  // namespace

extern "C" int vkzg_g1_scalar_mul(const void* p, const void* k, void* out, int64_t n, int threads,
                                  void* stream) {
  if (!valid_block(threads)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  g1_scalar_mul_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)k, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int vkzg_g1_butterfly(const void* x, const void* tw, void* out, int64_t n, int stage,
                                 int threads, void* stream) {
  if (!valid_block(threads)) return (int)cudaErrorInvalidValue;
  const int64_t pairs = n >> 1;
  const unsigned blocks = (unsigned)((pairs + threads - 1) / threads);
  g1_butterfly_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)tw, (uint32_t*)out, n, stage);
  return (int)cudaGetLastError();
}
