// K1AFF: projective BN254 G1 points, (N, 3, 8) Montgomery words, to the
// standard-form canonical affine words (N, 2, 8), (0, 0) where Z = 0, in
// ONE launch. See ops/cuda_curve.py (affine_words) for what it replaces and
// why it is shaped so.
//
// One block a row of T points (T a power of two, 1 to 256), a point a
// thread: each Z (zeros taken as one) is scanned both ways in shared memory
// (log2 T levels, K1INV's scan), thread 0 inverts the row's product with
// field_inv.cuh's finv, and each thread forms its Z^-1 from that inverse
// and its neighbours' prefix and suffix products. Then x Z^-1 and y Z^-1,
// and each of those times the plain integer 1, which takes it out of
// Montgomery form. Every product is reduced and an inverse is unique, so
// the words do not depend on T or on the row split.
#include <cuda_runtime.h>

#include "bn254_field.cuh"
#include "field_inv.cuh"

using namespace vkzg;

namespace {

constexpr int ROW = 256;  // points a block at most

__device__ __forceinline__ void set_one(uint32_t x[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = Fq::one(j);
}

__global__ void __launch_bounds__(ROW) affine_kernel(const uint32_t* __restrict__ p,
                                                     uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t pre[ROW * 8];
  __shared__ __align__(16) uint32_t suf[ROW * 8];
  __shared__ __align__(16) uint32_t total_inv[8];
  const int T = blockDim.x, t = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * T + t;
  const bool live = i < n;

  uint32_t z[8], y[8];
  if (live) {
    load8(z, p + 24 * i + 16);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) z[j] = 0;
  }
  const bool zero = is_zero(z);
  if (zero) set_one(z);
  store8(pre + 8 * t, z);
  store8(suf + 8 * t, z);
  __syncthreads();
  for (int k = 1; k < T; k <<= 1) {  // inclusive prefix and suffix products
    uint32_t a[8], s[8];
    const bool has_p = t >= k, has_s = t + k < T;
    if (has_p) {
      load8(a, pre + 8 * (t - k));
      load8(y, pre + 8 * t);
      fmul<Fq, false>(a, a, y);
    }
    if (has_s) {
      load8(s, suf + 8 * t);
      load8(y, suf + 8 * (t + k));
      fmul<Fq, false>(s, s, y);
    }
    __syncthreads();
    if (has_p) store8(pre + 8 * t, a);
    if (has_s) store8(suf + 8 * t, s);
    __syncthreads();
  }
  if (t == 0) {
    load8(y, pre + 8 * (T - 1));
    finv<Fq>(y, y);
    store8(total_inv, y);
  }
  __syncthreads();
  if (!live) return;

  uint32_t w[8];  // Z^-1: the row's inverse times every other Z
  load8(w, total_inv);
  if (t > 0) {
    load8(y, pre + 8 * (t - 1));
    fmul<Fq, false>(w, w, y);
  }
  if (t + 1 < T) {
    load8(y, suf + 8 * (t + 1));
    fmul<Fq, false>(w, w, y);
  }
  uint32_t x[8], one[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) one[j] = j == 0;
  load8(x, p + 24 * i);
  load8(y, p + 24 * i + 8);
  fmul<Fq, false>(x, x, w);
  fmul<Fq, false>(y, y, w);
  fmul<Fq, false>(x, x, one);
  fmul<Fq, false>(y, y, one);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x[j] = zero ? 0u : x[j];
    y[j] = zero ? 0u : y[j];
  }
  store8(out + 16 * i, x);
  store8(out + 16 * i + 8, y);
}

}  // namespace

// p (n, 3, 8) projective Montgomery words, out (n, 2, 8); row: points a
// block, a power of two from 1 to 256.
extern "C" int vkzg_affine(const void* p, void* out, int64_t n, int row, void* stream) {
  if (n < 1 || row < 1 || row > ROW || (row & (row - 1))) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + row - 1) / row;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  affine_kernel<<<(unsigned)blocks, row, 0, (cudaStream_t)stream>>>((const uint32_t*)p, (uint32_t*)out,
                                                                    n);
  return (int)cudaGetLastError();
}
