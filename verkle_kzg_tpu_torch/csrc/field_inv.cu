// K1INV: Montgomery's batch inversion over the element axis of (R, N, 8)
// Montgomery words, every row in ONE launch; N = 1 is the element-wise
// inverse. See ops/cuda_field.py for what it replaces and why it is shaped
// so. Zero entries map to zero (ark_ff::batch_inversion skips them).
//
// Every product is a reduced Montgomery product of reduced operands, so it
// is the canonical word of its value, and an inverse is unique: the scan's
// order and the inversion method change no output word.
#include <cuda_runtime.h>

#include "bn254_field.cuh"
#include "field_inv.cuh"

using namespace vkzg;

namespace {

constexpr int SCAN = 256;  // threads a row at most (N > 1)

template <class F>
__device__ __forceinline__ void set_one(uint32_t x[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = F::one(j);
}

// N = 1: one element a thread.
template <class F>
__global__ void __launch_bounds__(128) inv_elements_kernel(const uint32_t* __restrict__ a,
                                                           uint32_t* __restrict__ out,
                                                           int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8];
  load8(x, a + 8 * i);
  if (!is_zero(x)) finv<F>(x, x);
  store8(out + 8 * i, x);
}

// N > 1: one block a row of n elements, T threads (a power of two, at most
// SCAN), each owning a run of ceil(n / T) elements. Its running product
// (zeros taken as one) goes to out; the T run products are scanned both
// ways in shared memory (log2 T levels); thread 0 inverts the row's
// product; each thread then forms the inverse of its run's product from
// it and the two scans, and walks its run backwards with two products an
// element: inv_i = w prefix_(i-1), w <- w a_i.
template <class F>
__global__ void __launch_bounds__(SCAN) batch_inv_kernel(const uint32_t* __restrict__ a,
                                                         uint32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) uint32_t pre[SCAN * 8];
  __shared__ __align__(16) uint32_t suf[SCAN * 8];
  __shared__ __align__(16) uint32_t total_inv[8];
  const int T = blockDim.x, t = threadIdx.x;
  const uint32_t* row = a + (int64_t)blockIdx.x * n * 8;
  uint32_t* orow = out + (int64_t)blockIdx.x * n * 8;
  const int64_t len = (n + T - 1) / T;
  const int64_t lo = (int64_t)t * len < n ? (int64_t)t * len : n;
  const int64_t hi = lo + len < n ? lo + len : n;

  uint32_t acc[8], x[8], y[8];
  set_one<F>(acc);
  for (int64_t i = lo; i < hi; ++i) {
    load8(x, row + 8 * i);
    if (is_zero(x)) set_one<F>(x);
    if (i == lo) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = x[j];
    } else {
      fmul<F, false>(acc, acc, x);
    }
    store8(orow + 8 * i, acc);
  }
  store8(pre + 8 * t, acc);
  store8(suf + 8 * t, acc);
  __syncthreads();
  for (int k = 1; k < T; k <<= 1) {  // inclusive prefix and suffix products
    uint32_t p[8], s[8];
    const bool has_p = t >= k, has_s = t + k < T;
    if (has_p) {
      load8(p, pre + 8 * (t - k));
      load8(y, pre + 8 * t);
      fmul<F, false>(p, p, y);
    }
    if (has_s) {
      load8(s, suf + 8 * t);
      load8(y, suf + 8 * (t + k));
      fmul<F, false>(s, s, y);
    }
    __syncthreads();
    if (has_p) store8(pre + 8 * t, p);
    if (has_s) store8(suf + 8 * t, s);
    __syncthreads();
  }
  if (t == 0) {
    load8(x, pre + 8 * (T - 1));
    finv<F>(x, x);
    store8(total_inv, x);
  }
  __syncthreads();
  uint32_t w[8];  // the inverse of this thread's run product
  load8(w, total_inv);
  if (t > 0) {
    load8(y, pre + 8 * (t - 1));
    fmul<F, false>(w, w, y);
  }
  if (t + 1 < T) {
    load8(y, suf + 8 * (t + 1));
    fmul<F, false>(w, w, y);
  }
  for (int64_t i = hi - 1; i >= lo; --i) {
    load8(x, row + 8 * i);
    const bool zero = is_zero(x);
    if (i > lo) {
      load8(y, orow + 8 * (i - 1));
      fmul<F, false>(y, w, y);
      if (!zero) fmul<F, false>(w, w, x);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = w[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = zero ? 0u : y[j];
    store8(orow + 8 * i, y);
  }
}

template <class F>
int launch(const uint32_t* a, uint32_t* out, int64_t rows, int64_t n, cudaStream_t s) {
  if (n == 1) {
    inv_elements_kernel<F><<<(unsigned)((rows + 127) / 128), 128, 0, s>>>(a, out, rows);
  } else {
    int threads = 32;
    while (threads < n && threads < SCAN) threads <<= 1;
    batch_inv_kernel<F><<<(unsigned)rows, threads, 0, s>>>(a, out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// field: 0 = Fq, 1 = Fr; a and out (rows, n, 8) Montgomery words.
extern "C" int vkzg_field_batch_inv(int field, const void* a, void* out, int64_t rows, int64_t n,
                                    void* stream) {
  if (rows < 1 || n < 1 || rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const uint32_t* pa = (const uint32_t*)a;
  uint32_t* po = (uint32_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return field == 0 ? launch<Fq>(pa, po, rows, n, s) : launch<Fr>(pa, po, rows, n, s);
}
