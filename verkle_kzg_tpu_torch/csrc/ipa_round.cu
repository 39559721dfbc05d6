// K1IPA: one halving round of the IPA prove in one launch, and the prove's
// inner product <a, b>, over Fr in the reduced domain. See ops/cuda_ipa.py
// for what it replaces and why it is shaped so.
//
// One block of THREADS threads does the whole vector; thread t owns slots
// t, t + THREADS, ..., so any power-of-two length runs. The fold reads
// a[j + half], which another thread owns, so it reads the input buffers and
// writes the output buffers (the wrapper allocates both), and the scalar
// build reads the folded vectors back after one __syncthreads().
#include <cuda_runtime.h>

#include "bn254_field.cuh"

using namespace vkzg;

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void set_zero(uint32_t r[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = 0;
}

// Montgomery -> standard form: the Montgomery product by the integer 1.
__device__ __forceinline__ void from_mont(uint32_t r[8], const uint32_t a[8]) {
  const uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  fmul<Fr, false>(r, a, one);
}

// Modular sums over the block of each thread's K elements, left in thread
// 0's s. Every add is reduced and a reduced sum is unique, so the words do
// not depend on the order of the tree. Every thread of the block must call.
template <int K>
__device__ void block_sum(uint32_t (&s)[K][8]) {
  __shared__ uint32_t sh[K][8][THREADS];
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) sh[k][j][tid] = s[k][j];
  __syncthreads();
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint32_t o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = sh[k][j][tid + stride];
        fadd<Fr, false>(s[k], s[k], o);
#pragma unroll
        for (int j = 0; j < 8; ++j) sh[k][j][tid] = s[k][j];
      }
    }
    __syncthreads();
  }
}

// 1. Fold x into a, b and wts at `half` (0: no fold, the vectors copied):
//      a'[j] = a[j] + x a[j + half],  b'[j] = b[j + half] + x b[j]  (j < half),
//      wts'[i] = x wts[i]  where i mod 2 half < half;
//    other slots keep their words. wts null: all Montgomery one.
// 2. With len > 0, the next round's MSM scalars in standard form, rows l and
//    r of sc (2, n [+ 1], 8), h = len / 2, pos = i mod len:
//      sc_l[i] = wts'[i] a'[pos - h] where pos >= h, else 0,
//      sc_r[i] = wts'[i] a'[pos + h] where pos < h, else 0,
//    and with b, slot n: w <a'_l, b'_r> and w <a'_r, b'_l> over j < h.
__global__ void __launch_bounds__(THREADS)
    ipa_round_kernel(const uint32_t* a, const uint32_t* b, const uint32_t* wts, uint32_t* a_out,
                     uint32_t* b_out, uint32_t* wts_out, uint32_t* sc, const uint32_t* xp,
                     const uint32_t* wp, int64_t n, int64_t half, int64_t len) {
  const int tid = threadIdx.x;
  uint32_t x[8], w[8];  // from device memory: the challenges FSX (or the host) wrote there
  if (half) load8(x, xp);
  if (len && b) load8(w, wp);
  for (int64_t i = tid; i < n; i += THREADS) {
    const bool live = i < half;
    uint32_t v[8], u[8];
    load8(v, a + 8 * i);
    if (live) {
      load8(u, a + 8 * (i + half));
      fmul<Fr, false>(u, u, x);
      fadd<Fr, false>(v, v, u);
    }
    store8(a_out + 8 * i, v);
    if (b) {
      load8(v, b + 8 * i);
      if (live) {
        load8(u, b + 8 * (i + half));
        fmul<Fr, false>(v, v, x);
        fadd<Fr, false>(v, u, v);
      }
      store8(b_out + 8 * i, v);
    }
    if (wts_out) {
      if (wts) {
        load8(v, wts + 8 * i);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = Fr::one(j);
      }
      if (half && (i & (2 * half - 1)) < half) fmul<Fr, false>(v, v, x);
      store8(wts_out + 8 * i, v);
    }
  }
  if (len == 0) return;  // the same for every thread
  __syncthreads();  // the scalars read slots that other threads folded

  const int64_t h = len / 2;
  uint32_t* sc_l = sc;
  uint32_t* sc_r = sc + 8 * (n + (b ? 1 : 0));
  uint32_t ip[2][8];
  set_zero(ip[0]);
  set_zero(ip[1]);
  for (int64_t i = tid; i < n; i += THREADS) {
    const int64_t pos = i & (len - 1);
    const bool right = pos >= h;
    uint32_t v[8], u[8], z[8];
    set_zero(z);
    load8(v, wts_out + 8 * i);
    load8(u, a_out + 8 * (right ? pos - h : pos + h));
    fmul<Fr, false>(v, v, u);
    from_mont(v, v);
    if (right) {
      store8(sc_l + 8 * i, v);
      store8(sc_r + 8 * i, z);
    } else {
      store8(sc_l + 8 * i, z);
      store8(sc_r + 8 * i, v);
    }
    if (b && i < h) {
      load8(v, a_out + 8 * i);
      load8(u, b_out + 8 * (i + h));
      fmul<Fr, false>(v, v, u);
      fadd<Fr, false>(ip[0], ip[0], v);
      load8(v, a_out + 8 * (i + h));
      load8(u, b_out + 8 * i);
      fmul<Fr, false>(v, v, u);
      fadd<Fr, false>(ip[1], ip[1], v);
    }
  }
  if (b) {  // the same for every thread
    block_sum<2>(ip);
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        fmul<Fr, false>(ip[k], ip[k], w);
        from_mont(ip[k], ip[k]);
      }
      store8(sc_l + 8 * n, ip[0]);
      store8(sc_r + 8 * n, ip[1]);
    }
  }
}

// out = sum_i a[i] b[i] (Montgomery products, reduced sums): one element.
__global__ void __launch_bounds__(THREADS)
    ipa_inner_kernel(const uint32_t* a, const uint32_t* b, uint32_t* out, int64_t n) {
  uint32_t s[1][8];
  set_zero(s[0]);
  for (int64_t i = threadIdx.x; i < n; i += THREADS) {
    uint32_t v[8], u[8];
    load8(v, a + 8 * i);
    load8(u, b + 8 * i);
    fmul<Fr, false>(v, v, u);
    fadd<Fr, false>(s[0], s[0], v);
  }
  block_sum<1>(s);
  if (threadIdx.x == 0) store8(out, s[0]);
}

}  // namespace

// x, w: device pointers to 8 Montgomery words each (null where unused); b, wts,
// b_out: null without b; wts and wts_out: see the kernel; sc: null when
// len == 0.
extern "C" int vkzg_ipa_round(const void* a, const void* b, const void* wts, void* a_out,
                              void* b_out, void* wts_out, void* sc, const void* x, const void* w,
                              int64_t n, int64_t half, int64_t len, void* stream) {
  ipa_round_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)wts, (uint32_t*)a_out,
      (uint32_t*)b_out, (uint32_t*)wts_out, (uint32_t*)sc, (const uint32_t*)x, (const uint32_t*)w, n,
      half, len);
  return (int)cudaGetLastError();
}

extern "C" int vkzg_ipa_inner(const void* a, const void* b, void* out, int64_t n, void* stream) {
  ipa_inner_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>((const uint32_t*)a, (const uint32_t*)b,
                                                           (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
