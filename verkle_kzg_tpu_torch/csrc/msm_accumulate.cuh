// The segment walk of the table-per-thread bucket accumulation (K6, K8,
// K10): fed by a digit fetch that either takes the unsigned digits from the
// scalar words (K8: a kernel template over the window width C in {1, 2, 4,
// 8, 16}, whose instances are compiled in msm_unsigned.cu) or reads them
// from a digit tensor (K6, K10: msm_batched.cu). The signed single MSM (K3,
// K9) is the bucket-sorted design of msm_sorted.cu. See ops/cuda_msm.py and
// ops/cuda_msm_batched.py for what they replace and why they are shaped so.
#pragma once
#include <cuda_runtime.h>

#include "bn254_curve.cuh"

namespace vkzg {

// One thread's segment: fill its table of `rows` buckets with the identity,
// then for each point i < seg_len of the segment take d = digit(i); d = 0 and
// the (0, 0) sentinel add nothing, d < 0 negates y, and the point is added
// into row |d| - 1 with the lazy mixed add. At the end the rows are reduced
// to [0, m). pts points at the segment's first (x, y) affine point.
template <class Digit>
__device__ __forceinline__ void accumulate_segment(const uint32_t* __restrict__ pts,
                                                   uint32_t* __restrict__ tbl, int rows,
                                                   int64_t seg_len, const Digit& digit) {
  Point inf;
  set_infinity(inf);
  for (int r = 0; r < rows; ++r) store_point(tbl + 24 * r, inf);

  for (int64_t i = 0; i < seg_len; ++i) {
    int d = digit(i);
    if (d == 0) continue;
    uint32_t ax[8], ay[8];
    load8(ax, pts + 16 * i);
    load8(ay, pts + 16 * i + 8);
    if (is_zero(ax) && is_zero(ay)) continue;
    if (d < 0) {
      uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      fsub<Fq, false>(ay, zero, ay);
      d = -d;
    }
    uint32_t* row = tbl + 24 * (d - 1);
    Point acc;
    load_point(acc, row);
    point_mixed_add<true>(acc, ax, ay);
    store_point(row, acc);
  }

  for (int r = 0; r < rows; ++r) {
    Point p;
    load_point(p, tbl + 24 * r);
    reduce_point(p);
    store_point(tbl + 24 * r, p);
  }
}

// Window w's unsigned digit from the scalar words: bits [w C, w C + C) of
// the scalar, inside one word since C divides 16. sc points at the
// segment's first scalar.
template <int C>
struct ScalarWordDigit {
  static constexpr uint32_t DMASK = (1u << C) - 1u;
  const uint32_t* __restrict__ sc;
  int sc_word, sc_shift;

  __device__ __forceinline__ ScalarWordDigit(const uint32_t* sc_, int w)
      : sc(sc_), sc_word((w * C) >> 5), sc_shift((w * C) & 31) {}

  __device__ __forceinline__ int operator()(int64_t i) const {
    return (int)((sc[8 * i + sc_word] >> sc_shift) & DMASK);
  }
};

// K8. Thread t owns window w = t % W of point segment s = t / W and a
// private table of 2^C - 1 buckets in global memory, laid out
// (W, S, ROWS, 3, 8).
template <int C>
__global__ void __launch_bounds__(128) msm_accumulate_kernel(
    const uint32_t* __restrict__ pts, const uint32_t* __restrict__ sc,
    uint32_t* __restrict__ table, int64_t nseg, int64_t seg_len) {
  constexpr int W = 256 / C;
  constexpr int ROWS = (1 << C) - 1;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * nseg) return;
  const int w = (int)(t % W);
  const int64_t s = t / W;
  const int64_t k0 = s * seg_len;
  const ScalarWordDigit<C> digit(sc + 8 * k0, w);
  accumulate_segment(pts + 16 * k0, table + ((int64_t)w * nseg + s) * ROWS * 24, ROWS, seg_len,
                     digit);
}

template <int C>
inline int launch_accumulate(const void* pts, const void* sc, void* table, int64_t nseg,
                             int64_t seg_len, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)(((256 / C) * nseg + threads - 1) / threads);
  msm_accumulate_kernel<C><<<blocks, threads, 0, stream>>>(
      (const uint32_t*)pts, (const uint32_t*)sc, (uint32_t*)table, nseg, seg_len);
  return (int)cudaGetLastError();
}

}  // namespace vkzg
