// The bucket accumulation every single and batched Pippenger kernel runs
// (K3, K6, K8, K9, K10): one segment walk, fed by a digit fetch that either
// takes the digits from the scalar words (K3, K8, K9: a kernel template over
// the window width C in {1, 2, 4, 8, 16} and the digit sign, whose
// instances are compiled in msm_signed.cu and msm_unsigned.cu, which nvcc
// builds in parallel) or reads them from a digit tensor (K6, K10:
// msm_batched.cu). See ops/cuda_msm.py and ops/cuda_msm_batched.py for what
// they replace and why they are shaped so.
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

// Window w's digit from the scalar words: the raw digit is bits
// [w C, w C + C) of the scalar, inside one word since C divides 16. Signed,
// d = raw + carry-in bit w - (carry-out bit w + 1) << C from the NWORDS
// carry words; unsigned, d = raw. sc and masks point at the segment's first
// scalar.
template <int C, bool SIGNED>
struct ScalarWordDigit {
  static constexpr int NWORDS = 256 / C / 32 + 1;
  static constexpr uint32_t DMASK = (1u << C) - 1u;
  const uint32_t* __restrict__ sc;
  const uint32_t* __restrict__ masks;
  int sc_word, sc_shift, in_word, in_bit, out_word, out_bit;

  __device__ __forceinline__ ScalarWordDigit(const uint32_t* sc_, const uint32_t* masks_, int w)
      : sc(sc_), masks(masks_), sc_word((w * C) >> 5), sc_shift((w * C) & 31), in_word(w >> 5),
        in_bit(w & 31), out_word((w + 1) >> 5), out_bit((w + 1) & 31) {}

  __device__ __forceinline__ int operator()(int64_t i) const {
    int d = (int)((sc[8 * i + sc_word] >> sc_shift) & DMASK);
    if (SIGNED) {
      const int ci = (int)((masks[NWORDS * i + in_word] >> in_bit) & 1u);
      const int co = (int)((masks[NWORDS * i + out_word] >> out_bit) & 1u);
      d = d + ci - (co << C);
    }
    return d;
  }
};

// K3 / K8 / K9. Thread t owns window w = t % W of point segment s = t / W
// and a private table of ROWS buckets in global memory, laid out
// (W, S, ROWS, 3, 8). C = 8, signed, is the default single MSM.
template <int C, bool SIGNED>
__global__ void __launch_bounds__(128) msm_accumulate_kernel(
    const uint32_t* __restrict__ pts, const uint32_t* __restrict__ sc,
    const uint32_t* __restrict__ masks, uint32_t* __restrict__ table, int64_t nseg,
    int64_t seg_len) {
  constexpr int W = 256 / C;
  constexpr int ROWS = SIGNED ? (1 << (C - 1)) : (1 << C) - 1;
  using Digit = ScalarWordDigit<C, SIGNED>;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * nseg) return;
  const int w = (int)(t % W);
  const int64_t s = t / W;
  const int64_t k0 = s * seg_len;
  const Digit digit(sc + 8 * k0, SIGNED ? masks + Digit::NWORDS * k0 : nullptr, w);
  accumulate_segment(pts + 16 * k0, table + ((int64_t)w * nseg + s) * ROWS * 24, ROWS, seg_len,
                     digit);
}

template <int C, bool SIGNED>
inline int launch_accumulate(const void* pts, const void* sc, const void* masks, void* table,
                             int64_t nseg, int64_t seg_len, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)(((256 / C) * nseg + threads - 1) / threads);
  msm_accumulate_kernel<C, SIGNED><<<blocks, threads, 0, stream>>>(
      (const uint32_t*)pts, (const uint32_t*)sc, (const uint32_t*)masks, (uint32_t*)table, nseg,
      seg_len);
  return (int)cudaGetLastError();
}

// The instances of one sign for c in {1, 2, 4, 8, 16}; any other c is refused.
template <bool SIGNED>
inline int launch_accumulate_any(const void* pts, const void* sc, const void* masks, void* table,
                                 int64_t nseg, int64_t seg_len, int c, cudaStream_t stream) {
  switch (c) {
    case 1: return launch_accumulate<1, SIGNED>(pts, sc, masks, table, nseg, seg_len, stream);
    case 2: return launch_accumulate<2, SIGNED>(pts, sc, masks, table, nseg, seg_len, stream);
    case 4: return launch_accumulate<4, SIGNED>(pts, sc, masks, table, nseg, seg_len, stream);
    case 8: return launch_accumulate<8, SIGNED>(pts, sc, masks, table, nseg, seg_len, stream);
    case 16: return launch_accumulate<16, SIGNED>(pts, sc, masks, table, nseg, seg_len, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace vkzg
