// The segment walk of the table-per-thread bucket accumulation, K6: the
// digit tensor of a lane-batched MSM or of a single MSM whose window has at
// most 128 rows (msm_batched.cu). Every other accumulation is the
// bucket-sorted design of msm_sorted.cu: K3 and K9 (signed digits from the
// scalar words), K8 (unsigned ones) and K10 (a digit tensor of more than
// 128 rows). See ops/cuda_msm_batched.py for what K6 replaces and why it is
// shaped so.
#pragma once
#include <cuda_runtime.h>

#include "bn254_curve.cuh"

namespace vkzg {

// One thread's segment: fill its table of `rows` buckets with the identity,
// then for each point i < seg_len of the segment take d = digits[i]; d = 0
// and the (0, 0) sentinel add nothing, d < 0 negates y, and the point is
// added into row |d| - 1 with the lazy mixed add. At the end the rows are
// reduced to [0, m). pts and digits point at the segment's first (x, y)
// affine point and its digit.
__device__ __forceinline__ void accumulate_segment(const uint32_t* __restrict__ pts,
                                                   const int32_t* __restrict__ digits,
                                                   uint32_t* __restrict__ tbl, int rows,
                                                   int64_t seg_len) {
  Point inf;
  set_infinity(inf);
  for (int r = 0; r < rows; ++r) store_point(tbl + 24 * r, inf);

  for (int64_t i = 0; i < seg_len; ++i) {
    int d = digits[i];
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

}  // namespace vkzg
