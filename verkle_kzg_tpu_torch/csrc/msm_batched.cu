// K6 / K10 and K7: the digit-tensor Pippenger accumulation, each lane its own
// MSM, over digits of any width (bucket |d| in row |d| - 1 of a `rows`-row
// table: 2^(c-1) rows for balanced signed digits, 2^c - 1 unsigned; counted
// as K10 above 128 rows), and the lane-batched tail for c in [2, 16] over
// any number of rows (row i the bucket of digit i + 1).
// See ops/cuda_msm_batched.py for what they replace and why they are shaped so.
#include <cuda_runtime.h>

#include "msm_accumulate.cuh"

using namespace vkzg;

namespace {
constexpr int MAX_WINDOWS = 128;  // c = 2: ceil(256 / 2)

// The digits of one (window, lane, segment), read from the digit tensor.
struct TensorDigit {
  const int32_t* __restrict__ dg;
  __device__ __forceinline__ int operator()(int64_t i) const { return dg[i]; }
};
}  // namespace

// K6 / K10. Thread t owns window w = t % W of lane b and point segment s
// ((t / W) = s * B + b), and a private table of `rows` buckets in global
// memory, laid out (W, B, S, rows, 3, 8), filled by the shared segment walk
// (msm_accumulate.cuh) with digit d = digits[w, b, point]. Lane b reads its
// points at pts + b * lane_stride: 0 for a basis shared by every lane.
__global__ void __launch_bounds__(128) msm_batched_accumulate_kernel(
    const uint32_t* __restrict__ pts, int64_t lane_stride, const int32_t* __restrict__ digits,
    uint32_t* __restrict__ table, int nwin, int64_t nlanes, int64_t nseg, int64_t seg_len,
    int rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)nwin * nlanes * nseg) return;
  const int w = (int)(t % nwin);
  const int64_t rest = t / nwin;
  const int64_t b = rest % nlanes;
  const int64_t s = rest / nlanes;
  const TensorDigit digit{digits + ((int64_t)w * nlanes + b) * nseg * seg_len + s * seg_len};
  accumulate_segment(pts + b * lane_stride + s * seg_len * 16,
                     table + (((int64_t)w * nlanes + b) * nseg + s) * rows * 24, rows, seg_len,
                     digit);
}

// K7. One block per lane, one thread per window: thread w runs the suffix
// sum over its rows from the top, keeping S = sum of the rows seen and
// T = sum of the running S, so T = sum_j (j + 1) B_j, the window's weighted
// bucket sum. Thread 0 then runs Horner from the top window down (c lazy
// doublings, then an add) and reduces the result to [0, m).
__global__ void __launch_bounds__(MAX_WINDOWS) msm_batched_tail_kernel(
    const uint32_t* __restrict__ buckets, uint32_t* __restrict__ out, int nwin, int64_t nlanes,
    int rows, int c) {
  __shared__ Point sums[MAX_WINDOWS];
  const int64_t b = blockIdx.x;
  const int w = threadIdx.x;

  if (w < nwin) {
    const uint32_t* bk = buckets + ((int64_t)w * nlanes + b) * rows * 24;
    Point S, T;
    set_infinity(S);
    set_infinity(T);
    for (int j = rows - 1; j >= 0; --j) {
      Point p;
      load_point(p, bk + 24 * j);
      point_add<true>(S, S, p);
      point_add<true>(T, T, S);
    }
    sums[w] = T;
  }
  __syncthreads();

  if (w == 0) {
    Point acc = sums[nwin - 1];
    for (int k = nwin - 2; k >= 0; --k) {
      for (int i = 0; i < c; ++i) point_double<true>(acc);
      point_add<true>(acc, acc, sums[k]);
    }
    reduce_point(acc);
    store_point(out + 24 * b, acc);
  }
}

// pts: (npoints, 2, 8) affine shared by every lane (lane_stride 0) or
// (B, npoints, 2, 8) (lane_stride npoints * 16); digits (W, B, npoints) int32
// with npoints = nseg * seg_len -> table (W, B, nseg, rows, 3, 8).
extern "C" int vkzg_msm_batched_accumulate(const void* pts, int64_t lane_stride,
                                           const void* digits, void* table, int nwin,
                                           int64_t nlanes, int64_t nseg, int64_t seg_len,
                                           int rows, void* stream) {
  const int threads = 128;
  const int64_t total = (int64_t)nwin * nlanes * nseg;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  msm_batched_accumulate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pts, lane_stride, (const int32_t*)digits, (uint32_t*)table, nwin,
      nlanes, nseg, seg_len, rows);
  return (int)cudaGetLastError();
}

// buckets (W, B, rows, 3, 8) reduced -> out (B, 3, 8) reduced.
extern "C" int vkzg_msm_batched_tail(const void* buckets, void* out, int nwin, int64_t nlanes,
                                     int rows, int c, void* stream) {
  if (nwin < 1 || nwin > MAX_WINDOWS) return (int)cudaErrorInvalidValue;
  msm_batched_tail_kernel<<<(unsigned)nlanes, MAX_WINDOWS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)buckets, (uint32_t*)out, nwin, nlanes, rows, c);
  return (int)cudaGetLastError();
}
