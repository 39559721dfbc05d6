// K6: the digit-tensor Pippenger accumulation as a table walk, each lane its
// own MSM, over digits of up to 128 rows a window (bucket |d| in row |d| - 1
// of a `rows`-row table: 2^(c-1) rows for balanced signed digits, 2^c - 1
// unsigned). A digit tensor of more rows takes K10, the bucket-sorted
// design of msm_sorted.cu. K7, the lane-batched tail, is msm_tail.cuh's,
// with its entry point in msm.cu. See ops/cuda_msm_batched.py for what they
// replace and why they are shaped so.
#include <cuda_runtime.h>

#include "msm_accumulate.cuh"

using namespace vkzg;

// K6. Thread t owns window w = t % W of lane b and point segment s
// ((t / W) = s * B + b), and a private table of `rows` buckets in global
// memory, laid out (W, B, S, rows, 3, 8), filled by the segment walk
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
  accumulate_segment(pts + b * lane_stride + s * seg_len * 16,
                     digits + ((int64_t)w * nlanes + b) * nseg * seg_len + s * seg_len,
                     table + (((int64_t)w * nlanes + b) * nseg + s) * rows * 24, rows, seg_len);
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
