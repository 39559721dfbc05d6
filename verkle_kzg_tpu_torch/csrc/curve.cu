// K2, K11, K12: element-wise complete projective group law in the reduced
// domain, one point per thread: K2 adds (RCB16 algorithm 7), K11 doubles
// (algorithm 9), K12 adds an affine point (algorithm 8, the (0, 0)
// sentinel selecting p). K2FOLD sums rows of points by K2's halving tree in
// one launch. See ops/cuda_curve.py.
#include <cuda_runtime.h>

#include "bn254_curve.cuh"

using namespace vkzg;

__global__ void __launch_bounds__(128) point_add_kernel(const uint32_t* p, const uint32_t* q,
                                                        uint32_t* out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point a, b;
  load_point(a, p + 24 * i);
  load_point(b, q + 24 * i);
  point_add<false>(a, a, b);
  store_point(out + 24 * i, a);
}

__global__ void __launch_bounds__(128) point_double_kernel(const uint32_t* p, uint32_t* out,
                                                           int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point a;
  load_point(a, p + 24 * i);
  point_double<false>(a);
  store_point(out + 24 * i, a);
}

__global__ void __launch_bounds__(128) point_mixed_add_kernel(const uint32_t* p,
                                                              const uint32_t* q_aff,
                                                              uint32_t* out, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point a;
  uint32_t ax[8], ay[8];
  load_point(a, p + 24 * i);
  load8(ax, q_aff + 16 * i);
  load8(ay, q_aff + 16 * i + 8);
  if (!(is_zero(ax) && is_zero(ay))) point_mixed_add<false>(a, ax, ay);
  store_point(out + 24 * i, a);
}

// K2FOLD: each row of (rows, n) points summed by the halving tree of
// ops/cuda_curve.py::plain_fold, in its order: a level adds pair (i, i + half)
// into slot i and carries the odd tail point to slot half. `group` threads
// (a power of two, at most 32) share a row and its pairs; a block holds
// 128 / group rows, whose levels step together. Level 1 reads `in` and
// writes `work` (rows, ceil(n / 2)); later levels run in place in `work`,
// where pair i reads slots i and i + half and writes slot i, and only the
// thread of pair 0, which read slot half, overwrites it with the tail.
__global__ void __launch_bounds__(128) point_fold_kernel(const uint32_t* in, uint32_t* work,
                                                         int64_t rows, int n, int group) {
  const int lane = threadIdx.x % group;
  const int64_t row = (int64_t)blockIdx.x * (128 / group) + threadIdx.x / group;
  const bool live = row < rows;
  uint32_t* dst = work + row * ((n + 1) / 2) * 24;
  const uint32_t* src = in + row * n * 24;
  for (int m = n; m > 1; m = m / 2 + (m & 1)) {
    const int half = m / 2;
    if (live) {
      for (int i = lane; i < half; i += group) {
        Point p, q;
        load_point(p, src + 24 * i);
        load_point(q, src + 24 * (i + half));
        point_add<false>(p, p, q);
        store_point(dst + 24 * i, p);
        if (i == 0 && (m & 1)) {
          load_point(q, src + 24 * (m - 1));
          store_point(dst + 24 * half, q);
        }
      }
    }
    src = dst;
    __syncthreads();  // the next level reads slots that other threads wrote
  }
}

static unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

extern "C" int vkzg_point_add(const void* p, const void* q, void* out, int64_t n,
                              void* stream) {
  point_add_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int vkzg_point_double(const void* p, void* out, int64_t n, void* stream) {
  point_double_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int vkzg_point_mixed_add(const void* p, const void* q_aff, void* out, int64_t n,
                                    void* stream) {
  point_mixed_add_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p, (const uint32_t*)q_aff, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}

// in (rows, n, 3, 8), work (rows, ceil(n / 2), 3, 8); n >= 2. Row r's sum
// lands in work[r, 0].
extern "C" int vkzg_point_fold(const void* in, void* work, int64_t rows, int64_t n, void* stream) {
  int group = 1;
  while (group < n / 2 && group < 32) group *= 2;
  point_fold_kernel<<<blocks_for(rows, 128 / group), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)work, rows, (int)n, group);
  return (int)cudaGetLastError();
}
