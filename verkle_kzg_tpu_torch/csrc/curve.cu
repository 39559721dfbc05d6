// K2, K11, K12: element-wise complete projective group law in the reduced
// domain, one point per thread: K2 adds (RCB16 algorithm 7), K11 doubles
// (algorithm 9), K12 adds an affine point (algorithm 8, the (0, 0)
// sentinel selecting p). See ops/cuda_curve.py.
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
