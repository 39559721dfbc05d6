// K5: element-wise scalar multiplication of affine points, one lane per
// thread: 256 MSB-first rounds of lazy doubling, then a lazy mixed add where
// the scalar's bit is set. See ops/cuda_scalar_mul.py for what it replaces
// and why it is shaped so.
#include <cuda_runtime.h>

#include "bn254_curve.cuh"

using namespace vkzg;

// pts (n, 2, 8) canonical affine Montgomery words with the (0, 0) sentinel,
// sc (n, 8) standard-form scalar words -> out (n, 3, 8) reduced projective.
// A (0, 0) lane takes no bit, so it emits the identity (0 : 1 : 0); the
// mixed add is not complete for the sentinel, and the bit mask is the only
// place the kernel looks at it.
__global__ void __launch_bounds__(128) scalar_mul_kernel(const uint32_t* __restrict__ pts,
                                                         const uint32_t* __restrict__ sc,
                                                         uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t ax[8], ay[8];
  load8(ax, pts + 16 * i);
  load8(ay, pts + 16 * i + 8);
  const uint32_t live = (is_zero(ax) && is_zero(ay)) ? 0u : 0xFFFFFFFFu;

  Point acc;
  set_infinity(acc);
  for (int w = 7; w >= 0; --w) {
    const uint32_t word = sc[8 * i + w] & live;
    for (int b = 31; b >= 0; --b) {
      double_lazy(acc);
      if ((word >> b) & 1u) mixed_add_lazy(acc, ax, ay);
    }
  }
  reduce_point(acc);
  store_point(out + 24 * i, acc);
}

extern "C" int vkzg_scalar_mul(const void* pts, const void* sc, void* out, int64_t n,
                               void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  scalar_mul_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pts, (const uint32_t*)sc, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
