// G1SMUL and G1BFLY: the G1 scalar multiplication of the NTT butterflies
// and of FK's pointwise product as ONE launch a call (G1SMUL) and one
// launch a butterfly stage (G1BFLY), in place of 256 rounds of K11, K2 and
// a select. A group of G threads runs a lane on the lazy warp point
// operations of warp_point.cuh, each coordinate reduced once at the end
// (g1_group.cuh). See ops/cuda_g1_chain.py for what they replace, why they
// are shaped so and which group each regime runs.
#include <cuda_runtime.h>

#include "g1_group.cuh"

// group: threads a lane, 4 or 32 (the regimes' sizes); any other is refused.
extern "C" int vkzg_g1_scalar_mul(const void* p, const void* k, void* out, int64_t n, int group,
                                  void* stream) {
  const uint32_t* a = (const uint32_t*)p;
  const uint32_t* s = (const uint32_t*)k;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 4: return vkzg::launch_scalar_mul<4>(a, s, o, n, st);
    case 32: return vkzg::launch_scalar_mul<32>(a, s, o, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int vkzg_g1_butterfly(const void* x, const void* tw, void* out, int64_t n, int stage,
                                 int group, void* stream) {
  const uint32_t* a = (const uint32_t*)x;
  const uint32_t* w = (const uint32_t*)tw;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 4: return vkzg::launch_butterfly<4>(a, w, o, n, stage, st);
    case 32: return vkzg::launch_butterfly<32>(a, w, o, n, stage, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
