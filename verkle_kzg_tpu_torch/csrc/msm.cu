// K4 and K7, the MSM tail (msm_tail.cuh: one design for the single MSM's
// one lane and the batched MSM's B lanes). See ops/cuda_msm.py for what they
// replace and why they are shaped so.
#include <cuda_runtime.h>

#include "msm_tail.cuh"

using namespace vkzg;

// K4: buckets (W, rows, 3, 8) reduced -> out (3, 8) reduced; K7: buckets
// (W, B, rows, 3, 8) -> out (B, 3, 8). pairs_a / pairs_b (W, B, groups, 2,
// 3, 8) for windows of more than 32 runs, sums (B, W, 3, 8), counters (B)
// int32 zeros; parts: 1 the window sums, 2 Horner, 3 the whole tail.
extern "C" int vkzg_msm_tail(const void* buckets, void* pairs_a, void* pairs_b, void* sums,
                             void* counters, void* out, int nwin, int rows, int log2_run, int c,
                             int parts, void* stream) {
  return launch_tail((const uint32_t*)buckets, (uint32_t*)pairs_a, (uint32_t*)pairs_b,
                     (uint32_t*)sums, (int*)counters, (uint32_t*)out, nwin, 1, rows, log2_run, c,
                     parts, (cudaStream_t)stream);
}

extern "C" int vkzg_msm_batched_tail(const void* buckets, void* pairs_a, void* pairs_b, void* sums,
                                     void* counters, void* out, int nwin, int64_t nlanes, int rows,
                                     int log2_run, int c, int parts, void* stream) {
  return launch_tail((const uint32_t*)buckets, (uint32_t*)pairs_a, (uint32_t*)pairs_b,
                     (uint32_t*)sums, (int*)counters, (uint32_t*)out, nwin, nlanes, rows, log2_run,
                     c, parts, (cudaStream_t)stream);
}
