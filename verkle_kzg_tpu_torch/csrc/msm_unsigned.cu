// The unsigned instances of the single-MSM accumulation (K8); see
// msm_accumulate.cuh.
#include "msm_accumulate.cuh"

extern "C" int vkzg_msm_accumulate_unsigned(const void* pts, const void* sc, const void* masks,
                                        void* table, int64_t nseg, int64_t seg_len, int c,
                                        cudaStream_t stream) {
  return vkzg::launch_accumulate_any<false>(pts, sc, masks, table, nseg, seg_len, c, stream);
}
