// K8, the unsigned single-MSM accumulation (msm_accumulate.cuh), for c in
// {1, 2, 4, 8, 16}; any other c is refused. A file of its own so that nvcc
// builds it in parallel with the tail (msm.cu).
#include "msm_accumulate.cuh"

// pts (nseg * seg_len, 2, 8) affine, sc (.., 8) standard scalars -> table
// (W, nseg, 2^c - 1, 3, 8).
extern "C" int vkzg_msm_accumulate(const void* pts, const void* sc, void* table, int64_t nseg,
                                   int64_t seg_len, int c, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (c) {
    case 1: return vkzg::launch_accumulate<1>(pts, sc, table, nseg, seg_len, st);
    case 2: return vkzg::launch_accumulate<2>(pts, sc, table, nseg, seg_len, st);
    case 4: return vkzg::launch_accumulate<4>(pts, sc, table, nseg, seg_len, st);
    case 8: return vkzg::launch_accumulate<8>(pts, sc, table, nseg, seg_len, st);
    case 16: return vkzg::launch_accumulate<16>(pts, sc, table, nseg, seg_len, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
