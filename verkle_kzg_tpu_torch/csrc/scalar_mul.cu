// K5: element-wise scalar multiplication of affine points, MSB-first lazy
// double-and-add, each point operation's independent Montgomery products
// on separate threads (warp_point.cuh). Two regimes of one kernel template:
// one warp a lane for few lanes; for many, 4 threads a lane, 8 lanes a
// warp in the order the wrapper gives (live lanes by bit length, longest
// first). It replaces the TPU kernel verkle_kzg_tpu/ops/pallas_curve.py:432
// (scalar_mul_affine).
//
// What bounds it is each lane's chain of dependent point operations, not
// the multiply rate: a product is ~500 dependent instructions (0.68 us on
// one thread) and the path's calls hold 1-40,000 lanes. Spreading a point
// operation's products over threads makes a round's chain 4 products and
// the lazy sums; skipping the rounds above a warp's top bit and the dead
// lanes leaves what the scalars need, except that with 8 lanes a warp the
// mixed add runs on every round (a 4-thread group takes it in two passes a
// level). On an H100 80GB HBM3 at 700 W (tools/k5_regimes.py; 254-bit
// scalars) one lane takes 0.72 ms (~1.9 us a point operation), and the
// verkle commit's 40,000 lanes 2.36 ms at 4 threads a lane (3.31 at 8, 10.2
// one warp a lane; ptxas: 124 registers at 4 threads a lane, 95 one warp a
// lane, no spills). One warp a lane is the faster up to 1,024 lanes and
// 4 threads a lane from 1,152 (see ops/cuda_scalar_mul.py's SWITCH).
#include <cuda_runtime.h>

#include "warp_point.cuh"

// Each regime's shape: warps a block with one warp a lane (FEW_WARPS), and
// threads a lane and warps a block above the switch (MANY_GROUP,
// MANY_WARPS). tools/k5_regimes.py builds variants of this file with other
// values to time them; the path runs these. Warps a block moved no time by
// more than 2% in either regime at the path's shapes.
#ifndef K5_FEW_WARPS
#define K5_FEW_WARPS 4
#endif
#ifndef K5_MANY_GROUP
#define K5_MANY_GROUP 4
#endif
#ifndef K5_MANY_WARPS
#define K5_MANY_WARPS 1
#endif

// Inside vkzg, as warp_point.cuh's unnamed namespace is: two unnamed
// namespaces in reach make nvcc's kernel registration ambiguous.
namespace vkzg {
namespace {

// pts (n, 2, 8) canonical affine Montgomery words with the (0, 0) sentinel,
// sc (n, 8) standard-form scalar words -> out (n, 3, 8) reduced projective.
// G threads a lane, WARPS warps a block. Group g of the launch takes lane
// order[g] (lane g when order is null). A (0, 0) or zero-scalar lane takes
// no bit and writes the identity (0 : 1 : 0): the mixed add is not
// complete for the sentinel.
//
// Rounds run from the warp's highest set bit down. Above a lane's own top
// bit its accumulator is the identity, whose lazy doubling gives its own
// words, and the doubling at the warp's top bit is of identities only, so
// skipping them changes no word. With one lane a warp the mixed add runs
// where the lane's bit is set; with several, on every round, and a group
// whose bit is 0 keeps its accumulator (the plain version's select).
template <int G, int WARPS>
__global__ void __launch_bounds__(32 * WARPS) scalar_mul_kernel(
    const uint32_t* __restrict__ pts, const uint32_t* __restrict__ sc,
    const int* __restrict__ order, uint32_t* __restrict__ out, int64_t n) {
  __shared__ WarpScratch scratch[WARPS * 32 / G];
  const int slot = threadIdx.x / G, t = threadIdx.x % G;
  const int64_t g = (int64_t)blockIdx.x * (WARPS * 32 / G) + slot;
  const bool in = g < n;
  const int64_t i = in ? (order ? order[g] : g) : 0;
  WarpScratch& s = scratch[slot];
  uint32_t k[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (in) {
    load8(k, sc + 8 * i);
    for (int j = t; j < 16; j += G) s.q[j] = pts[16 * i + j];
  }
  if (t == 0) {
    Point id;
    set_infinity(id);
    store_point(s.acc, id);
  }
  __syncwarp();
  uint32_t ax[8], ay[8];
  load8(ax, s.q);
  load8(ay, s.q + 8);
  if (!in || (is_zero(ax) && is_zero(ay))) {
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = 0;
  }
  const int top = warp_top_bit(k);
  bool doubling = false;
  for (int w = top >> 5; top >= 0 && w >= 0; --w) {
    const uint32_t word = pick_word(k, w);
    for (int b = (w == top >> 5) ? (top & 31) : 31; b >= 0; --b) {
      if (doubling) warp_double<true>(s, t);
      doubling = true;
      const bool bit = (word >> b) & 1u;
      if (G < 32 || bit) warp_mixed_add<G>(s, t, bit);
    }
  }
  if (in && t < 3) {
    uint32_t a[8];
    load8(a, s.acc + 8 * t);
    cond_sub<Fq, false>(a);
    store8(out + 24 * i + 8 * t, a);
  }
}

}  // namespace
}  // namespace vkzg

// order: (n,) int32 lane order for the many-lane regime (K5_MANY_GROUP
// threads a lane over lanes in that order), or null for one warp a lane in
// lane order.
extern "C" int vkzg_scalar_mul(const void* pts, const void* sc, const void* order, void* out,
                               int64_t n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const uint32_t* p = (const uint32_t*)pts;
  const uint32_t* k = (const uint32_t*)sc;
  const int* o = (const int*)order;
  uint32_t* r = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (o) {
    constexpr int G = K5_MANY_GROUP, W = K5_MANY_WARPS, per_block = W * 32 / G;
    const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
    vkzg::scalar_mul_kernel<G, W><<<blocks, 32 * W, 0, st>>>(p, k, o, r, n);
  } else {
    constexpr int W = K5_FEW_WARPS;
    const unsigned blocks = (unsigned)((n + W - 1) / W);
    vkzg::scalar_mul_kernel<32, W><<<blocks, 32 * W, 0, st>>>(p, k, o, r, n);
  }
  return (int)cudaGetLastError();
}
