// K2, K11, K12: element-wise complete projective group law, reduced words
// out: K2 adds (RCB16 algorithm 7), K11 doubles (algorithm 9), K12 adds an
// affine point (algorithm 8, the (0, 0) sentinel selecting p). Each runs
// one point a thread or a group of 4, 8 or 32 threads a point (the warp
// point operations of warp_point.cuh), as the wrapper's regime asks: K2
// and K11 in the reduced domain, K12 in the lazy one reduced once at the
// end (every lazy intermediate lies below 2m and is congruent to the
// reduced one, so the words are the same). K2FOLD sums rows of points by
// K2's halving tree in one launch. See ops/cuda_curve.py.
//
// A few points are bound by one point's chain of dependent products (12
// for the add, 11 for the mixed add, 8 for the doubling, ~0.68 us each on
// one thread): a group spreads each level's independent products over its
// threads, so the chain is 2 products and the sums between them. Many
// points are bound by the products' throughput, which one point a thread
// spends best (tools/point_regimes.py; numbers in ops/cuda_curve.py and
// PERF.md).
#include <cuda_runtime.h>

#include "warp_point.cuh"

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

// Inside vkzg, as warp_point.cuh's unnamed namespace is (scalar_mul.cu).
namespace vkzg {
namespace {

// The operation a point_group_kernel runs.
constexpr int OP_DOUBLE = 0, OP_ADD = 1, OP_MIXED = 2;

// K11 (OP_DOUBLE), K2 (OP_ADD) or K12 (OP_MIXED) with G threads a point (G = 4, 8
// or 32), 128 threads a block: a group loads its point and its addend
// (projective, or the affine x, y into q[0..15]) into its WarpScratch and
// runs warp_double / warp_add in the reduced domain, or warp_mixed_add in
// the lazy one, whose keep flag is false on the (0, 0) sentinel; threads
// 0-2 then reduce a coordinate each once, where the add ran, and store it.
// Every thread of a warp takes each __syncwarp, so a warp whose first
// point is past n returns whole, and a group of a live warp past n runs on
// the last point and stores nothing.
template <int OP, int G>
__global__ void __launch_bounds__(128) point_group_kernel(const uint32_t* __restrict__ p,
                                                          const uint32_t* __restrict__ q,
                                                          uint32_t* __restrict__ out, int64_t n) {
  constexpr int PER_BLOCK = 128 / G;
  __shared__ WarpScratch scratch[PER_BLOCK];
  const int slot = threadIdx.x / G, t = threadIdx.x % G;
  const int64_t first = (int64_t)blockIdx.x * PER_BLOCK;
  if (first + (threadIdx.x / 32) * (32 / G) >= n) return;
  const int64_t g = first + slot;
  const int64_t i = g < n ? g : n - 1;
  WarpScratch& s = scratch[slot];
  uint4* acc = reinterpret_cast<uint4*>(s.acc);
  const uint4* src = reinterpret_cast<const uint4*>(p + 24 * i);
  for (int j = t; j < 6; j += G) acc[j] = src[j];
  bool keep = true;
  if constexpr (OP == OP_MIXED) {
    uint4* dq = reinterpret_cast<uint4*>(s.q);
    const uint4* srq = reinterpret_cast<const uint4*>(q + 16 * i);
    for (int j = t; j < 4; j += G) dq[j] = srq[j];
    __syncwarp();
    keep = !(is_zero(s.q) && is_zero(s.q + 8));
    warp_mixed_add<G>(s, t, keep);
  } else if constexpr (OP == OP_ADD) {
    uint4* dq = reinterpret_cast<uint4*>(s.q);
    const uint4* srq = reinterpret_cast<const uint4*>(q + 24 * i);
    for (int j = t; j < 6; j += G) dq[j] = srq[j];
    __syncwarp();
    warp_add<false, G>(s, t);
  } else {
    __syncwarp();
    warp_double<false>(s, t);
  }
  if (g >= n) return;
  if constexpr (OP == OP_MIXED) {
    if (t < 3) {
      uint32_t a[8];
      load8(a, s.acc + 8 * t);
      if (keep) cond_sub<Fq, false>(a);
      store8(out + 24 * g + 8 * t, a);
    }
  } else {
    uint4* dst = reinterpret_cast<uint4*>(out + 24 * g);
    for (int j = t; j < 6; j += G) dst[j] = acc[j];
  }
}

}  // namespace
}  // namespace vkzg

// K12 one point a thread: the sorted sums' body (msm_sorted.cu), lazy,
// reduced once; a (0, 0) sentinel lane stores p as it was.
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
  if (!(is_zero(ax) && is_zero(ay))) {
    point_mixed_add<true>(a, ax, ay);
    reduce_point(a);
  }
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

// K2 (OP_ADD), K11 (OP_DOUBLE) or K12 (OP_MIXED) over n points with `group`
// threads a point: 1 (one point a thread) or 4, 8, 32 (point_group_kernel);
// any other is refused.
template <int OP>
static int point_op(const void* p, const void* q, void* out, int64_t n, int group, void* stream) {
  const uint32_t* a = (const uint32_t*)p;
  const uint32_t* b = (const uint32_t*)q;
  uint32_t* o = (uint32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 1:
      if constexpr (OP == vkzg::OP_ADD) {
        point_add_kernel<<<blocks_for(n, 128), 128, 0, st>>>(a, b, o, n);
      } else if constexpr (OP == vkzg::OP_MIXED) {
        point_mixed_add_kernel<<<blocks_for(n, 128), 128, 0, st>>>(a, b, o, n);
      } else {
        point_double_kernel<<<blocks_for(n, 128), 128, 0, st>>>(a, o, n);
      }
      break;
    case 4:
      vkzg::point_group_kernel<OP, 4><<<blocks_for(n, 32), 128, 0, st>>>(a, b, o, n);
      break;
    case 8:
      vkzg::point_group_kernel<OP, 8><<<blocks_for(n, 16), 128, 0, st>>>(a, b, o, n);
      break;
    case 32:
      vkzg::point_group_kernel<OP, 32><<<blocks_for(n, 4), 128, 0, st>>>(a, b, o, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int vkzg_point_add(const void* p, const void* q, void* out, int64_t n, int group,
                              void* stream) {
  return point_op<vkzg::OP_ADD>(p, q, out, n, group, stream);
}

extern "C" int vkzg_point_double(const void* p, void* out, int64_t n, int group, void* stream) {
  return point_op<vkzg::OP_DOUBLE>(p, nullptr, out, n, group, stream);
}

extern "C" int vkzg_point_mixed_add(const void* p, const void* q_aff, void* out, int64_t n, int group,
                                    void* stream) {
  return point_op<vkzg::OP_MIXED>(p, q_aff, out, n, group, stream);
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
