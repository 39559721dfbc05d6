// K1MP: the multiproof's weighted segment sums in one launch,
//   out[j] = sum over the positions k of segment j of w_k * rows[row_k],
// over Fr Montgomery words (rows (R, n, 8), out (segments, n, 8)).
//   mode 0, the grouped pass: w_k = r^e_k, r one element in `weights`;
//   mode 1, the h pass: w_k = weights[e_k]; with g, also out_minus = out - g
//   (one segment).
// See ops/cuda_multiproof.py for what it replaces and why it is shaped so.
//
// The host plans the work (plan, int32): the positions in segment order
// (row_k, e_k), the segments cut into chunks of at most CHUNK positions
// (segment, first position, length), and each segment's first chunk and
// chunk count. A unit is one chunk over one tile of TC columns; a block of
// THREADS threads holds S = THREADS / TC sub-lanes of a tile, sub-lane s
// takes positions s, s + S, ... of the chunk, and a tree over the sub-lanes
// sums them. A segment of one chunk is written at once; the chunks of a
// longer one leave partials, and the last block to finish one of its tiles
// (a ticket per segment and tile, the counters zeroed before the launch)
// sums them with the same sub-lanes and tree. So no thread runs a chain of
// more than CHUNK / S products, however the queries fall on the points.
//
// The powers of r come from tables that warp 0 of each block scans once:
// pw[l][d] = r^(d 32^l), 32 entries a level, an inclusive product scan over
// the warp's lanes (5 steps) a level; r^e is then one product a further
// digit of e. Every product and sum is reduced, and a reduced value is
// unique, so the words equal those of the plain version whatever the order.
#include <cuda_runtime.h>

#include "bn254_field.cuh"

using namespace vkzg;

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 32;   // positions of a chunk at most (the host plans so)
constexpr int DIGIT = 5;    // bits of an exponent a table level covers
constexpr int LEVELS = 7;   // exponents below 2^31
constexpr unsigned FULL = 0xffffffffu;

struct Plan {
  const int32_t* pos_row;
  const int32_t* pos_e;
  const int32_t* chunk_seg;
  const int32_t* chunk_start;
  const int32_t* chunk_len;
  const int32_t* seg_first;
  const int32_t* seg_count;
};

__device__ __forceinline__ void set_zero(uint32_t r[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = 0;
}

// load8 bypassing L1: the words another block wrote before its fence.
__device__ __forceinline__ void load8_cg(uint32_t r[8], const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 lo = __ldcg(q), hi = __ldcg(q + 1);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

// The sum over the S sub-lanes of each column's acc, left in sub-lane 0's
// acc: a tree of reduced adds in shared memory (word-major). Every thread
// of the block calls.
__device__ void lanes_sum(uint32_t acc[8], uint32_t (*sh)[THREADS], int sub, int tc, int lanes) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 8; ++j) sh[j][tid] = acc[j];
  __syncthreads();
  for (int stride = lanes / 2; stride > 0; stride >>= 1) {
    if (sub < stride) {
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = sh[j][tid + stride * tc];
      fadd<Fr, false>(acc, acc, o);
#pragma unroll
      for (int j = 0; j < 8; ++j) sh[j][tid] = acc[j];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void write_out(uint32_t* out, uint32_t* out_minus, const uint32_t* g,
                                          int64_t j, int64_t col, int64_t n, const uint32_t acc[8]) {
  store8(out + (j * n + col) * 8, acc);
  if (out_minus) {
    uint32_t t[8];
    load8(t, g + col * 8);
    fsub<Fr, false>(t, acc, t);
    store8(out_minus + col * 8, t);
  }
}

__global__ void __launch_bounds__(THREADS) segment_sum_kernel(
    const uint32_t* __restrict__ rows, const uint32_t* __restrict__ weights, Plan plan,
    uint32_t* __restrict__ partials, unsigned int* __restrict__ counters, uint32_t* __restrict__ out,
    uint32_t* __restrict__ out_minus, const uint32_t* __restrict__ g, int64_t n, int64_t chunks,
    int tc, int levels, int mode) {
  __shared__ uint32_t pw[LEVELS][8][32];
  __shared__ uint32_t wsh[8][CHUNK];
  __shared__ uint32_t sh[8][THREADS];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lanes = THREADS / tc, sub = tid / tc, col_l = tid % tc;
  const int64_t tiles = n / tc;

  if (mode == 0 && tid < 32) {  // the power tables, by warp 0
    uint32_t base[8];
    load8(base, weights);  // r^(32^l)
    for (int l = 0; l < levels; ++l) {
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = tid == 0 ? Fr::one(j) : base[j];
      for (int d = 1; d < 32; d <<= 1) {  // inclusive product scan of (1, b, b, ...): v = b^tid
        uint32_t o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = __shfl_up_sync(FULL, v[j], d);
        if (tid >= d) fmul<Fr, false>(v, v, o);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) pw[l][j][tid] = v[j];
      uint32_t top[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) top[j] = __shfl_sync(FULL, v[j], 31);
      fmul<Fr, false>(base, top, base);  // b^31 b = b^32
    }
  }
  __syncthreads();

  for (int64_t u = blockIdx.x; u < chunks * tiles; u += gridDim.x) {
    const int64_t c = u / tiles, tile = u % tiles, col = tile * tc + col_l;
    const int start = plan.chunk_start[c], len = plan.chunk_len[c];
    if (tid < len) {  // the chunk's weights, once each
      const int e = plan.pos_e[start + tid];
      uint32_t w[8];
      if (mode == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = pw[0][j][e & 31];
        for (int l = 1; l < levels; ++l) {
          const int d = (e >> (DIGIT * l)) & 31;
          if (d) {
            uint32_t t[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) t[j] = pw[l][j][d];
            fmul<Fr, false>(w, w, t);
          }
        }
      } else {
        load8(w, weights + 8 * (int64_t)e);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) wsh[j][tid] = w[j];
    }
    __syncthreads();
    uint32_t acc[8], d[8], w[8];
    set_zero(acc);
    for (int p = sub; p < len; p += lanes) {
      load8(d, rows + ((int64_t)plan.pos_row[start + p] * n + col) * 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = wsh[j][p];
      fmul<Fr, false>(d, w, d);
      fadd<Fr, false>(acc, acc, d);
    }
    lanes_sum(acc, sh, sub, tc, lanes);
    const int64_t j = plan.chunk_seg[c];
    const int cnt = plan.seg_count[j];
    if (cnt == 1) {
      if (sub == 0) write_out(out, out_minus, g, j, col, n, acc);
    } else {
      if (sub == 0) store8(partials + (c * n + col) * 8, acc);
      __threadfence();
      __syncthreads();
      if (tid == 0) last = atomicAdd(counters + j * tiles + tile, 1u) == (unsigned)cnt - 1;
      __syncthreads();
      if (last) {
        const int64_t first = plan.seg_first[j];
        set_zero(acc);
        for (int q = sub; q < cnt; q += lanes) {
          load8_cg(d, partials + ((first + q) * n + col) * 8);
          fadd<Fr, false>(acc, acc, d);
        }
        lanes_sum(acc, sh, sub, tc, lanes);
        if (sub == 0) write_out(out, out_minus, g, j, col, n, acc);
      }
    }
    __syncthreads();  // wsh, sh and last are written again by the next unit
  }
}

// The blocks the card holds at once, found once a device.
int grid_limit() {
  static int cached[64] = {0};
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < 64 && cached[dev] > 0) return cached[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segment_sum_kernel, THREADS, 0) != cudaSuccess)
    return 0;
  const int limit = sms * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < 64) cached[dev] = limit;
  return limit;
}

}  // namespace

// rows (R, n, 8); weights: r (8 words) in mode 0, (W, 8) in mode 1; plan
// int32: pos_row, pos_e (positions each), chunk_seg, chunk_start, chunk_len
// (chunks each), seg_first, seg_count (segments each); partials
// (chunks, n, 8) and counters (segments * n / tc words) when a segment has
// more than one chunk, else null; out (segments, n, 8); out_minus and g
// (n, 8) or null. n a power of two; tc = min(n, 32); levels: base-32
// digits of the largest exponent (mode 0). The grid is as many blocks as
// the card holds at once, at most one a unit; each walks units.
extern "C" int vkzg_mp_segment_sum(const void* rows, const void* weights, const void* plan,
                                   void* partials, void* counters, void* out, void* out_minus,
                                   const void* g, int64_t positions, int64_t chunks,
                                   int64_t segments, int64_t n, int levels, int mode,
                                   void* stream) {
  if (positions < 1 || chunks < 1 || segments < 1 || n < 1 || (n & (n - 1)) ||
      levels < 1 || levels > LEVELS || (mode != 0 && mode != 1) || (out_minus && segments != 1))
    return (int)cudaErrorInvalidValue;
  const int tc = n < 32 ? (int)n : 32;
  const int64_t units = chunks * (n / tc);
  const int limit = grid_limit();
  if (limit < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (counters) {
    const cudaError_t e = cudaMemsetAsync(counters, 0, segments * (n / tc) * sizeof(unsigned int), s);
    if (e != cudaSuccess) return (int)e;
  }
  const int32_t* p = (const int32_t*)plan;
  Plan pl;
  pl.pos_row = p;
  pl.pos_e = p + positions;
  pl.chunk_seg = p + 2 * positions;
  pl.chunk_start = pl.chunk_seg + chunks;
  pl.chunk_len = pl.chunk_start + chunks;
  pl.seg_first = pl.chunk_len + chunks;
  pl.seg_count = pl.seg_first + segments;
  const unsigned grid = (unsigned)(units < limit ? units : limit);
  segment_sum_kernel<<<grid, THREADS, 0, s>>>(
      (const uint32_t*)rows, (const uint32_t*)weights, pl, (uint32_t*)partials,
      (unsigned int*)counters, (uint32_t*)out, (uint32_t*)out_minus, (const uint32_t*)g, n, chunks,
      tc, levels, mode);
  return (int)cudaGetLastError();
}
