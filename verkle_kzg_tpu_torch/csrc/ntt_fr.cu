// K1NTT: the radix-2 Fr NTT (or INTT) of B contiguous segments of 2^log_seg
// Montgomery elements, decimation in time. See ops/cuda_ntt.py for what it
// replaces and why it is shaped so.
//
// A tile of up to 2^log_tile elements a block in shared memory (dynamic,
// 32 bytes an element): the load gathers the segment's bit reversal, the
// first log_tile stages run there with __syncthreads() between them (their
// butterfly blocks never cross a tile), and the store writes the tile in
// place of its positions. A segment above the tile then takes one launch a
// remaining stage over device memory, a thread a butterfly, in place. The
// inverse's 1/seg product is taken at the last stage's store.
//
// Each butterfly is the plain version's (u + w v, u - w v) with reduced
// Montgomery products, sums and differences, and the twiddle of stage s,
// pair k, is w_seg^(k seg / 2^(s+1)), the value the plain version's plan
// gives it, so the words are the plain version's.
#include <cuda_runtime.h>

#include "bn254_field.cuh"

using namespace vkzg;

namespace {

constexpr int MAX_LOG_TILE = 12;  // 4,096 elements, 128 KB of shared memory
constexpr int THREADS = 256;

// (u, v) <- (u + w v, u - w v), reduced.
__device__ __forceinline__ void butterfly(uint32_t u[8], uint32_t v[8], const uint32_t w[8]) {
  uint32_t t[8], a[8];
  fmul<Fr, false>(t, v, w);
  fadd<Fr, false>(a, u, t);
  fsub<Fr, false>(v, u, t);
#pragma unroll
  for (int j = 0; j < 8; ++j) u[j] = a[j];
}

// One block a tile of 2^log_tile positions of the bit-reversed order: the
// gather, `stages` stages in shared memory, the store (times tw[seg / 2],
// 1/seg, when `scale`). tw holds w_seg^k for k < seg / 2, then 1/seg.
__global__ void __launch_bounds__(THREADS) ntt_tile_kernel(const uint32_t* __restrict__ x,
                                                           uint32_t* __restrict__ out,
                                                           const uint32_t* __restrict__ tw,
                                                           int log_seg, int log_tile, int scale) {
  extern __shared__ __align__(16) uint32_t sh[];
  const int tile = 1 << log_tile;
  const int64_t seg = 1LL << log_seg;
  const int64_t base = (int64_t)blockIdx.x * tile;
  const int64_t seg_base = base & ~(seg - 1);
  const uint32_t off = (uint32_t)(base - seg_base);
  uint32_t u[8], v[8], w[8];
  for (int q = threadIdx.x; q < tile; q += blockDim.x) {
    const uint32_t src = __brev(off + (uint32_t)q) >> (32 - log_seg);
    load8(u, x + 8 * (seg_base + src));
    store8(sh + 8 * q, u);
  }
  __syncthreads();
  for (int s = 0; s < log_tile; ++s) {
    const int half = 1 << s;
    const int step = log_seg - s - 1;  // twiddle index k seg / 2^(s+1)
    for (int j = threadIdx.x; j < tile / 2; j += blockDim.x) {
      const int k = j & (half - 1);
      const int a = ((j >> s) << (s + 1)) + k;
      load8(u, sh + 8 * a);
      load8(v, sh + 8 * (a + half));
      load8(w, tw + 8 * ((int64_t)k << step));
      butterfly(u, v, w);
      store8(sh + 8 * a, u);
      store8(sh + 8 * (a + half), v);
    }
    __syncthreads();
  }
  if (scale) load8(w, tw + 8 * (seg / 2));
  for (int q = threadIdx.x; q < tile; q += blockDim.x) {
    load8(u, sh + 8 * q);
    if (scale) fmul<Fr, false>(u, u, w);
    store8(out + 8 * (base + q), u);
  }
}

// Stage s of every segment over device memory, in place, a thread a pair.
__global__ void __launch_bounds__(THREADS) ntt_stage_kernel(uint32_t* __restrict__ x,
                                                            const uint32_t* __restrict__ tw,
                                                            int64_t pairs, int log_seg, int s,
                                                            int scale) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= pairs) return;
  const int64_t half = 1LL << s;
  const int64_t k = j & (half - 1);
  const int64_t a = ((j >> s) << (s + 1)) + k;
  uint32_t u[8], v[8], w[8];
  load8(u, x + 8 * a);
  load8(v, x + 8 * (a + half));
  load8(w, tw + 8 * (k << (log_seg - s - 1)));
  butterfly(u, v, w);
  if (scale) {
    load8(w, tw + 8 * ((1LL << log_seg) / 2));
    fmul<Fr, false>(u, u, w);
    fmul<Fr, false>(v, v, w);
  }
  store8(x + 8 * a, u);
  store8(x + 8 * (a + half), v);
}

}  // namespace

// x, out: (total, 8) Montgomery words, total a multiple of 2^log_seg, x and
// out distinct; tw: (2^(log_seg - 1) + 1, 8). log_tile: the stages a block
// runs in shared memory, at most log_seg and MAX_LOG_TILE. The launches it
// issues, 1 + log_seg - log_tile, go to *launches.
extern "C" int vkzg_ntt_fr(const void* x, void* out, const void* tw, int64_t total, int log_seg,
                           int log_tile, int inverse, void* stream, int64_t* launches) {
  *launches = 0;
  if (log_seg < 1 || log_seg > 30 || log_tile < 1 || log_tile > log_seg || log_tile > MAX_LOG_TILE ||
      total < 1 || (total & ((1LL << log_seg) - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tile = 1 << log_tile;
  const size_t smem = (size_t)tile * 32;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(ntt_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t tiles = total / tile;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int threads = tile / 2 < 32 ? 32 : (tile / 2 > THREADS ? THREADS : tile / 2);
  ntt_tile_kernel<<<(unsigned)tiles, threads, smem, st>>>(
      (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, log_seg, log_tile,
      inverse && log_tile == log_seg);
  ++*launches;
  cudaError_t e = cudaGetLastError();
  const int64_t pairs = total / 2;
  for (int s = log_tile; s < log_seg && e == cudaSuccess; ++s) {
    ntt_stage_kernel<<<(unsigned)((pairs + THREADS - 1) / THREADS), THREADS, 0, st>>>(
        (uint32_t*)out, (const uint32_t*)tw, pairs, log_seg, s, inverse && s == log_seg - 1);
    ++*launches;
    e = cudaGetLastError();
  }
  return (int)e;
}
