// K1QUO: the in-domain quotient q = (f - f_z) / (X - w^z) of rows of Fr
// Montgomery words, with the correction at i = z, in one launch; with
// sum_rows, the field sum of the quotient rows (the multiproof's g). See
// ops/cuda_multiproof.py for what it replaces and why it is shaped so.
//
// No inversion runs: with the domain's omegas w^k and its table
// T[k] = 1 / (w^k - 1) (T[0] = 0),
//   1 / (w^i - w^z)   = w^-z T[(i - z) mod N]   (0 at i = z),
//   A'(w^z) / A'(w^i) = w^(i - z),
// since A'(w^i) = N w^-i. Every product and sum is reduced, and a reduced
// value is unique, so the words equal those of the plain version and of the
// JAX package whatever the order of the sums.
#include <cuda_runtime.h>

#include "bn254_field.cuh"

using namespace vkzg;

namespace {

constexpr int THREADS = 256;

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

// The modular sum of every thread's s, readable by all threads in sh[.][0]
// on return: a tree of reduced adds in shared memory (word-major, so the
// threads of a warp hit distinct banks). Every thread of the block calls.
__device__ void block_sum(uint32_t s[8], uint32_t (*sh)[THREADS]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 8; ++j) sh[j][tid] = s[j];
  __syncthreads();
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = sh[j][tid + stride];
      fadd<Fr, false>(s, s, o);
#pragma unroll
      for (int j = 0; j < 8; ++j) sh[j][tid] = s[j];
    }
    __syncthreads();
  }
}

// Block b takes rows b, b + gridDim.x, ...; thread t the elements t,
// t + THREADS, ... of a row, so the thread that owns column z also writes
// the correction there. Per row: f_z and w^-z once, then three products an
// element (the inverse difference, q, and q by the ratio for the
// correction), and one block-wide sum.
//
// Per-row mode (sum_rows = 0): q goes to out (rows, n, 8).
// sum_rows: each block adds its rows into acc, its own (n, 8) slice of
// partials (out itself when the grid is one block); the last block to
// finish, by a ticket on *counter (zeroed before the launch), adds the
// slices into out (n, 8).
__global__ void __launch_bounds__(THREADS) quotient_kernel(
    const uint32_t* __restrict__ vals, const int32_t* __restrict__ zs,
    const uint32_t* __restrict__ omegas, const uint32_t* __restrict__ table,
    uint32_t* __restrict__ out, uint32_t* __restrict__ partials, unsigned int* __restrict__ counter,
    int64_t rows, int64_t n, int sum_rows) {
  __shared__ uint32_t sh[8][THREADS];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int64_t mask = n - 1;
  uint32_t* acc = nullptr;
  if (sum_rows) acc = gridDim.x == 1 ? out : partials + (int64_t)blockIdx.x * n * 8;
  bool first = true;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int64_t z = zs[r];
    const uint32_t* f = vals + r * n * 8;
    uint32_t fz[8], wz[8], corr[8], t[8];
    load8(fz, f + 8 * z);
    load8(wz, omegas + 8 * ((n - z) & mask));  // w^-z
    set_zero(corr);
    for (int64_t i = tid; i < n; i += THREADS) {
      const int64_t k = (i - z) & mask;
      uint32_t q[8];
      load8(q, f + 8 * i);
      fsub<Fr, false>(q, q, fz);
      load8(t, table + 8 * k);
      fmul<Fr, false>(t, wz, t);  // 1 / (w^i - w^z), 0 at i = z
      fmul<Fr, false>(q, q, t);
      load8(t, omegas + 8 * k);  // A'(w^z) / A'(w^i)
      fmul<Fr, false>(t, q, t);
      fadd<Fr, false>(corr, corr, t);
      if (!sum_rows) {
        store8(out + (r * n + i) * 8, q);
      } else if (first) {
        store8(acc + 8 * i, q);
      } else {
        load8(t, acc + 8 * i);
        fadd<Fr, false>(t, t, q);
        store8(acc + 8 * i, t);
      }
    }
    block_sum(corr, sh);
    if (tid == (int)(z % THREADS)) {  // q_z = 0 was written above: the correction replaces it
      uint32_t s[8], zero[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = sh[j][0];
      set_zero(zero);
      fsub<Fr, false>(s, zero, s);  // q_z = -sum_i q_i A'(w^z) / A'(w^i)
      if (!sum_rows) {
        store8(out + (r * n + z) * 8, s);
      } else {
        load8(t, acc + 8 * z);
        fadd<Fr, false>(t, t, s);
        store8(acc + 8 * z, t);
      }
    }
    __syncthreads();  // sh is written again by the next row
    first = false;
  }
  if (!sum_rows || gridDim.x == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  for (int64_t i = tid; i < n; i += THREADS) {
    uint32_t s[8], t[8];
    load8_cg(s, partials + 8 * i);
    for (unsigned b = 1; b < gridDim.x; ++b) {
      load8_cg(t, partials + ((int64_t)b * n + i) * 8);
      fadd<Fr, false>(s, s, t);
    }
    store8(out + 8 * i, s);
  }
}

}  // namespace

// vals (rows, n, 8), zs (rows,) int32 in [0, n), omegas and table (n, 8),
// n a power of two. sum_rows = 0: out (rows, n, 8), one block a row.
// sum_rows = 1: out (n, 8), `blocks` blocks, partials (blocks, n, 8) and
// one counter word when blocks > 1.
extern "C" int vkzg_quotient(const void* vals, const void* zs, const void* omegas, const void* table,
                             void* out, void* partials, void* counter, int64_t rows, int64_t n,
                             int sum_rows, int64_t blocks, void* stream) {
  if (rows < 1 || n < 1 || (n & (n - 1)) || rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (sum_rows && (blocks < 1 || blocks > rows || (blocks > 1 && (!partials || !counter))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(sum_rows ? blocks : rows);
  if (sum_rows && grid > 1) {
    const cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(unsigned int), s);
    if (e != cudaSuccess) return (int)e;
  }
  quotient_kernel<<<grid, THREADS, 0, s>>>((const uint32_t*)vals, (const int32_t*)zs,
                                           (const uint32_t*)omegas, (const uint32_t*)table,
                                           (uint32_t*)out, (uint32_t*)partials,
                                           (unsigned int*)counter, rows, n, sum_rows);
  return (int)cudaGetLastError();
}
