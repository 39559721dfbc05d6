// FBMSM: a single MSM over a basis whose fixed-base table is held on the
// card (ops/msm.py::build_table): for each row i of the basis, window
// w < W = 256 / C and multiple m in [1, 2^(C-1)], C = 8, the table holds
// T[i][w][m - 1] = m 2^(C w) P_i as affine Montgomery words. An MSM of
// standard scalars is then the sum of one signed table point per (point,
// window) digit: with the balanced signed digits d_iw of scalar k_i,
//     sum_i k_i P_i = sum_(i, w) sign(d_iw) T[i][w][|d_iw| - 1],
// digit 0 and the (0, 0) sentinel adding nothing. ops/cuda_msm_table.py
// has the wrapper and the plain version, which adds in this kernel's order.
//
// It replaces no TPU kernel. The JAX package runs every MSM as a
// variable-base bucket method (K3 + K4 here), whose tail is a dependent
// chain: Horner's c (W - 1) doublings and the window sums' weighting,
// about 1.1 ms a call on one warp whatever the work. The verkle IPA's
// basis (g_0..g_255 and q) is fixed for the life of its parameters, so the
// doublings can be paid once, at set-up, as Brickell, Gordon, McCurley and
// Wilson's fixed-base method does ("Fast exponentiation with
// precomputation", EUROCRYPT '92; go-ipa keeps such tables for the same
// CRS). Tabulating the digits' multiples as well removes the buckets and
// their weighting: no sort, no bucket, no window sum and no Horner.
//
// What bounds it: the work is N W lazy mixed adds (8,224 at N = 257,
// C = 8: about 90K Montgomery products, 1.4 us at the card's multiply
// rate), far below what the card does in the chain's time, so the chain
// sets the time: PER_GROUP mixed adds, then a tree of log2(GROUPS) adds in
// the block and, in the last block, ceil(blocks / GROUPS) - 1 adds and
// the same tree again over the blocks' partials. Every point operation
// runs on a group of G threads (warp_point.cuh: a level's independent
// products on separate threads, about 2 products of chain a point
// operation), so the chain is ~16 group operations at N = 257, C = 8.
//
// The schedule, one launch (one CUDA launch and a memset of the counter):
//  * group gi (G threads; GROUPS a block) takes scalar j = gi / SEGS and
//    windows [w0, w0 + PER_GROUP), w0 = (gi % SEGS) PER_GROUP, SEGS = W /
//    PER_GROUP. Its threads derive those windows' digits from the scalar
//    words with the carry rule of ops/msm.py::signed_carries (the sorted
//    digits kernel's), then 2 PER_GROUP of them gather the entries' x and y
//    (y negated for a negative digit; zeros for digit 0) into shared
//    memory, and the group adds them into its accumulator, from the
//    identity, with warp_mixed_add (lazy);
//  * the block's groups reduce in a tree over shared memory: at level h,
//    group g with g % 2h = 0 adds group g + h, where that group exists;
//  * group 0 writes the block's partial; the last block to finish (a
//    counter, zeroed for each call) sums the partials: group g takes
//    partials g, g + GROUPS, ..., then the same tree; group 0 reduces the
//    sum once and writes it. With one block, it writes its own sum.
//
// Scalar j's row is j below `prefix` and `extra` at j = prefix, so a call
// names its basis without an index array: g[:n] (prefix n) or g[:n] || q
// (prefix n, extra the row of q). Scalars are elements of Fr, below 2^255,
// so the top window's digit stays within the table's 2^(C-1) multiples.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_point.cuh"

// Inside vkzg, as warp_point.cuh's unnamed namespace is: two unnamed
// namespaces in reach make nvcc's kernel registration ambiguous.
namespace vkzg {
namespace {

// The table's window width, ops/cuda_msm_table.py's TABLE_C: the faster of
// the two widths whose digits lie in one scalar word and whose table is not
// absurd (c = 4 took 0.065 ms a call at 256 points, c = 8 0.056; PERF.md 6).
constexpr int C = 8;
constexpr int G = 8;                  // threads a group: one point operation
constexpr int GROUPS = 32;            // groups a block
constexpr int THREADS = G * GROUPS;   // 256
constexpr int PER_GROUP = 4;          // (scalar, window) entries a group adds
constexpr unsigned FULL = 0xffffffffu;

struct __align__(16) GroupSlots {
  WarpScratch s;
  uint32_t stage[PER_GROUP][16];  // the group's table points, y negated for a negative digit
};

constexpr int64_t blocks_of(int64_t n) { return (n * (256 / C / PER_GROUP) + GROUPS - 1) / GROUPS; }

// Windows [w0, w0 + PER_GROUP) of the balanced signed digits of scalar k:
// raw digit w is bits [w C, w C + C) (C divides 32, so inside one word);
// the carry into window w + 1 is raw_w > 2^(C-1), or raw_w == 2^(C-1) with
// a nonzero raw digit below w, none out of the top window (the sorted
// digits kernel's rule); d = raw + carry in - carry out << C.
__device__ __forceinline__ void window_digits(const uint32_t k[8], int w0, int d[PER_GROUP]) {
  constexpr int W = 256 / C, HALF = 1 << (C - 1), PER_WORD = 32 / C;
  constexpr uint32_t DMASK = (1u << C) - 1u;
  int cin = 0;
  bool nz = false;
  for (int w = 0; w < w0; ++w) {
    const int raw = (int)((pick_word(k, w / PER_WORD) >> ((w % PER_WORD) * C)) & DMASK);
    const int cout = raw > HALF || (raw == HALF && nz);  // w < w0 <= W - PER_GROUP: not the top
    nz = nz || raw != 0;
    cin = cout;
  }
#pragma unroll
  for (int e = 0; e < PER_GROUP; ++e) {
    const int w = w0 + e;
    const int raw = (int)((pick_word(k, w / PER_WORD) >> ((w % PER_WORD) * C)) & DMASK);
    const int cout = w < W - 1 && (raw > HALF || (raw == HALF && nz));
    d[e] = raw + cin - (cout << C);
    nz = nz || raw != 0;
    cin = cout;
  }
}

__device__ __forceinline__ void set_identity(uint32_t* acc) {
  Point p;
  set_infinity(p);
  store_point(acc, p);
}

// Group `grp` of the block adds group grp + h's accumulator into its own,
// for each level h, where `count` groups of the block hold a sum: a tree
// in shared memory, every warp in step (groups that take no add ride
// along with keep = false; a warp with none skips the level).
__device__ __forceinline__ void block_tree(GroupSlots* slots, int grp, int t, int64_t count) {
  for (int h = 1; h < GROUPS; h *= 2) {
    __syncthreads();
    const bool take = grp % (2 * h) == 0 && grp + h < count;
    if (take) {
      for (int k = t; k < 24; k += G) slots[grp].s.q[k] = slots[grp + h].s.acc[k];
    }
    if (__any_sync(FULL, take)) {
      __syncwarp();
      warp_add<true, G>(slots[grp].s, t, take);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) table_msm_kernel(
    const uint32_t* __restrict__ table, const uint32_t* __restrict__ sc, int64_t n, int64_t prefix,
    int64_t extra, uint32_t* partials, unsigned* counter, uint32_t* __restrict__ out) {
  constexpr int W = 256 / C, H = 1 << (C - 1), SEGS = W / PER_GROUP;
  __shared__ GroupSlots slots[GROUPS];
  __shared__ int last;
  const int t = threadIdx.x % G, grp = threadIdx.x / G;
  GroupSlots& g = slots[grp];
  const int64_t gi = (int64_t)blockIdx.x * GROUPS + grp;
  const int64_t ngroups = n * SEGS;
  const bool live = gi < ngroups;
  if (t == 0) set_identity(g.s.acc);

  // The group's digits and its gather: thread t < 2 PER_GROUP stages entry
  // t / 2's x (t even) or y (t odd).
  int d[PER_GROUP];
#pragma unroll
  for (int e = 0; e < PER_GROUP; ++e) d[e] = 0;
  int64_t row = 0;
  int w0 = 0;
  if (live) {
    const int64_t j = gi / SEGS;
    uint32_t k[8];
    load8(k, sc + 8 * j);
    w0 = (int)(gi % SEGS) * PER_GROUP;
    row = j < prefix ? j : extra;
    window_digits(k, w0, d);
  }
  if (t < 2 * PER_GROUP) {
    const int e = t >> 1;
    int de = 0;
#pragma unroll
    for (int i = 0; i < PER_GROUP; ++i) de = i == e ? d[i] : de;
    uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (de != 0) {
      const int m = de < 0 ? -de : de;
      load8(v, table + (((row * W) + w0 + e) * H + (m - 1)) * 16 + 8 * (t & 1));
      if ((t & 1) && de < 0) {
        const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        fsub<Fq, false>(v, zero, v);
      }
    }
    store8(g.stage[e] + 8 * (t & 1), v);
  }
  __syncwarp();
  for (int e = 0; e < PER_GROUP; ++e) {
    uint32_t any = 0;
    for (int k = 0; k < 16; ++k) any |= g.stage[e][k];
    for (int k = t; k < 16; k += G) g.s.q[k] = g.stage[e][k];
    __syncwarp();
    warp_mixed_add<G>(g.s, t, any != 0);  // digit 0 and the (0, 0) sentinel add nothing
  }

  block_tree(slots, grp, t, ngroups - (int64_t)blockIdx.x * GROUPS);
  if (gridDim.x > 1) {
    if (grp == 0) {
      for (int k = t; k < 24; k += G) partials[24 * (int64_t)blockIdx.x + k] = g.s.acc[k];
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counter, 1u) + 1 == gridDim.x;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // The last block: group grp sums partials grp, grp + GROUPS, ...
    const int64_t nb = gridDim.x;
    if (grp < nb) {
      for (int k = t; k < 24; k += G) g.s.acc[k] = __ldcg(partials + 24 * (int64_t)grp + k);
    } else if (t == 0) {
      set_identity(g.s.acc);
    }
    __syncwarp();
    for (int64_t r = 1; r * GROUPS < nb; ++r) {
      const int64_t idx = grp + r * GROUPS;
      const bool take = idx < nb;
      if (take) {
        for (int k = t; k < 24; k += G) g.s.q[k] = __ldcg(partials + 24 * idx + k);
      }
      if (__any_sync(FULL, take)) {
        __syncwarp();
        warp_add<true, G>(g.s, t, take);
      }
    }
    block_tree(slots, grp, t, nb);
  }
  if (grp == 0 && t == 0) {
    Point p;
    load_point(p, g.s.acc);
    reduce_point(p);
    store_point(out, p);
  }
}

}  // namespace
}  // namespace vkzg

using namespace vkzg;

// scalars (n, 8) standard, table (rows, 256 / C, 2^(C-1), 2, 8) affine
// Montgomery words, c the table's width (C, or the call is refused); scalar
// j's row is j below prefix, extra at j = prefix (n = prefix or prefix + 1).
// work: the counter (4 words) then the blocks' partials (blocks x 24 words);
// blocks must equal blocks_of(n). out (3, 8) reduced projective.
extern "C" int vkzg_msm_table(const void* table, const void* sc, int64_t n, int64_t prefix,
                              int64_t extra, int c, int64_t blocks, void* work, void* out,
                              void* stream) {
  if (n < 1 || prefix < 0 || (n != prefix && (n != prefix + 1 || extra < 0)) || c != C ||
      blocks != blocks_of(n)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* counter = (unsigned*)work;
  uint32_t* partials = (uint32_t*)work + 4;
  if (blocks > 1) {
    const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return (int)err;
  }
  table_msm_kernel<<<(unsigned)blocks, THREADS, 0, st>>>((const uint32_t*)table, (const uint32_t*)sc, n,
                                                         prefix, extra, partials, counter, (uint32_t*)out);
  return (int)cudaGetLastError();
}
