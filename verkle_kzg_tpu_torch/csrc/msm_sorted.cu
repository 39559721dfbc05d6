// K3, K9, K8, K10, K6 and K13: every bucket accumulation of the MSMs, as
// one bucket-sorted Pippenger fed by two digit sources. It replaces the TPU
// kernels of verkle_kzg_tpu/ops/pallas_msm.py launched at line 700
// (_accum_kernel_sc_signed_pair: signed digits from the scalar words, c in
// {1, 2, 4, 8}, K3), at line 719 (_accum_kernel_sc_signed: the same at
// c = 16, K9), at line 330 (_accum_kernel_sc: unsigned digits from the
// scalar words, c in {1, 2, 4, 8, 16}, K8), and the three that took a digit
// tensor: line 883 (_accum_kernel, more than 128 rows a window, K10), line
// 853 (_accum_kernel_pair, up to 128 rows, K6) and line 807
// (_accum_kernel_group, the window-grouped lane streams, K13). The TPU chose
// among those three by VMEM table size; here they are one kernel over any
// c in [1, 16] and any layout of the digit tensor. For each of B point
// streams ("lanes", lane b's points at steps s < S), window w and row i,
// bucket (w, b, i) is the sum of the lane's points whose window-w digit is
// +-(i + 1), y negated for a negative digit; digit 0 and the (0, 0)
// sentinel add nothing. A window has 2^(c-1) rows for balanced signed
// digits and 2^c - 1 for unsigned ones, W = ceil(256 / c) windows. Output
// (W, B, rows, 3, 8) projective, reduced, the identity in empty rows.
// ops/cuda_msm_sorted.py has the wrapper and the plain version, which
// follows these kernels' order of additions step for step.
//
// What bounds it: 11 Montgomery products a live entry (the lazy mixed add),
// 264 32-bit multiplies each, against 132 SMs x 64 multiplies a clock x 1.98
// GHz: 5.8 ms at 2^20 points and c = 8; the 64-byte point gathers (about
// 2.1 GB at that size, 0.7 ms) and the sort's key/value traffic are a few
// percent of it. On the card the sums take about 2.6x that bound whatever
// their occupancy, chunk count or prefetch (tools/sorted_variants.py). A
// hypothesis, not measured (no profiler reading of the pipes was taken):
// the product's ~500 integer instructions, not its 264 multiplies, set
// the pace. The TPU has no scatter, so its kernels kept each lane's
// bucket column in VMEM and ran every step as a masked gather and scatter of
// the whole table. The H100 scatters freely, so the entries are sorted by
// bucket instead: no per-thread tables, every mixed add accumulates in
// registers, and each thread walks an equal share of the entries whatever
// the key skew or the window's rows (65,535 unsigned at c = 16). The
// stages, each a kernel (several launches in all; no library kernel):
//
//  1. digits: from the scalar words, one thread a scalar extracts its W raw
//     digits (C divides 16) and, signed, balances them in registers with
//     the carry rule of ops/msm.py::signed_carries (or reads the caller's
//     carry words); unsigned, the raw digit is the digit. From a digit
//     tensor, one thread a (lane, step) reads its W digits as given, at
//     the strides the caller's layout has (a (W, B, S) tensor, or a lane
//     stream's (W, S, B) read in place), and its point at a lane stride
//     (0 for a basis every lane shares: it is never copied per lane) and a
//     step stride. Each (window, lane, step) gets key = (window, lane,
//     |d| - 1), or -1 when dead, and value = the point's index in the
//     point array with the sign in bit 31, dense in (window, lane, step)
//     order; a block counts its tile's keys by bin for the sort.
//  2. sort: a stable counting sort of each (window, lane) segment by the
//     row, over tiles of points: per-tile histograms, an exclusive scan over
//     (segment, bin, tile), and a scatter that ranks equal bins within a
//     tile by warp (__match_any_sync) and per-warp counts in shared memory,
//     stages the tile in bin order there and writes each bin's run whole.
//     LSD passes of at most 8 bits of the row (the key less its segment's
//     first key, so unsigned windows of 2^c - 1 rows bin as signed ones):
//     one pass up to 256 rows, two above (c >= 10 signed, c >= 9
//     unsigned; 8 + 8 bits at c = 16 unsigned), the second over the
//     first's segments. Each bucket's entries then come in ascending step
//     order: deterministic.
//  3. sums: the E sorted entries are cut into chunks of L = chunk_len(E)
//     (at most `target` chunks). A thread walks its chunk with the
//     accumulator in registers, from the identity, one lazy mixed add an
//     entry, and ends a run at each key change: a run inside the chunk is
//     its whole bucket, reduced and written to it; the chunk's first run,
//     if its bucket began in an earlier chunk, and its last run, if its
//     bucket goes on into the next, are partials.
//  4. combine: the partials of a bucket that spans chunks k0..k1 (the open
//     one of k0, then the first runs of k0 + 1..k1) are added in a binary
//     tree over their index, node = left + right, a lone left node passing
//     up unchanged: log depth, so a bucket holding every point (equal
//     scalars, or the small values of a verkle tree) costs log2 of its
//     chunks. A thread a partial climbs the tree; the second thread to
//     reach a node adds it (per-node arrival counts) and the root's thread
//     reduces it and writes the bucket.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_curve.cuh"

using namespace vkzg;

namespace {

constexpr int THREADS = 256;      // the digit, sort and scan kernels' blocks
constexpr int WARPS = THREADS / 32;
constexpr int SUM_THREADS = 128;  // the sums and combine kernels' blocks
constexpr int MAX_COUNTS = 8192;  // the digit kernels' histogram: windows x bins (32 KB of shared memory)
constexpr int FILL_BLOCKS = 264;  // the digit kernels' blocks at least: 2 an SM fill the buckets
constexpr int MAX_TILE = 2048;    // points a sort tile at most: its entries are staged in shared memory
constexpr int SCAN_ITEMS = 16;
constexpr int SCAN_PIECE = THREADS * SCAN_ITEMS;
constexpr int64_t SCAN_ONE = 4 * SCAN_PIECE;  // one block scans arrays up to this
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int bit_len(int x) { return x ? 1 + bit_len(x >> 1) : 0; }
__host__ __device__ constexpr int rows_of(int c, bool sgn) { return sgn ? 1 << (c - 1) : (1 << c) - 1; }
__host__ __device__ constexpr int row_bits(int c, bool sgn) { return bit_len(rows_of(c, sgn) - 1); }
// Bins of the first sort pass: the row's low 8 bits (all of them up to 256
// rows); the second pass, where there is one, takes the bits above them.
__host__ __device__ constexpr int first_bins(int c, bool sgn) {
  return 1 << (row_bits(c, sgn) < 8 ? row_bits(c, sgn) : 8);
}
__host__ __device__ constexpr int second_bins(int c, bool sgn) {
  return row_bits(c, sgn) > 8 ? 1 << (row_bits(c, sgn) - 8) : 0;
}

int64_t round4(int64_t words) { return (words + 3) & ~int64_t(3); }

// The sizes of one call over windows [w0, w0 + wg), and where each array
// lies in the int32 workspace (offsets in words, each a multiple of 4).
// from_words: the digits come from the scalar words (c must divide 16),
// else from a digit tensor.
struct Plan {
  int c = 0, wg = 0, tile = 0, target = 0, nwin = 0, rows = 0, bins_a = 0, bins_b = 0;
  bool sgn = true;
  int64_t n = 0, lanes = 0, lane_len = 0, tps = 0, hist_a = 0, hist_b = 0;
  int64_t counters = 0, partials = 0, firsts = 0, keys[3] = {0, 0, 0}, vals[3] = {0, 0, 0};
  int64_t h_a = 0, o_a = 0, p_a = 0, h_b = 0, o_b = 0, p_b = 0, words = 0;
  bool ok = false;

  static int64_t scan_parts(int64_t h) { return h <= SCAN_ONE ? 0 : (h + SCAN_PIECE - 1) / SCAN_PIECE; }

  Plan(int64_t npoints, int64_t nlanes, int c_, bool sgn_, bool from_words, int wg_, int target_)
      : c(c_), wg(wg_), target(target_), sgn(sgn_), n(npoints), lanes(nlanes) {
    if (c < 1 || c > 16 || (from_words && 16 % c)) return;
    nwin = (256 + c - 1) / c;
    rows = rows_of(c, sgn);
    bins_a = first_bins(c, sgn);
    bins_b = second_bins(c, sgn);
    if (n < 1 || lanes < 1 || n % lanes || wg < 1 || wg > nwin || target < 1) return;
    if (n >= (int64_t(1) << 31) || (int64_t)wg * n >= (int64_t(1) << 31)) return;
    if ((int64_t)wg * lanes * rows >= (int64_t(1) << 31)) return;
    if (wg * bins_a > MAX_COUNTS) return;
    lane_len = n / lanes;
    // Points a sort tile: about 64 tiles a lane, 256 to MAX_TILE.
    int64_t want = (lane_len + 63) / 64;
    tile = 256;
    while (tile < want && tile < MAX_TILE) tile *= 2;
    tps = (lane_len + tile - 1) / tile;
    hist_a = (int64_t)wg * lanes * bins_a * tps;
    hist_b = (int64_t)wg * lanes * bins_b * tps;
    int64_t at = 0;
    counters = at, at += round4(4 * (int64_t)target);  // 2 uint64 a chunk
    partials = at, at += round4(48 * (int64_t)target);  // 2 points a chunk
    firsts = at, at += round4(target);                  // a chunk's first key
    const int npairs = bins_b ? 3 : 2;
    for (int i = 0; i < npairs; ++i) {
      keys[i] = at, at += round4((int64_t)wg * n);
      vals[i] = at, at += round4((int64_t)wg * n);
    }
    h_a = at, at += round4(hist_a);
    o_a = at, at += round4(hist_a + 1);
    p_a = at, at += round4(scan_parts(hist_a) + 1);
    if (bins_b) {
      h_b = at, at += round4(hist_b);
      o_b = at, at += round4(hist_b + 1);
      p_b = at, at += round4(scan_parts(hist_b) + 1);
    }
    words = at;
    ok = true;
  }
};

// ---------------------------------------------------------------------------
// Stage 1: digits, keys and the first pass's tile histograms.
// ---------------------------------------------------------------------------

// What the two digit kernels share. Every block zeroes its counts and,
// with FILL_BLOCKS at least in the grid, fills this window group's bucket
// rows with the identity (50-100 MB at c = 16); the sums and the combine
// overwrite the rows with points. Returns false to a block that only fills.
__device__ bool digits_begin(int* cnt, int ncnt, uint32_t* buckets, int64_t fill, int64_t tiles) {
  for (int i = threadIdx.x; i < ncnt; i += THREADS) cnt[i] = 0;
  for (int64_t r = (int64_t)blockIdx.x * THREADS + threadIdx.x; r < fill;
       r += (int64_t)gridDim.x * THREADS) {
    Point inf;
    set_infinity(inf);
    store_point(buckets + 24 * r, inf);
  }
  __syncthreads();
  return blockIdx.x < tiles;
}

// Entry (wl, p) of segment seg = wl * lanes + b with digit d, p the dense
// (lane, step) index and at the index of its point: its key and value, and
// its count in the block's histogram of (window, bin). Every lane of the
// warp calls it together; `in` is false past the tile's end.
__device__ __forceinline__ void put_entry(int32_t* __restrict__ keys, int32_t* __restrict__ vals,
                                          int* cnt, int64_t n, int64_t p, int64_t at, bool in, bool live,
                                          int d, int wl, int64_t seg, int rows, int bins) {
  const bool on = live && d != 0;
  const int row = (d < 0 ? -d : d) - 1;
  if (in) {
    keys[wl * n + p] = on ? (int32_t)(seg * rows + row) : -1;
    vals[wl * n + p] = (int32_t)((uint32_t)at | (d < 0 ? 0x80000000u : 0u));
  }
  const int slot = on ? wl * bins + (row & (bins - 1)) : -1;
  const unsigned peers = __match_any_sync(FULL, slot);
  if (on && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&cnt[slot], __popc(peers));
}

// The block's counts into the first pass's tile histograms.
__device__ void digits_end(const int* cnt, int wg, int bins, int nlanes, int64_t b, int64_t t,
                           int64_t tps, int32_t* __restrict__ hist) {
  __syncthreads();
  for (int i = threadIdx.x; i < wg * bins; i += THREADS) {
    const int64_t seg = (int64_t)(i / bins) * nlanes + b;
    hist[(seg * bins + i % bins) * tps + t] = cnt[i];
  }
}

// Digits from the scalar words. Block (b, t) takes points [b S + t tile,
// ...) of lane b, 256 at a time. Window w's raw digit is bits [w C, w C + C)
// of the scalar (C divides 16, so inside one word). Unsigned (K8), the raw
// digit is the digit. Signed (K3, K9), without carry words, the carry into
// window w + 1 is raw_w > 2^(C-1), or raw_w == 2^(C-1) with a nonzero raw
// digit below w (a scalar mod 2^(C(w+1)) above half of 2^(C(w+1)), ties down
// when the bits below are zero), none out of the top window; with them, bit
// w and bit w + 1 of the caller's words are the carries in and out.
// d = raw + carry in - carry out << C.
template <int C, bool SGN>
__global__ void __launch_bounds__(THREADS) sorted_digits_kernel(
    const uint32_t* __restrict__ pts, const uint32_t* __restrict__ sc,
    const uint32_t* __restrict__ masks, int32_t* __restrict__ keys, int32_t* __restrict__ vals,
    int32_t* __restrict__ hist, uint32_t* __restrict__ buckets, int64_t lane_len, int nlanes,
    int w0, int wg, int tile, int64_t tps) {
  constexpr int W = 256 / C, ROWS = rows_of(C, SGN), BINS = first_bins(C, SGN), HALF = 1 << (C - 1);
  constexpr int PER_WORD = 32 / C, NWORDS = W / 32 + 1;
  constexpr uint32_t DMASK = (1u << C) - 1u;
  __shared__ int cnt[MAX_COUNTS];
  if (!digits_begin(cnt, wg * BINS, buckets, (int64_t)wg * nlanes * ROWS, nlanes * tps)) return;

  const int64_t b = blockIdx.x / tps, t = blockIdx.x % tps;
  const int64_t n = lane_len * nlanes;
  const int64_t lo = b * lane_len + t * tile;
  const int64_t hi = min(lo + tile, (b + 1) * lane_len);
  for (int64_t first = lo; first < hi; first += THREADS) {
    const int64_t p = first + threadIdx.x;
    const bool in = p < hi;
    uint32_t k[8], mw[NWORDS];
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = 0;
#pragma unroll
    for (int j = 0; j < NWORDS; ++j) mw[j] = 0;
    bool live = false;
    if (in) {
      uint32_t ax[8], ay[8];
      load8(k, sc + 8 * p);
      load8(ax, pts + 16 * p);
      load8(ay, pts + 16 * p + 8);
      live = !(is_zero(ax) && is_zero(ay));
      if (SGN && masks) {
#pragma unroll
        for (int j = 0; j < NWORDS; ++j) mw[j] = masks[NWORDS * p + j];
      }
    }
    int cin = 0;
    bool nz = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // The windows of scalar word j lie in carry word mi; a carry out of
      // its last bit is bit 0 of the next word.
      const int mi = (j * PER_WORD) >> 5;
      const uint32_t next = mi + 1 < NWORDS ? mw[mi + 1 < NWORDS ? mi + 1 : mi] : 0u;
      const uint64_t pair = (uint64_t)mw[mi] | ((uint64_t)next << 32);
      for (int s = 0; s < PER_WORD; ++s) {
        const int w = j * PER_WORD + s;
        const int raw = (int)((k[j] >> (s * C)) & DMASK);
        int d = raw;
        if constexpr (SGN) {
          int cout;
          if (masks) {
            const int bit = w & 31;
            cin = (int)((pair >> bit) & 1u);
            cout = (int)((pair >> (bit + 1)) & 1u);
          } else {
            cout = w < W - 1 && (raw > HALF || (raw == HALF && nz));
          }
          d = raw + cin - (cout << C);
          nz = nz || raw != 0;
          cin = cout;
        }
        const int wl = w - w0;
        if (wl < 0 || wl >= wg) continue;  // uniform over the block
        put_entry(keys, vals, cnt, n, p, p, in, live, d, wl, (int64_t)wl * nlanes + b, ROWS, BINS);
      }
    }
  }
  digits_end(cnt, wg, BINS, nlanes, b, t, tps, hist);
}

// Where a digit tensor's digits and points lie: digit (w, b, s) at
// digits[w dig_win + b dig_lane + s dig_step], the point of (b, s) at point
// index b pt_lane + s pt_step (pt_lane = 0: one basis for every lane).
struct TensorLayout {
  int64_t pt_lane, pt_step, dig_win, dig_lane, dig_step;
};

// Digits from a digit tensor (K10, K6, K13), signed or unsigned as the
// caller recoded them (|d| at most the rows of a window). Block (b, t)
// takes steps [t tile, ...) of lane b, 256 at a time, a thread a step. A
// (W, B, S) tensor reads 128 contiguous bytes a window and warp; a lane
// stream's (W, S, B) reads them B apart, from sectors the neighbouring
// lanes' blocks read too.
__global__ void __launch_bounds__(THREADS) sorted_tensor_digits_kernel(
    const uint32_t* __restrict__ pts, const int32_t* __restrict__ digits, TensorLayout lay,
    int32_t* __restrict__ keys, int32_t* __restrict__ vals, int32_t* __restrict__ hist,
    uint32_t* __restrict__ buckets, int64_t lane_len, int nlanes, int w0, int wg, int rows,
    int bins, int tile, int64_t tps) {
  __shared__ int cnt[MAX_COUNTS];
  if (!digits_begin(cnt, wg * bins, buckets, (int64_t)wg * nlanes * rows, nlanes * tps)) return;

  const int64_t b = blockIdx.x / tps, t = blockIdx.x % tps;
  const int64_t n = lane_len * nlanes;
  const int64_t lo = t * tile;
  const int64_t hi = min(lo + tile, lane_len);
  const int32_t* lane_digits = digits + (int64_t)w0 * lay.dig_win + b * lay.dig_lane;
  for (int64_t first = lo; first < hi; first += THREADS) {
    const int64_t s = first + threadIdx.x;
    const bool in = s < hi;
    const int64_t at = b * lay.pt_lane + s * lay.pt_step;
    bool live = false;
    if (in) {
      uint32_t ax[8], ay[8];
      load8(ax, pts + 16 * at);
      load8(ay, pts + 16 * at + 8);
      live = !(is_zero(ax) && is_zero(ay));
    }
    for (int wl = 0; wl < wg; ++wl) {
      const int d = in ? lane_digits[wl * lay.dig_win + s * lay.dig_step] : 0;
      put_entry(keys, vals, cnt, n, b * lane_len + s, at, in, live, d, wl, (int64_t)wl * nlanes + b, rows,
                bins);
    }
  }
  digits_end(cnt, wg, bins, nlanes, b, t, tps, hist);
}

// ---------------------------------------------------------------------------
// Stage 2: the stable counting sort.
// ---------------------------------------------------------------------------

// Exclusive prefix sums of in[0, n) into out[0, n), after `carry`, by one
// block in pieces of SCAN_PIECE; returns carry + the sum to every thread.
// in may be out: a thread reads its items before it writes them.
__device__ int block_scan(const int32_t* in, int32_t* out, int64_t n, int carry) {
  __shared__ int warp_total[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t base = 0; base < n; base += SCAN_PIECE) {
    const int64_t first = base + (int64_t)threadIdx.x * SCAN_ITEMS;
    int v[SCAN_ITEMS], sum = 0;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      v[i] = first + i < n ? in[first + i] : 0;
      sum += v[i];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += x;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      const int x = warp_total[k];
      before += k < warp ? x : 0;
      total += x;
    }
    int run = carry + before + incl - sum;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) {
      if (first + i < n) out[first + i] = run;
      run += v[i];
    }
    carry += total;
    __syncthreads();
  }
  return carry;
}

__global__ void __launch_bounds__(THREADS) scan_reduce_kernel(const int32_t* __restrict__ in,
                                                              int32_t* __restrict__ parts,
                                                              int64_t n) {
  __shared__ int warp_total[WARPS];
  const int64_t base = (int64_t)blockIdx.x * SCAN_PIECE;
  const int64_t end = min(base + SCAN_PIECE, n);
  int sum = 0;
  for (int64_t i = base + threadIdx.x; i < end; i += THREADS) sum += in[i];
  sum = __reduce_add_sync(FULL, sum);
  if ((threadIdx.x & 31) == 0) warp_total[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < WARPS; ++k) total += warp_total[k];
    parts[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(THREADS) scan_top_kernel(int32_t* __restrict__ parts,
                                                           int64_t nparts,
                                                           int32_t* __restrict__ total) {
  const int sum = block_scan(parts, parts, nparts, 0);
  if (threadIdx.x == 0) *total = sum;
}

// One block over the whole array (parts null; writes the total at out[n]),
// or block i over piece i after its prefix parts[i].
__global__ void __launch_bounds__(THREADS) scan_apply_kernel(const int32_t* __restrict__ in,
                                                             int32_t* __restrict__ out,
                                                             const int32_t* __restrict__ parts,
                                                             int64_t n) {
  if (parts == nullptr) {
    const int sum = block_scan(in, out, n, 0);
    if (threadIdx.x == 0) out[n] = sum;
    return;
  }
  const int64_t base = (int64_t)blockIdx.x * SCAN_PIECE;
  block_scan(in + base, out + base, min((int64_t)SCAN_PIECE, n - base), parts[blockIdx.x]);
}

// One CUDA launch issued: count it and return its error.
int launched(int64_t& count) {
  ++count;
  return (int)cudaGetLastError();
}

// Exclusive scan of h counts into off[0, h], off[h] the total.
int launch_scan(const int32_t* hist, int32_t* off, int32_t* parts, int64_t h, cudaStream_t st,
                int64_t& count) {
  if (h <= SCAN_ONE) {
    scan_apply_kernel<<<1, THREADS, 0, st>>>(hist, off, nullptr, h);
    return launched(count);
  }
  const int64_t np = (h + SCAN_PIECE - 1) / SCAN_PIECE;
  int err;
  scan_reduce_kernel<<<(unsigned)np, THREADS, 0, st>>>(hist, parts, h);
  if ((err = launched(count))) return err;
  scan_top_kernel<<<1, THREADS, 0, st>>>(parts, np, off + h);
  if ((err = launched(count))) return err;
  scan_apply_kernel<<<(unsigned)np, THREADS, 0, st>>>(hist, off, parts, h);
  return launched(count);
}

// The entries of tile t of segment seg = window * lanes + lane: in the first
// pass (seg_off null) the lane's points [t tile, ...) of the dense (window,
// point) arrays; in the second, entries [t tile, ...) of the segment's range
// in the first pass's output, [seg_off[seg * stride], seg_off[(seg + 1) *
// stride]).
struct TileRange {
  int64_t lo, hi;
  __device__ TileRange(const int32_t* seg_off, int64_t stride, int64_t seg, int64_t t,
                       int tile, int64_t lane_len, int nlanes) {
    if (seg_off == nullptr) {
      const int64_t start = (seg / nlanes) * lane_len * nlanes + (seg % nlanes) * lane_len;
      lo = start + t * tile;
      hi = min(lo + tile, start + lane_len);
    } else {
      lo = seg_off[seg * stride] + t * tile;
      hi = min(lo + tile, (int64_t)seg_off[(seg + 1) * stride]);
    }
  }
};

// An entry's bin in a pass: bits [shift, shift + log2 BINS) of its row, the
// key less its segment's first key (seg x rows).
template <int BINS>
__device__ __forceinline__ int bin_of(int32_t key, int32_t seg_key, int shift) {
  return ((key - seg_key) >> shift) & (BINS - 1);
}

// The second pass's tile histograms.
template <int BINS>
__global__ void __launch_bounds__(THREADS) sorted_hist_kernel(
    const int32_t* __restrict__ keys, int32_t* __restrict__ hist,
    const int32_t* __restrict__ seg_off, int64_t stride, int rows, int shift, int tile,
    int64_t tps) {
  __shared__ int cnt[BINS];
  for (int v = threadIdx.x; v < BINS; v += THREADS) cnt[v] = 0;
  __syncthreads();
  const int64_t seg = blockIdx.x / tps, t = blockIdx.x % tps;
  const TileRange r(seg_off, stride, seg, t, tile, 0, 1);
  const int32_t seg_key = (int32_t)(seg * rows);
  for (int64_t i = r.lo + threadIdx.x; i < r.hi; i += THREADS) {
    atomicAdd(&cnt[bin_of<BINS>(keys[i], seg_key, shift)], 1);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < BINS; v += THREADS) hist[(seg * BINS + v) * tps + t] = cnt[v];
}

// Exclusive prefix sum over the block of one value a thread; the total
// goes to every thread.
__device__ int block_exclusive(int v, int& total) {
  __shared__ int warp_total[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += x;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int k = 0; k < WARPS; ++k) {
    const int x = warp_total[k];
    before += k < warp ? x : 0;
    total += x;
  }
  __syncthreads();
  return before + incl - v;
}

// The stable scatter of one tile: 256 entries at a time, each ranked among
// the equal bins before it, in this round (its warp's lower lanes, then the
// lower warps) and in the tile's earlier rounds (run[], which starts at the
// scan's offset of (segment, bin, tile)). Dead entries (key -1) drop out.
// The ranked entries are staged in shared memory in bin order, and written
// out in that order at the end, so that a warp's stores fill whole sectors
// of each bin's run (scattered 4-byte stores cost a sector read each).
template <int BINS>
__global__ void __launch_bounds__(THREADS) sorted_scatter_kernel(
    const int32_t* __restrict__ keys_in, const int32_t* __restrict__ vals_in,
    int32_t* __restrict__ keys_out, int32_t* __restrict__ vals_out,
    const int32_t* __restrict__ hist, const int32_t* __restrict__ off,
    const int32_t* __restrict__ seg_off, int64_t stride, int64_t lane_len, int nlanes, int rows,
    int shift, int tile, int64_t tps) {
  __shared__ int run[BINS];
  __shared__ int stage_of[BINS];  // a bin's staging index less its global position
  __shared__ int wcnt[WARPS * BINS];
  __shared__ int32_t st_key[MAX_TILE], st_val[MAX_TILE], st_pos[MAX_TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t seg = blockIdx.x / tps, t = blockIdx.x % tps;
  const TileRange r(seg_off, stride, seg, t, tile, lane_len, nlanes);
  const int32_t seg_key = (int32_t)(seg * rows);
  int count;
  {
    const int64_t at = (seg * BINS + threadIdx.x) * tps + t;
    const bool mine = threadIdx.x < BINS;
    const int base = block_exclusive(mine ? hist[at] : 0, count);
    if (mine) {
      run[threadIdx.x] = off[at];
      stage_of[threadIdx.x] = base - off[at];
    }
  }
  for (int64_t first = r.lo; first < r.hi; first += THREADS) {
    const int64_t i = first + threadIdx.x;
    const int32_t key = i < r.hi ? keys_in[i] : -1;
    const int bin = key >= 0 ? bin_of<BINS>(key, seg_key, shift) : -1;
    for (int v = threadIdx.x; v < WARPS * BINS; v += THREADS) wcnt[v] = 0;
    __syncthreads();
    const unsigned peers = __match_any_sync(FULL, bin);
    if (bin >= 0 && lane == __ffs(peers) - 1) wcnt[warp * BINS + bin] = __popc(peers);
    __syncthreads();
    for (int v = threadIdx.x; v < BINS; v += THREADS) {
      int s = run[v];
      for (int w = 0; w < WARPS; ++w) {
        const int x = wcnt[w * BINS + v];
        wcnt[w * BINS + v] = s;
        s += x;
      }
      run[v] = s;
    }
    __syncthreads();
    if (bin >= 0) {
      const int pos = wcnt[warp * BINS + bin] + __popc(peers & ((1u << lane) - 1u));
      const int at = pos + stage_of[bin];
      st_key[at] = key;
      st_val[at] = vals_in[i];
      st_pos[at] = pos;
    }
    __syncthreads();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += THREADS) {
    keys_out[st_pos[i]] = st_key[i];
    vals_out[st_pos[i]] = st_val[i];
  }
}

// ---------------------------------------------------------------------------
// Stages 3 and 4: chunk sums and the combine of the partials.
// ---------------------------------------------------------------------------

// E sorted entries in chunks of len = max(lmin, ceil(E / target)): count
// chunks, at most target (ops/cuda_msm_sorted.py::chunk_len).
struct Chunks {
  int64_t entries, len, count;
  __device__ Chunks(int32_t e, int target, int lmin)
      : entries(e),
        len(max((int64_t)lmin, ((int64_t)e + target - 1) / target)),
        count(((int64_t)e + len - 1) / len) {}
};

// Thread k walks chunk k; see the header. A run [run_lo, run_hi) of key
// `key` is its chunk's first and continues an earlier chunk's bucket (a
// "cont" partial), or is its last and goes on into the next chunk (the
// chunk's "open" partial), or is a whole bucket. Zeroes chunk k's two
// arrival counters for the combine and notes its first key.
__global__ void __launch_bounds__(SUM_THREADS, 4) sorted_sums_kernel(
    const uint32_t* __restrict__ pts, const int32_t* __restrict__ keys,
    const int32_t* __restrict__ vals, const int32_t* __restrict__ total,
    uint32_t* __restrict__ buckets, uint32_t* __restrict__ open_buf,
    uint32_t* __restrict__ cont_buf, unsigned long long* __restrict__ counters,
    int32_t* __restrict__ firsts, int target, int lmin) {
  const int64_t k = (int64_t)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (k >= target) return;
  counters[2 * k] = 0;
  counters[2 * k + 1] = 0;
  const Chunks ch(*total, target, lmin);
  if (k >= ch.count) return;
  const int64_t lo = k * ch.len, hi = min(lo + ch.len, ch.entries);
  firsts[k] = keys[lo];
  const bool first_cont = k > 0 && keys[lo - 1] == keys[lo];
  const bool last_open = hi < ch.entries && keys[hi] == keys[hi - 1];
  Point acc;
  set_infinity(acc);
  int32_t key = keys[lo];
  int64_t run_lo = lo;
  auto finish = [&](int64_t run_hi) {
    if (run_lo == lo && first_cont) {
      store_point(cont_buf + 24 * k, acc);
    } else if (run_hi == hi && last_open) {
      store_point(open_buf + 24 * k, acc);
    } else {
      reduce_point(acc);
      store_point(buckets + 24 * (int64_t)key, acc);
    }
  };
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t ki = keys[i];
    if (ki != key) {
      finish(i);
      set_infinity(acc);
      key = ki;
      run_lo = i;
    }
    const uint32_t v = (uint32_t)vals[i];
    const int64_t p = v & 0x7fffffffu;
    uint32_t ax[8], ay[8];
    load8(ax, pts + 16 * p);
    load8(ay, pts + 16 * p + 8);
    if (v >> 31) {
      const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      fsub<Fq, false>(ay, zero, ay);
    }
    point_mixed_add<true>(acc, ax, ay);
  }
  finish(hi);
}

// The first index of keys[0, n) (sorted) above key (upper) or at or above it.
__device__ __forceinline__ int64_t search(const int32_t* keys, int64_t n, int32_t key, bool upper) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int32_t x = keys[mid];
    if (x < key || (upper && x == key)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// A node's arrival count, as one acquire-release atomic at device scope:
// the release publishes the node this thread stored before it, the acquire
// lets the second thread read its partner's.
__device__ __forceinline__ unsigned long long arrive(unsigned long long* ctr,
                                                     unsigned long long inc) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old)
               : "l"(ctr), "l"(inc)
               : "memory");
  return old;
}

__device__ __forceinline__ void select_point(Point& r, bool first, const Point& a, const Point& b) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r.x[j] = first ? a.x[j] : b.x[j];
    r.y[j] = first ? a.y[j] : b.y[j];
    r.z[j] = first ? a.z[j] : b.z[j];
  }
}

__device__ __forceinline__ void load_point_l2(Point& p, const uint32_t* src) {
  const uint4* q = reinterpret_cast<const uint4*>(src);
  uint32_t w[24];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const uint4 u = __ldcg(q + i);
    w[4 * i] = u.x, w[4 * i + 1] = u.y, w[4 * i + 2] = u.z, w[4 * i + 3] = u.w;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) p.x[j] = w[j], p.y[j] = w[8 + j], p.z[j] = w[16 + j];
}

// Thread 2k + 1 takes chunk k's open partial, thread 2k its cont partial, if
// the chunk has one. Leaf j of a bucket spanning chunks k0..k1 (m = k1 - k0
// + 1 leaves) is the open partial of k0 for j = 0, else the cont partial of
// k0 + j; node (h, base) over leaves [base, base + 2^h) lives in leaf
// base's slot and counts its arrivals in 2 bits at 2h of that leaf's counter.
// k0 and k1 come from the chunks' first keys (firsts, sorted): k1 is the
// last chunk whose first key is at most the bucket's; a cont leaf's k0 is
// the first chunk whose first key reaches it, or the one before, when the
// bucket began inside that one.
__global__ void __launch_bounds__(SUM_THREADS) sorted_combine_kernel(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ total,
    uint32_t* __restrict__ buckets, uint32_t* open_buf, uint32_t* cont_buf,
    unsigned long long* counters, const int32_t* __restrict__ firsts, int target, int lmin) {
  const int64_t th = (int64_t)blockIdx.x * SUM_THREADS + threadIdx.x;
  const int64_t k = th >> 1;
  const bool open = th & 1;
  const Chunks ch(*total, target, lmin);
  if (k >= ch.count) return;
  const int64_t lo = k * ch.len, hi = min(lo + ch.len, ch.entries);
  const bool first_cont = k > 0 && keys[lo - 1] == keys[lo];
  const int32_t last = keys[hi - 1];
  int32_t key;
  if (open) {
    const bool last_open = hi < ch.entries && keys[hi] == last;
    if (!last_open || (first_cont && keys[lo] == last)) return;
    key = last;
  } else {
    if (!first_cont) return;
    key = keys[lo];
  }
  int64_t k0 = k;
  if (!open) {
    k0 = search(firsts, ch.count, key, false);
    if (k0 > 0 && keys[k0 * ch.len - 1] == key) --k0;
  }
  const int64_t k1 = search(firsts, ch.count, key, true) - 1;
  const int64_t m = k1 - k0 + 1;
  auto slot = [&](int64_t j) { return j == 0 ? open_buf + 24 * k0 : cont_buf + 24 * (k0 + j); };
  auto counter = [&](int64_t j) { return j == 0 ? counters + 2 * k0 + 1 : counters + 2 * (k0 + j); };
  int64_t idx = k - k0;
  Point acc;
  load_point(acc, slot(idx));
  for (int h = 0; ((int64_t)1 << h) < m; ++h) {
    const int64_t size = (int64_t)1 << h, base = idx & ~(2 * size - 1);
    if (base + size >= m) continue;  // no right node: this one passes up as it is
    store_point(slot(idx), acc);
    const unsigned long long old = arrive(counter(base), 1ull << (2 * h));
    if (((old >> (2 * h)) & 3ull) == 0) return;  // the first here: the other adds
    // left + right through one inlined add: a copy for each side made the
    // combine 1.5-3.7x slower on the card (tools/sorted_variants.py)
    Point other, left, right;
    load_point_l2(other, slot(idx == base ? base + size : base));
    select_point(left, idx == base, acc, other);
    select_point(right, idx == base, other, acc);
    point_add<true>(acc, left, right);
    idx = base;
  }
  reduce_point(acc);
  store_point(buckets + 24 * (int64_t)key, acc);
}

unsigned blocks_of(int64_t items, int threads) { return (unsigned)((items + threads - 1) / threads); }

// Stage boundaries on the stream, when timed: event 0 before the digits,
// event i + 1 after stage i.
struct StageEvents {
  cudaEvent_t ev[5] = {};
  bool on = false;
  int make() {
    on = true;
    for (auto& e : ev) {
      if (int err = (int)cudaEventCreate(&e)) return err;
    }
    return 0;
  }
  void mark(int i, cudaStream_t st) {
    if (on) cudaEventRecord(ev[i], st);
  }
  // Waits for the last event; stage i's milliseconds into ms[i].
  int read(float* ms) {
    int err = (int)cudaEventSynchronize(ev[4]);
    for (int i = 0; i < 4 && !err; ++i) err = (int)cudaEventElapsedTime(ms + i, ev[i], ev[i + 1]);
    return err;
  }
  ~StageEvents() {
    for (auto e : ev) {
      if (e) cudaEventDestroy(e);
    }
  }
};

// The kernel instances a run-time bin count or width selects (null for
// one the design does not take); each is launched through its pointer.
using ScatterKernel = void (*)(const int32_t*, const int32_t*, int32_t*, int32_t*, const int32_t*,
                               const int32_t*, const int32_t*, int64_t, int64_t, int, int, int, int,
                               int64_t);
using HistKernel = void (*)(const int32_t*, int32_t*, const int32_t*, int64_t, int, int, int, int64_t);
using DigitsKernel = void (*)(const uint32_t*, const uint32_t*, const uint32_t*, int32_t*, int32_t*,
                              int32_t*, uint32_t*, int64_t, int, int, int, int, int64_t);

#define VKZG_BINS(X) X(1) X(2) X(4) X(8) X(16) X(32) X(64) X(128) X(256)

ScatterKernel scatter_for(int bins) {
#define VKZG_CASE(B) if (bins == B) return sorted_scatter_kernel<B>;
  VKZG_BINS(VKZG_CASE)
#undef VKZG_CASE
  return nullptr;
}

HistKernel hist_for(int bins) {
#define VKZG_CASE(B) if (bins == B) return sorted_hist_kernel<B>;
  VKZG_BINS(VKZG_CASE)
#undef VKZG_CASE
  return nullptr;
}

DigitsKernel word_digits_for(int c, bool sgn) {
#define VKZG_CASE(C) \
  if (c == C) return sgn ? sorted_digits_kernel<C, true> : sorted_digits_kernel<C, false>;
  VKZG_CASE(1) VKZG_CASE(2) VKZG_CASE(4) VKZG_CASE(8) VKZG_CASE(16)
#undef VKZG_CASE
  return nullptr;
}

// The four stages of one call: digits from the scalar words (sc, and masks
// or null) or from the digit tensor (digits), then the sort's one or two
// passes, the sums and the combine.
int launch_sorted(const Plan& pl, const uint32_t* pts, const uint32_t* sc, const uint32_t* masks,
                  const int32_t* digits, const TensorLayout& lay, uint32_t* buckets, int32_t* work, int w0,
                  int lmin, StageEvents& evs, cudaStream_t st, int64_t& count) {
  int32_t* const ka = work + pl.keys[0];
  int32_t* const va = work + pl.vals[0];
  int32_t* const kb = work + pl.keys[1];
  int32_t* const vb = work + pl.vals[1];
  int32_t* const off_a = work + pl.o_a;
  int32_t* const off_b = work + pl.o_b;
  const int64_t segs = (int64_t)pl.wg * pl.lanes;
  const unsigned tiles = (unsigned)(segs * pl.tps);
  const unsigned dblocks = (unsigned)max(pl.lanes * pl.tps, (int64_t)FILL_BLOCKS);
  const int nl = (int)pl.lanes;
  const ScatterKernel scatter_a = scatter_for(pl.bins_a);
  const ScatterKernel scatter_b = scatter_for(pl.bins_b);
  const HistKernel hist_b = hist_for(pl.bins_b);
  const DigitsKernel word_digits = digits ? nullptr : word_digits_for(pl.c, pl.sgn);
  if (!scatter_a || (pl.bins_b && !(scatter_b && hist_b)) || (!digits && !word_digits)) {
    return (int)cudaErrorInvalidValue;
  }
  int err = 0;
  evs.mark(0, st);
  if (digits) {
    sorted_tensor_digits_kernel<<<dblocks, THREADS, 0, st>>>(pts, digits, lay, ka, va, work + pl.h_a,
                                                             buckets, pl.lane_len, nl, w0, pl.wg, pl.rows,
                                                             pl.bins_a, pl.tile, pl.tps);
  } else {
    word_digits<<<dblocks, THREADS, 0, st>>>(pts, sc, masks, ka, va, work + pl.h_a, buckets, pl.lane_len,
                                             nl, w0, pl.wg, pl.tile, pl.tps);
  }
  if ((err = launched(count))) return err;
  evs.mark(1, st);
  if ((err = launch_scan(work + pl.h_a, off_a, work + pl.p_a, pl.hist_a, st, count))) return err;
  scatter_a<<<tiles, THREADS, 0, st>>>(ka, va, kb, vb, work + pl.h_a, off_a, nullptr, 0, pl.lane_len, nl,
                                       pl.rows, 0, pl.tile, pl.tps);
  if ((err = launched(count))) return err;
  if (pl.bins_b) {
    const int64_t stride = (int64_t)pl.bins_a * pl.tps;
    hist_b<<<tiles, THREADS, 0, st>>>(kb, work + pl.h_b, off_a, stride, pl.rows, 8, pl.tile, pl.tps);
    if ((err = launched(count))) return err;
    if ((err = launch_scan(work + pl.h_b, off_b, work + pl.p_b, pl.hist_b, st, count))) return err;
    scatter_b<<<tiles, THREADS, 0, st>>>(kb, vb, work + pl.keys[2], work + pl.vals[2], work + pl.h_b, off_b,
                                         off_a, stride, 0, 1, pl.rows, 8, pl.tile, pl.tps);
    if ((err = launched(count))) return err;
  }
  evs.mark(2, st);
  const int last = pl.bins_b ? 2 : 1;
  const int32_t* keys = work + pl.keys[last];
  const int32_t* vals = work + pl.vals[last];
  const int32_t* total = pl.bins_b ? off_b + pl.hist_b : off_a + pl.hist_a;
  uint32_t* open_buf = reinterpret_cast<uint32_t*>(work + pl.partials);
  uint32_t* cont_buf = open_buf + 24 * (int64_t)pl.target;
  auto* counters = reinterpret_cast<unsigned long long*>(work + pl.counters);
  sorted_sums_kernel<<<blocks_of(pl.target, SUM_THREADS), SUM_THREADS, 0, st>>>(
      pts, keys, vals, total, buckets, open_buf, cont_buf, counters, work + pl.firsts, pl.target,
      lmin);
  if ((err = launched(count))) return err;
  evs.mark(3, st);
  sorted_combine_kernel<<<blocks_of(2 * (int64_t)pl.target, SUM_THREADS), SUM_THREADS, 0, st>>>(
      keys, total, buckets, open_buf, cont_buf, counters, work + pl.firsts, pl.target, lmin);
  if ((err = launched(count))) return err;
  evs.mark(4, st);
  return 0;
}

}  // namespace

// The workspace of one call over wg windows, in int32 words: *words.
// from_words: the digits come from the scalar words (c dividing 16), else
// from a digit tensor.
extern "C" int vkzg_msm_sorted_plan(int64_t npoints, int64_t nlanes, int c, int sgn, int from_words,
                                    int wg, int target, int64_t* words) {
  const Plan pl(npoints, nlanes, c, sgn != 0, from_words != 0, wg, target);
  if (!pl.ok) return (int)cudaErrorInvalidValue;
  *words = pl.words;
  return 0;
}

// npoints = lanes x S entries a window. The digits: from sc (N, 8) standard
// scalars, signed (sgn) with masks (N, W / 32 + 1) carry words or null (the
// carries are then computed), or unsigned (masks null), pts (N, 2, 8)
// affine with lane b's points [b S, (b + 1) S); or, with sc null, from
// digits int32, balanced signed or unsigned as sgn says, laid out as
// layout[5] = {point lane, point step, digit window, digit lane, digit
// step} strides say (TensorLayout; in points for pts, in elements for
// digits; every point index below 2^31). buckets: the first row of window
// w0 in the (W, B, rows, 3, 8) output; work: the plan's words. Adds each
// CUDA launch it issues to *launches. stage_ms: null on the path; else the
// call records an event at each stage boundary, waits for the last, and
// writes the milliseconds of digits, sort, sums and combine there.
extern "C" int vkzg_msm_sorted(const void* pts, const void* sc, const void* masks, const void* digits,
                               void* buckets, void* work, int64_t work_words, int64_t npoints,
                               int64_t nlanes, int c, int sgn, int w0, int wg, int target, int lmin,
                               const int64_t* layout, float* stage_ms, int64_t* launches, void* stream) {
  const Plan pl(npoints, nlanes, c, sgn != 0, digits == nullptr, wg, target);
  if (!pl.ok || work_words < pl.words || lmin < 1 || w0 < 0 || w0 + wg > pl.nwin || !launches ||
      (sc == nullptr) == (digits == nullptr) || (masks && (!sgn || digits)) ||
      (digits != nullptr) != (layout != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  TensorLayout lay{};
  if (layout) {
    lay = {layout[0], layout[1], layout[2], layout[3], layout[4]};
    if (lay.pt_lane < 0 || lay.pt_step < 0 ||
        (pl.lanes - 1) * lay.pt_lane + (pl.lane_len - 1) * lay.pt_step >= (int64_t(1) << 31)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const cudaStream_t st = (cudaStream_t)stream;
  StageEvents evs;
  if (stage_ms) {
    if (int err = evs.make()) return err;
  }
  int err = launch_sorted(pl, (const uint32_t*)pts, (const uint32_t*)sc, (const uint32_t*)masks,
                          (const int32_t*)digits, lay, (uint32_t*)buckets, (int32_t*)work, w0, lmin, evs,
                          st, *launches);
  if (!err && stage_ms) err = evs.read(stage_ms);
  return err;
}
