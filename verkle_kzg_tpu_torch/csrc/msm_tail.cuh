// The MSM tail shared by K4 (the single MSM, one lane) and K7 (B lanes):
// buckets (W, B, rows, 3, 8), row i the bucket of digit i + 1, ->
// (B, 3, 8) reduced, per lane sum_w 2^(c w) T_w with the window sums
// T_w = sum_i (i + 1) B_wi. It replaces the bodies of two TPU kernels of
// verkle_kzg_tpu/ops/pallas_msm.py: _single_tail's second launch (line 1041,
// _suffix_horner_kernel with _window_sum) and _batched_tail_kernel (line
// 1152). The wrappers in ops/cuda_msm.py and ops/cuda_msm_batched.py still
// count the two apart.
//
// What bounds it: Horner's dependent chain of c (W - 1) doublings and W - 1
// adds, which no order of the sums shortens, plus the depth of the window
// sums; its products are far fewer than the card's rate (0.0017 ms of them
// at W = 32, 128 rows). So the design cuts the time of one dependent point
// operation and the depth of the sums:
//
//  * Window sums in log depth. A window's rows are cut into runs of
//    L = 2^log2_run rows (ops/cuda_msm.py::run_len: 4 at 128 rows). A lane
//    runs the suffix sum of one run from its top row (S = the rows seen,
//    T = the sum of the running S, so T = sum_j (j + 1) B_j), and a warp
//    combines 32 runs in five levels of a tree: node (S, T, X) over items
//    [a, a + n), X = sum_k (k - a) S_k, merges as
//        S = S_l + S_r,  T = T_l + T_r,  X = X_l + X_r + n_l S_r,
//    with n_l S_r as log2(n_l) doublings, and the root gives
//        T + L X = sum over the group's rows of (i + 1) B_i.
//    That is about 3 adds a run on top of the runs' 2 a row. A window of
//    more than 32 runs takes further levels of the same combine over the
//    groups' pairs (one launch each, L growing 32-fold), so that the long
//    windows of c = 16 spread over the SMs as their runs do.
//  * Horner on a warp (warp_point.cuh, shared with K5). Each RCB16 step's
//    independent Montgomery products (4 + 4 for a doubling, 6 + 6 for an
//    add) run on separate lanes, with the operands in shared memory and
//    __syncwarp() between the levels;
//    every lane forms the lazy sums between the levels itself. The same
//    field operations in the same order give the same words.
//
// A tail whose windows fit one group each (rows <= 1,024: c <= 11 signed,
// c <= 10 unsigned) is ONE launch: a warp takes 32 / span windows of one
// lane (span the power of two at or above the runs a window: 8 windows at
// c = 5, one at c = 8), writes their window sums, and the warp that
// completes a lane's windows (a per-lane counter, zeroed for each call) runs
// the lane's Horner. Wider windows take one launch per combine level and a
// Horner launch. Kernel and plain version (ops/cuda_msm.py::plain_tail) add
// in the same order, so they agree word for word. The products are
// bn254_field.cuh's fmul: a CIOS over PTX carry chains ran slower on the
// card (tools/fmul_probe.py); Horner's lazy sums run over carry chains,
// which made its point operations faster (PERF.md).
#pragma once
#include <cuda_runtime.h>

#include "warp_point.cuh"

namespace vkzg {
namespace {

constexpr int GROUP = 32;  // items (runs or pairs) a warp combines
constexpr int WARPS = 4;   // warps a block
constexpr unsigned FULL = 0xffffffffu;

// One warp's item slots in the combine: S, T and X of each lane.
struct __align__(16) GroupSlots {
  uint32_t s[GROUP * 24], t[GROUP * 24], x[GROUP * 24];
};
static_assert(sizeof(WarpScratch) <= sizeof(GroupSlots), "Horner reuses the slots");

__device__ __forceinline__ void select_point(Point& r, bool c, const uint32_t* a, const Point& b) {
  Point u;
  load_point(u, a);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    r.x[j] = c ? u.x[j] : b.x[j];
    r.y[j] = c ? u.y[j] : b.y[j];
    r.z[j] = c ? u.z[j] : b.z[j];
  }
}

// One lane's Horner on a warp: sums (W, 3, 8) lazy window sums, written by
// this launch or an earlier one (read through L2) -> out (3, 8) reduced.
__device__ void warp_horner(const uint32_t* sums, uint32_t* out, int nwin, int c,
                            WarpScratch& s, int lane) {
  if (lane < 24) s.acc[lane] = __ldcg(sums + (nwin - 1) * 24 + lane);
  __syncwarp();
  for (int w = nwin - 2; w >= 0; --w) {
    if (lane < 24) s.q[lane] = __ldcg(sums + w * 24 + lane);
    for (int i = 0; i < c; ++i) warp_double<true>(s, lane);
    warp_add<true, 32>(s, lane);
  }
  if (lane < 3) {
    uint32_t a[8];
    load8(a, s.acc + 8 * lane);
    cond_sub<Fq, false>(a);
    store8(out + 8 * lane, a);
  }
}

// The warp combine of the groups of a warp: the warp is cut into segments of
// `span` lanes (a power of two, at least m), one group each; lane rel < m
// of a segment holds item rel's (S, T) in its slots, each item over
// 2^log2_len rows (the last may be shorter). Leaves each segment's first
// lane's slots holding its group's (S, T). The tree's levels are uniform
// across the warp: at level d every lane doubles its S d times (only a
// right node's result is used), then two adds in which left and right
// lanes take different operands.
__device__ void combine_group(GroupSlots& g, int m, int span, int log2_len, int lane) {
  if (m == 1) return;
  const int rel = lane & (span - 1);
  uint32_t* my_s = g.s + 24 * lane;
  uint32_t* my_t = g.t + 24 * lane;
  uint32_t* my_x = g.x + 24 * lane;
  for (int d = 0; (1 << d) < m; ++d) {
    const int h = 1 << d;
    const int pos = rel & (2 * h - 1);
    const bool left = pos == 0 && rel + h < m;
    const bool right = pos == h && rel < m;
    const bool right_has_x = right && min(h, m - rel) >= 2;
    const int up = lane + h < GROUP ? lane + h : lane;  // partner of a left lane
    const int down = lane >= h ? lane - h : lane;       // partner of a right lane
    Point e, p, q;
    load_point(e, my_s);
    for (int k = 0; k < d; ++k) point_double<true>(e);  // n_l S_r
    // left: S = S_l + S_r; right: E = X_r + n_l S_r
    select_point(p, left, my_s, e);
    load_point(q, left ? g.s + 24 * up : my_x);
    point_add<true>(p, p, q);
    __syncwarp();
    if (left) store_point(my_s, p);
    if (right_has_x) e = p;
    // left: T = T_l + T_r; right: X = X_l + E (E alone at d = 0)
    select_point(p, left, my_t, e);
    load_point(q, left ? g.t + 24 * up : g.x + 24 * down);
    point_add<true>(p, p, q);
    __syncwarp();
    if (left) store_point(my_t, p);
    if (right) store_point(g.x + 24 * down, d ? p : e);
    __syncwarp();
  }
  if (rel == 0) {  // T += 2^log2_len X
    Point x, t;
    load_point(x, my_x);
    for (int k = 0; k < log2_len; ++k) point_double<true>(x);
    load_point(t, my_t);
    point_add<true>(t, t, x);
    store_point(my_t, t);
  }
  __syncwarp();
}

// How a combine level of nitems items a window maps onto warps. With more
// than one group a window, a warp takes one group of one (window, lane).
// With one, a warp takes 32 / span windows of one lane b (span the power of
// two at or above nitems), so that a window of few runs leaves no lanes
// idle and no warp holds the last window of two lanes.
struct LevelPlan {
  int ngroups, span, per_warp;
  int64_t chunks, tasks;  // chunks: warps a lane when ngroups == 1
  __host__ __device__ LevelPlan(int nitems, int nwin, int64_t nlanes) {
    ngroups = (nitems + GROUP - 1) / GROUP;
    span = GROUP;
    if (ngroups == 1) {
      span = 1;
      while (span < nitems) span <<= 1;
    }
    per_warp = GROUP / span;
    chunks = (nwin + per_warp - 1) / per_warp;
    tasks = ngroups > 1 ? (int64_t)nwin * nlanes * ngroups : nlanes * chunks;
  }
};

// One combine level: runs of 2^log2_len bucket rows (ROWS; buckets
// (W, B, nin, 3, 8)) or pairs (S, T) of the level before ((W, B, nin, 2, 3,
// 8)) as items. With more than one group a window it writes the pairs
// (W, B, groups, 2, 3, 8); with one it writes the window sums T to sums
// (B, W, 3, 8), and when counters is given the warp that completes lane
// b's windows then runs b's Horner into out (B, 3, 8).
template <bool ROWS>
__global__ void __launch_bounds__(32 * WARPS) tail_level_kernel(
    const uint32_t* __restrict__ in, uint32_t* __restrict__ pairs, uint32_t* __restrict__ sums,
    int* __restrict__ counters, uint32_t* __restrict__ out, int nwin, int64_t nlanes, int nin,
    int nitems, int log2_len, int c) {
  __shared__ GroupSlots slots[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const LevelPlan plan(nitems, nwin, nlanes);
  const int64_t task = (int64_t)blockIdx.x * WARPS + warp;
  if (task >= plan.tasks) return;
  const int seg = lane / plan.span, rel = lane % plan.span;
  int grp = 0;
  int64_t w, b;
  if (plan.ngroups > 1) {
    grp = (int)(task % plan.ngroups);
    w = task / plan.ngroups / nlanes;
    b = task / plan.ngroups % nlanes;
  } else {
    b = task / plan.chunks;
    w = task % plan.chunks * plan.per_warp + seg;
  }
  const int m = min(GROUP, nitems - grp * GROUP);
  const int item = grp * GROUP + rel;
  GroupSlots& g = slots[warp];
  if (w < nwin && rel < m) {
    Point S, T;
    if (ROWS) {
      const uint32_t* bk = in + (w * nlanes + b) * nin * 24;
      const int lo = item << log2_len;
      const int top = min(lo + (1 << log2_len), nin) - 1;
      load_point(S, bk + 24 * top);
      T = S;
      for (int j = top - 1; j >= lo; --j) {
        Point x;
        load_point(x, bk + 24 * j);
        point_add<true>(S, S, x);
        point_add<true>(T, T, S);
      }
    } else {
      const uint32_t* pr = in + ((w * nlanes + b) * nin + item) * 48;
      load_point(S, pr);
      load_point(T, pr + 24);
    }
    store_point(g.s + 24 * lane, S);
    store_point(g.t + 24 * lane, T);
  }
  __syncwarp();
  combine_group(g, m, plan.span, log2_len, lane);
  if (plan.ngroups > 1) {
    if (lane < 24) {
      uint32_t* dst = pairs + ((w * nlanes + b) * plan.ngroups + grp) * 48;
      dst[lane] = g.s[lane];
      dst[24 + lane] = g.t[lane];
    }
    return;
  }
  const int64_t w0 = task % plan.chunks * plan.per_warp;  // this warp's windows of lane b
  const int nseg = nwin - w0 < plan.per_warp ? (int)(nwin - w0) : plan.per_warp;
  for (int k = lane; k < nseg * 24; k += 32) {
    sums[(b * nwin + w0 + k / 24) * 24 + k % 24] = g.t[k / 24 * plan.span * 24 + k % 24];
  }
  if (counters == nullptr) return;
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(counters + b, nseg) + nseg == nwin;
  if (!__shfl_sync(FULL, last, 0)) return;
  __threadfence();
  warp_horner(sums + b * nwin * 24, out + b * 24, nwin, c, *reinterpret_cast<WarpScratch*>(&g),
              lane);
}

// Horner alone, one warp a lane, after a multi-level sum.
__global__ void __launch_bounds__(32 * WARPS) tail_horner_kernel(
    const uint32_t* __restrict__ sums, uint32_t* __restrict__ out, int nwin, int64_t nlanes,
    int c) {
  __shared__ WarpScratch scratch[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  if (b >= nlanes) return;
  warp_horner(sums + b * nwin * 24, out + b * 24, nwin, c, scratch[warp], lane);
}

unsigned blocks_of(int64_t warps) { return (unsigned)((warps + WARPS - 1) / WARPS); }

// The whole tail, or a part of it: parts bit 0 the window sums (into sums),
// bit 1 Horner (from sums). pairs_a and pairs_b hold the combine levels'
// pairs in turn (W, B, groups, 2, 3, 8); counters (B) are zero on entry,
// one array a call.
int launch_tail(const uint32_t* buckets, uint32_t* pairs_a, uint32_t* pairs_b, uint32_t* sums,
                int* counters, uint32_t* out, int nwin, int64_t nlanes, int rows, int log2_run,
                int c, int parts, cudaStream_t st) {
  if (nwin < 1 || nlanes < 1 || rows < 1 || log2_run < 0 || c < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int runs = (int)(((int64_t)rows + (1 << log2_run) - 1) >> log2_run);
  const bool single = runs <= GROUP;
  const int threads = 32 * WARPS;
  if (parts & 1) {
    int nitems = runs, log2_len = log2_run;
    const uint32_t* src = buckets;
    uint32_t* dst = pairs_a;
    for (bool first = true;; first = false) {
      const LevelPlan plan(nitems, nwin, nlanes);
      const int groups = plan.ngroups;
      int* cnt = groups == 1 && single && (parts & 2) ? counters : nullptr;
      const unsigned blocks = blocks_of(plan.tasks);
      if (first) {
        tail_level_kernel<true><<<blocks, threads, 0, st>>>(src, dst, sums, cnt, out, nwin, nlanes,
                                                            rows, nitems, log2_len, c);
      } else {
        tail_level_kernel<false><<<blocks, threads, 0, st>>>(src, dst, sums, cnt, out, nwin, nlanes,
                                                             nitems, nitems, log2_len, c);
      }
      const int err = (int)cudaGetLastError();
      if (err) return err;
      if (groups == 1) break;
      src = dst;
      dst = dst == pairs_a ? pairs_b : pairs_a;
      nitems = groups;
      log2_len += 5;  // a group spans 32 items
    }
  }
  if ((parts & 2) && !(single && (parts & 1))) {
    tail_horner_kernel<<<blocks_of(nlanes), threads, 0, st>>>(sums, out, nwin, nlanes, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace vkzg
