// K4, the single-MSM tail at any (W, rows), and the entry point of the
// accumulation with digits from the scalar words (K3, K8, K9), whose kernel
// is in msm_accumulate.cuh. See ops/cuda_msm.py for what they replace and
// why they are shaped so.
#include <cuda_runtime.h>

#include "bn254_curve.cuh"

using namespace vkzg;

namespace {
constexpr int CHUNK = 32;  // K4: rows a thread sums, pairs a combine step takes
constexpr int LOG2_CHUNK = 5;
}  // namespace

// K4, first launch. Thread t = (w, k) runs the suffix sum over rows
// [32k, min(32k + 32, rows)) of window w from the top, keeping S = sum of
// the rows seen and T = sum of the running S, so T = sum_j (j + 1) B_{32k+j};
// it writes the lazy pair (S, T) to pairs (W, K, 2, 3, 8).
__global__ void __launch_bounds__(128) msm_tail_chunks_kernel(const uint32_t* __restrict__ buckets,
                                                              uint32_t* __restrict__ pairs,
                                                              int nwin, int rows, int nchunks) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)nwin * nchunks) return;
  const int64_t w = t / nchunks;
  const int k = (int)(t % nchunks);
  const int len = min(CHUNK, rows - k * CHUNK);
  Point S, T;
  set_infinity(S);
  set_infinity(T);
  for (int j = len - 1; j >= 0; --j) {
    Point b;
    load_point(b, buckets + (w * rows + (int64_t)k * CHUNK + j) * 24);
    point_add<true>(S, S, b);
    point_add<true>(T, T, S);
  }
  store_point(pairs + t * 48, S);
  store_point(pairs + t * 48 + 24, T);
}

// K4, a combine launch. Thread t = (w, g) takes the m <= 32 pairs
// g*32 .. g*32 + m - 1 of window w, each over 2^log2_len rows, and writes
//   S = sum_k S_k,  T = sum_k T_k + 2^log2_len sum_k k S_k,
// with sum_k k S_k = U_1 + ... + U_{m-1}, U_k = S_k + ... + S_{m-1}, run
// from the top pair; a group of one pair is copied. At c = 8 (4 chunks, one
// level) that is 5 doublings, then T_0 .. T_3 added.
__global__ void __launch_bounds__(128) msm_tail_combine_kernel(const uint32_t* __restrict__ in,
                                                               uint32_t* __restrict__ out, int nwin,
                                                               int nin, int nout, int log2_len) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)nwin * nout) return;
  const int64_t w = t / nout;
  const int g = (int)(t % nout);
  const int m = min(CHUNK, nin - g * CHUNK);
  const uint32_t* src = in + (w * nin + (int64_t)g * CHUNK) * 48;
  Point U, V;
  if (m == 1) {
    load_point(U, src);
    load_point(V, src + 24);
  } else {
    load_point(U, src + 48 * (m - 1));
    V = U;
    for (int k = m - 2; k >= 1; --k) {
      Point x;
      load_point(x, src + 48 * k);
      point_add<true>(U, U, x);
      point_add<true>(V, V, U);
    }
    Point x;
    load_point(x, src);
    point_add<true>(U, U, x);
    for (int i = 0; i < log2_len; ++i) double_lazy(V);
    for (int k = 0; k < m; ++k) {
      load_point(x, src + 48 * k + 24);
      point_add<true>(V, V, x);
    }
  }
  store_point(out + t * 48, U);
  store_point(out + t * 48 + 24, V);
}

// K4, last launch: one thread runs Horner over the window sums T_w (pairs
// (W, 1, 2, 3, 8)) from the top window down, c lazy doublings then an add,
// and reduces the result to [0, m).
__global__ void msm_tail_horner_kernel(const uint32_t* __restrict__ pairs,
                                       uint32_t* __restrict__ out, int nwin, int c) {
  Point acc;
  load_point(acc, pairs + (int64_t)(nwin - 1) * 48 + 24);
  for (int win = nwin - 2; win >= 0; --win) {
    for (int i = 0; i < c; ++i) double_lazy(acc);
    Point x;
    load_point(x, pairs + (int64_t)win * 48 + 24);
    point_add<true>(acc, acc, x);
  }
  reduce_point(acc);
  store_point(out, acc);
}

extern "C" int vkzg_msm_accumulate_signed(const void*, const void*, const void*, void*, int64_t,
                                          int64_t, int, cudaStream_t);
extern "C" int vkzg_msm_accumulate_unsigned(const void*, const void*, const void*, void*, int64_t,
                                            int64_t, int, cudaStream_t);

// pts (nseg * seg_len, 2, 8) affine, sc (.., 8) standard scalars, masks
// (.., W / 32 + 1) carry words (signed only) -> table (W, nseg, rows, 3, 8).
extern "C" int vkzg_msm_accumulate(const void* pts, const void* sc, const void* masks,
                                   void* table, int64_t nseg, int64_t seg_len, int c,
                                   int is_signed, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return is_signed ? vkzg_msm_accumulate_signed(pts, sc, masks, table, nseg, seg_len, c, st)
                   : vkzg_msm_accumulate_unsigned(pts, sc, masks, table, nseg, seg_len, c, st);
}

// buckets (W, rows, 3, 8) reduced -> out (3, 8) reduced. first holds
// (W, ceil(rows / 32), 2, 3, 8) pairs, second (W, ceil(rows / 1024), 2, 3, 8);
// the combine levels write to them in turn.
extern "C" int vkzg_msm_tail(const void* buckets, void* first, void* second, void* out, int nwin,
                             int rows, int c, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 128;
  int n = (rows + CHUNK - 1) / CHUNK;
  msm_tail_chunks_kernel<<<(unsigned)(((int64_t)nwin * n + threads - 1) / threads), threads, 0, st>>>(
      (const uint32_t*)buckets, (uint32_t*)first, nwin, rows, n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  uint32_t* src = (uint32_t*)first;
  uint32_t* dst = (uint32_t*)second;
  for (int log2_len = LOG2_CHUNK; n > 1; log2_len += LOG2_CHUNK) {
    const int next = (n + CHUNK - 1) / CHUNK;
    msm_tail_combine_kernel<<<(unsigned)(((int64_t)nwin * next + threads - 1) / threads), threads, 0,
                              st>>>(src, dst, nwin, n, next, log2_len);
    err = (int)cudaGetLastError();
    if (err) return err;
    uint32_t* tmp = src;
    src = dst;
    dst = tmp;
    n = next;
  }
  msm_tail_horner_kernel<<<1, 1, 0, st>>>(src, (uint32_t*)out, nwin, c);
  return (int)cudaGetLastError();
}
