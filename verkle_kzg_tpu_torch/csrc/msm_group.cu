// K13: the window-grouped bucket accumulation over a lane stream, G windows
// a thread, with an optional pipelined ("fused") row access. Replaces
// verkle_kzg_tpu/ops/pallas_msm.py:807, the launch of _accum_kernel_group
// (body at :431-563). See ops/cuda_msm_group.py for the design and its
// bound.
//
// Layouts: pts (S, B, 2, 8) affine Montgomery words, step i of lane b at
// point i * B + b; digits (W, S, B) int32; table (W, B, rows, 3, 8), the
// layout of K6/K10 with one segment a lane. Bucket |d| lies in row |d| - 1
// (rows = 2^(c-1) for balanced signed digits, 2^c - 1 unsigned); digit 0
// and the (0, 0) sentinel add nothing, d < 0 negates y.
#include <cuda_runtime.h>

#include "bn254_curve.cuh"

using namespace vkzg;

namespace {

constexpr int GROUP_MAX = 4;
constexpr int THREADS = 32;  // a few hundred to a few thousand threads: spread them over the SMs

// The row of digit d, and row 0 for d = 0 (read and never written).
__device__ __forceinline__ int row_of(int d) { return d == 0 ? 0 : (d < 0 ? -d : d) - 1; }

// y, or m - y for a negative digit (ny = m - y, reduced, computed once a step).
__device__ __forceinline__ void select_y(uint32_t out[8], const uint32_t ay[8],
                                         const uint32_t ny[8], int d) {
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = d < 0 ? ny[k] : ay[k];
}

// Thread t owns lane b = t % B of window group g = t / B: windows g G + j,
// j < G, each with its own table. A window past W (the last group of a W
// that G does not divide) is inert: its digits read as 0 and its table
// pointer is the last window's, which it reads and never writes. Every step
// loads lane b's point once for all G chains and runs their G lazy mixed
// adds as independent dependency chains. FUSED: step i + 1's rows are
// loaded before step i's arithmetic, and a row that step i wrote is
// forwarded from registers; the order of additions into each bucket, and so
// every row, is the same either way.
template <int G, bool FUSED>
__global__ void __launch_bounds__(THREADS) msm_group_kernel(
    const uint32_t* __restrict__ pts, const int32_t* __restrict__ digits,
    uint32_t* __restrict__ table, int nwin, int64_t nsteps, int64_t nlanes, int rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t ngroups = (nwin + G - 1) / G;
  if (t >= ngroups * nlanes) return;
  const int64_t b = t % nlanes;
  const int g = (int)(t / nlanes);

  uint32_t* tbl[G];
  const int32_t* dig[G];
  bool live[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int w = g * G + j;
    live[j] = w < nwin;
    const int64_t wc = live[j] ? w : nwin - 1;
    tbl[j] = table + (wc * nlanes + b) * rows * 24;
    dig[j] = digits + wc * nsteps * nlanes + b;
  }

  Point inf;
  set_infinity(inf);
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (live[j])
      for (int r = 0; r < rows; ++r) store_point(tbl[j] + 24 * r, inf);

  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (!FUSED) {
    for (int64_t i = 0; i < nsteps; ++i) {
      int d[G];
#pragma unroll
      for (int j = 0; j < G; ++j) d[j] = live[j] ? dig[j][i * nlanes] : 0;
      uint32_t ax[8], ay[8], ny[8];
      const uint32_t* p = pts + (i * nlanes + b) * 16;
      load8(ax, p);
      load8(ay, p + 8);
      if (is_zero(ax) && is_zero(ay)) continue;
      fsub<Fq, false>(ny, zero, ay);
      Point acc[G];
#pragma unroll
      for (int j = 0; j < G; ++j) load_point(acc[j], tbl[j] + 24 * row_of(d[j]));
#pragma unroll
      for (int j = 0; j < G; ++j) {
        uint32_t y[8];
        select_y(y, ay, ny, d[j]);
        point_mixed_add<true>(acc[j], ax, y);
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (d[j] != 0) store_point(tbl[j] + 24 * row_of(d[j]), acc[j]);
    }
  } else if (nsteps > 0) {
    // cur[j] holds table row row_of(dc[j]) as it stands before step i
    Point cur[G];
    int dc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      dc[j] = live[j] ? dig[j][0] : 0;
      load_point(cur[j], tbl[j] + 24 * row_of(dc[j]));
    }
    for (int64_t i = 0; i < nsteps; ++i) {
      int dn[G];
      Point nxt[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        dn[j] = (live[j] && i + 1 < nsteps) ? dig[j][(i + 1) * nlanes] : 0;
        load_point(nxt[j], tbl[j] + 24 * row_of(dn[j]));
      }
      uint32_t ax[8], ay[8];
      const uint32_t* p = pts + (i * nlanes + b) * 16;
      load8(ax, p);
      load8(ay, p + 8);
      if (!(is_zero(ax) && is_zero(ay))) {
        uint32_t ny[8];
        fsub<Fq, false>(ny, zero, ay);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          uint32_t y[8];
          select_y(y, ay, ny, dc[j]);
          point_mixed_add<true>(cur[j], ax, y);
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (dc[j] != 0) {
            store_point(tbl[j] + 24 * row_of(dc[j]), cur[j]);
            if (row_of(dn[j]) == row_of(dc[j])) nxt[j] = cur[j];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        cur[j] = nxt[j];
        dc[j] = dn[j];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (!live[j]) continue;
    for (int r = 0; r < rows; ++r) {
      Point q;
      load_point(q, tbl[j] + 24 * r);
      reduce_point(q);
      store_point(tbl[j] + 24 * r, q);
    }
  }
}

template <int G, bool FUSED>
int launch_group(const void* pts, const void* digits, void* table, int nwin, int64_t nsteps,
                 int64_t nlanes, int rows, cudaStream_t stream) {
  const int64_t total = (int64_t)((nwin + G - 1) / G) * nlanes;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  msm_group_kernel<G, FUSED><<<blocks, THREADS, 0, stream>>>(
      (const uint32_t*)pts, (const int32_t*)digits, (uint32_t*)table, nwin, nsteps, nlanes, rows);
  return (int)cudaGetLastError();
}

template <bool FUSED>
int launch_group_any(const void* pts, const void* digits, void* table, int nwin, int64_t nsteps,
                     int64_t nlanes, int rows, int group, cudaStream_t stream) {
  switch (group) {
    case 1: return launch_group<1, FUSED>(pts, digits, table, nwin, nsteps, nlanes, rows, stream);
    case 2: return launch_group<2, FUSED>(pts, digits, table, nwin, nsteps, nlanes, rows, stream);
    case 3: return launch_group<3, FUSED>(pts, digits, table, nwin, nsteps, nlanes, rows, stream);
    case 4: return launch_group<4, FUSED>(pts, digits, table, nwin, nsteps, nlanes, rows, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// pts (S, B, 2, 8), digits (W, S, B) int32 -> table (W, B, rows, 3, 8)
// reduced; group in [1, GROUP_MAX] (ops/cuda_msm_group.py splits a larger G).
extern "C" int vkzg_msm_group_accumulate(const void* pts, const void* digits, void* table, int nwin,
                                         int64_t nsteps, int64_t nlanes, int rows, int group,
                                         int fused, void* stream) {
  if (nwin < 1 || rows < 1 || group < 1 || group > GROUP_MAX) return (int)cudaErrorInvalidValue;
  if (nlanes == 0) return 0;
  return fused ? launch_group_any<true>(pts, digits, table, nwin, nsteps, nlanes, rows, group,
                                        (cudaStream_t)stream)
               : launch_group_any<false>(pts, digits, table, nwin, nsteps, nlanes, rows, group,
                                         (cudaStream_t)stream);
}
