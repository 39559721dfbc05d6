// FSX: one Fiat-Shamir challenge of the IPA prove drawn on the card in one
// launch, and the device SHA-256 behind ops/sha256.py. See
// ops/cuda_fiat_shamir.py for what it replaces and why it is shaped so.
//
// A message is up to MAX_SEGS segments, in order: bytes in device memory
// (the transcript state), constant bytes passed in the arguments (labels),
// an Fr element in Montgomery form (serialized as its 32 little-endian
// standard-form bytes) or a projective G1 point (converted to affine and
// compressed, as hostmath/serialize.py::g1_to_compressed_bytes does). One
// warp runs the launch: lane 0 converts the points (Montgomery's trick over
// their Z, one inversion), the lanes build each 64-byte block's sixteen
// words from the segments, and lane 0 runs the block's compression. The
// message is never assembled: a byte is read from its segment where the
// block needs it, so a state of any length streams through.
//
// Modes: the SHA-256 digest of the message; RFC 9380 expand_message_xmd of
// it to out_len bytes; or the field element hash_to_fr(message, dst) in
// standard and Montgomery form, with the transcript's new state
// fr_to_bytes(x) || label and the points' affine words at slot `slot` of
// the proof buffer.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn254_field.cuh"
#include "field_inv.cuh"

using namespace vkzg;

namespace {

constexpr int MAX_SEGS = 8;
constexpr int MAX_POINTS = 4;
constexpr int POOL = 320;
constexpr int MAX_PIECES = MAX_SEGS + 4;
constexpr int FR_HASH_LEN = 48;

enum { SEG_BYTES = 0, SEG_CONST = 1, SEG_FR = 2, SEG_POINT = 3 };
enum { MODE_DIGEST = 0, MODE_EXPAND = 1, MODE_FIELD = 2 };

// The launch's description, passed by value (ops/cuda_fiat_shamir.py::_Args
// mirrors it): segment s is `len` bytes of device memory at `ptr`
// (SEG_BYTES), `len` bytes of `pool` at `off` (SEG_CONST), or the element
// or point at `ptr` (32 bytes once serialized).
struct Seg {
  int32_t kind, len, off, pad;
  const void* ptr;
};

struct Args {
  Seg seg[MAX_SEGS];
  int32_t nseg, mode, out_len, dst_off, dst_len, label_off, label_len, slot;
  uint8_t pool[POOL];
};

__constant__ uint32_t K256[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u, 0x923f82a4u,
    0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu,
    0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu,
    0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u,
    0xc6e00bf3u, 0xd5a79147u, 0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
    0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u,
    0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu, 0x682e6ff3u,
    0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u, 0x90befffau, 0xa4506cebu, 0xbef9a3f7u,
    0xc67178f2u};

__constant__ uint32_t H0[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                               0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};

// A run of message bytes in shared or device memory (a generic pointer).
struct Piece {
  const uint8_t* p;
  int64_t len;
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int r) { return __funnelshift_r(x, x, r); }

// Byte i of the padded message of `total` bytes made of the pieces.
__device__ uint8_t msg_byte(const Piece* pc, int np, int64_t i, int64_t total, int64_t padded) {
  if (i < total) {
    for (int j = 0; j < np; ++j) {
      if (i < pc[j].len) return pc[j].p[i];
      i -= pc[j].len;
    }
    return 0;
  }
  if (i == total) return 0x80;
  if (i >= padded - 8) return (uint8_t)(((uint64_t)total * 8) >> (8 * (padded - 1 - i)));
  return 0;
}

// FIPS 180-4 compression of the block words w[0..15] into h, on one lane.
__device__ void compress(uint32_t* h, uint32_t* w) {
  for (int t = 16; t < 64; ++t) {
    const uint32_t s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3);
    const uint32_t s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10);
    w[t] = w[t - 16] + s0 + w[t - 7] + s1;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll 4
  for (int t = 0; t < 64; ++t) {
    const uint32_t t1 = hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) +
                        K256[t] + w[t];
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

// out[0..31] (shared) = SHA-256 of the pieces' concatenation. Every lane
// of the warp calls: lanes 0-15 build a block's words, lane 0 compresses.
__device__ void sha256_pieces(const Piece* pc, int np, uint8_t* out, uint32_t* w, uint32_t* h) {
  const int lane = threadIdx.x;
  int64_t total = 0;
  for (int j = 0; j < np; ++j) total += pc[j].len;
  const int64_t padded = (total + 9 + 63) / 64 * 64;
  if (lane < 8) h[lane] = H0[lane];
  for (int64_t blk = 0; blk < padded; blk += 64) {
    __syncwarp();  // the previous block's compression is done with w
    if (lane < 16) {
      uint32_t v = 0;
      for (int k = 0; k < 4; ++k) v = (v << 8) | msg_byte(pc, np, blk + 4 * lane + k, total, padded);
      w[lane] = v;
    }
    __syncwarp();
    if (lane == 0) compress(h, w);
  }
  __syncwarp();
  if (lane < 8) {
    const uint32_t v = h[lane];
    out[4 * lane] = (uint8_t)(v >> 24);
    out[4 * lane + 1] = (uint8_t)(v >> 16);
    out[4 * lane + 2] = (uint8_t)(v >> 8);
    out[4 * lane + 3] = (uint8_t)v;
  }
  __syncwarp();
}

__device__ __forceinline__ void load_words(uint32_t r[8], const uint32_t* p) {
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = p[j];
}

__device__ __forceinline__ void le_bytes(uint8_t* out, const uint32_t v[8]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) out[j] = (uint8_t)(v[j / 4] >> (8 * (j % 4)));
}

// Montgomery -> standard form: the Montgomery product by the integer 1.
template <class F>
__device__ __forceinline__ void from_mont(uint32_t r[8], const uint32_t a[8]) {
  const uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  fmul<F, false>(r, a, one);
}

// Compressed bytes of a Montgomery affine point, (0, 0) for infinity:
// standard-form x little-endian, byte 31's bit 7 when y > -y (y > (q-1)/2),
// bit 6 for infinity.
__device__ void compress_point(uint8_t* out, const uint32_t x[8], const uint32_t y[8]) {
  const uint32_t q_half[8] = {0x6c3e7ea3u, 0x9e10460bu, 0xb438e546u, 0xcbc0b548u,
                              0x40c0ac2eu, 0xdc2822dbu, 0x7098d014u, 0x18322739u};
  const bool inf = is_zero(x) && is_zero(y);
  uint32_t xs[8], ys[8], d[8];
  from_mont<Fq>(xs, x);
  from_mont<Fq>(ys, y);
  const bool neg = sub_raw(d, q_half, ys) != 0;
  le_bytes(out, xs);
  out[31] |= inf ? 0x40 : (neg ? 0x80 : 0);
}

// Lane 0: the Fr elements' standard-form bytes and the points' compressed
// bytes into ser[s], and the points' affine words into `pairs` (null: not
// kept). Z = 0 takes one in the product and gives (0, 0).
__device__ void serialize(const Args& a, uint8_t (*ser)[32], uint32_t (*pre)[8], uint32_t (*zz)[8],
                          uint32_t* pairs) {
  uint32_t acc[8], v[8], z[8];
  int np = 0;
  for (int j = 0; j < 8; ++j) acc[j] = Fq::one(j);
  for (int s = 0; s < a.nseg; ++s) {
    const uint32_t* p = (const uint32_t*)a.seg[s].ptr;
    if (a.seg[s].kind == SEG_FR) {
      load_words(v, p);
      from_mont<Fr>(v, v);
      le_bytes(ser[s], v);
    } else if (a.seg[s].kind == SEG_POINT) {
      load_words(z, p + 16);
      if (is_zero(z))
        for (int j = 0; j < 8; ++j) z[j] = Fq::one(j);
      fmul<Fq, false>(acc, acc, z);
      for (int j = 0; j < 8; ++j) {
        zz[np][j] = z[j];
        pre[np][j] = acc[j];
      }
      ++np;
    }
  }
  if (np == 0) return;
  uint32_t inv[8], zi[8], x[8], y[8];
  finv<Fq>(inv, acc);  // inv = (prod z)^-1
  for (int s = a.nseg - 1, k = np - 1; s >= 0; --s) {
    if (a.seg[s].kind != SEG_POINT) continue;
    const uint32_t* p = (const uint32_t*)a.seg[s].ptr;
    if (k > 0) {
      for (int j = 0; j < 8; ++j) v[j] = pre[k - 1][j];
      fmul<Fq, false>(zi, inv, v);  // z_k^-1
      for (int j = 0; j < 8; ++j) v[j] = zz[k][j];
      fmul<Fq, false>(inv, inv, v);  // (prod of z below k)^-1
    } else {
      for (int j = 0; j < 8; ++j) zi[j] = inv[j];
    }
    load_words(z, p + 16);
    if (is_zero(z))
      for (int j = 0; j < 8; ++j) zi[j] = 0;
    load_words(x, p);
    load_words(y, p + 8);
    fmul<Fq, false>(x, x, zi);
    fmul<Fq, false>(y, y, zi);
    compress_point(ser[s], x, y);
    if (pairs) {
      uint32_t* o = pairs + 16 * ((int64_t)a.slot * np + k);
      for (int j = 0; j < 8; ++j) {
        o[j] = x[j];
        o[8 + j] = y[j];
      }
    }
    --k;
  }
}

__global__ void __launch_bounds__(32)
    fsx_kernel(const __grid_constant__ Args a, uint8_t* out_bytes, uint32_t* x_out, uint8_t* state_out,
               uint32_t* pairs) {
  __shared__ uint8_t pool[POOL];
  __shared__ uint8_t ser[MAX_SEGS][32];
  __shared__ uint32_t pre[MAX_POINTS][8], zz[MAX_POINTS][8];
  __shared__ uint8_t zeros[64], misc[8], b0[32], bi[32], xb[32], uniform[FR_HASH_LEN];
  __shared__ uint32_t w[64], h[8];
  __shared__ Piece pc[MAX_PIECES];
  const int lane = threadIdx.x;

  for (int i = lane; i < POOL; i += 32) pool[i] = a.pool[i];
  for (int i = lane; i < 64; i += 32) zeros[i] = 0;
  if (lane == 0) serialize(a, ser, pre, zz, a.mode == MODE_FIELD ? pairs : nullptr);
  __syncwarp();

  int np = 0;
  if (lane == 0) {
    if (a.mode != MODE_DIGEST) pc[np++] = Piece{zeros, 64};
    for (int s = 0; s < a.nseg; ++s) {
      const Seg& g = a.seg[s];
      if (g.kind == SEG_BYTES) pc[np++] = Piece{(const uint8_t*)g.ptr, g.len};
      else if (g.kind == SEG_CONST) pc[np++] = Piece{pool + g.off, g.len};
      else pc[np++] = Piece{ser[s], 32};
    }
    if (a.mode != MODE_DIGEST) {  // l_i_b_str || I2OSP(0, 1) || DST || I2OSP(len(DST), 1)
      misc[0] = (uint8_t)(a.out_len >> 8);
      misc[1] = (uint8_t)a.out_len;
      misc[2] = 0;
      misc[3] = (uint8_t)a.dst_len;
      pc[np++] = Piece{misc, 3};
      pc[np++] = Piece{pool + a.dst_off, a.dst_len};
      pc[np++] = Piece{misc + 3, 1};
    }
  }
  np = __shfl_sync(0xffffffffu, np, 0);
  __syncwarp();
  if (a.mode == MODE_DIGEST) {
    sha256_pieces(pc, np, b0, w, h);
    if (lane < 32) out_bytes[lane] = b0[lane];
    return;
  }
  sha256_pieces(pc, np, b0, w, h);  // b_0

  const int ell = (a.out_len + 31) / 32;
  for (int i = 1; i <= ell; ++i) {  // b_i = H((b_0 ^ b_(i-1)) || I2OSP(i, 1) || DST')
    xb[lane] = i == 1 ? b0[lane] : (uint8_t)(b0[lane] ^ bi[lane]);
    if (lane == 0) {
      misc[4] = (uint8_t)i;
      pc[0] = Piece{xb, 32};
      pc[1] = Piece{misc + 4, 1};
      pc[2] = Piece{pool + a.dst_off, a.dst_len};
      pc[3] = Piece{misc + 3, 1};
    }
    __syncwarp();
    sha256_pieces(pc, 4, bi, w, h);
    const int at = 32 * (i - 1) + lane;
    if (at < a.out_len) {
      if (a.mode == MODE_EXPAND) out_bytes[at] = bi[lane];
      else uniform[at] = bi[lane];
    }
    __syncwarp();
  }
  if (a.mode == MODE_EXPAND || lane != 0) return;

  // x = hi 2^192 + lo mod r, for the big-endian halves hi = uniform[0..24),
  // lo = uniform[24..48): the Montgomery product of hi by 2^192 R, then lo.
  const uint32_t c192[8] = {0xc177f51au, 0x5665c3b5u, 0xde75c713u, 0x00e7f02au,
                            0x2f747168u, 0xb09192e5u, 0xcccdc65du, 0x0621c0bbu};
  const uint32_t r2[8] = {0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u,
                          0x53bb8085u, 0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u};
  uint32_t hi[8], lo[8], x[8], xm[8];
  for (int j = 0; j < 8; ++j) {
    hi[j] = lo[j] = 0;
    if (j < 6)
      for (int k = 0; k < 4; ++k) {
        hi[j] |= (uint32_t)uniform[23 - 4 * j - k] << (8 * k);
        lo[j] |= (uint32_t)uniform[47 - 4 * j - k] << (8 * k);
      }
  }
  fmul<Fr, false>(x, hi, c192);
  fadd<Fr, false>(x, x, lo);
  fmul<Fr, false>(xm, x, r2);
  for (int j = 0; j < 8; ++j) {
    x_out[j] = x[j];
    x_out[8 + j] = xm[j];
  }
  if (state_out) {
    le_bytes(state_out, x);
    for (int j = 0; j < a.label_len; ++j) state_out[32 + j] = pool[a.label_off + j];
  }
}

// One affine point a thread: (n, 2, 8) Montgomery words -> (n, 32) bytes.
__global__ void __launch_bounds__(128) fsx_compress_kernel(const uint32_t* aff, uint8_t* out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8];
  load_words(x, aff + 16 * i);
  load_words(y, aff + 16 * i + 8);
  uint8_t b[32];
  compress_point(b, x, y);
  for (int j = 0; j < 32; ++j) out[32 * i + j] = b[j];
}

}  // namespace

// args: a host pointer to the launch's Args. out_bytes: the digest (32
// bytes) or the expanded bytes (out_len); x_out: (2, 8) words, standard
// then Montgomery; state_out: 32 + label_len bytes or null; pairs: the
// (K, P, 2, 8) affine proof buffer or null (field mode only).
extern "C" int vkzg_fsx(const void* args, void* out_bytes, void* x_out, void* state_out, void* pairs,
                        void* stream) {
  const Args* a = (const Args*)args;
  int points = 0;
  if (a->nseg < 0 || a->nseg > MAX_SEGS || a->mode < MODE_DIGEST || a->mode > MODE_FIELD)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < a->nseg; ++s) {
    const Seg& g = a->seg[s];
    if (g.kind == SEG_POINT) ++points;
    if (g.kind == SEG_CONST && (g.off < 0 || g.len < 0 || g.off + g.len > POOL)) return (int)cudaErrorInvalidValue;
  }
  if (points > MAX_POINTS || a->dst_off < 0 || a->dst_len < 0 || a->dst_len > 255 ||
      a->dst_off + a->dst_len > POOL || a->label_off < 0 || a->label_off + a->label_len > POOL ||
      (a->mode == MODE_FIELD && a->out_len != FR_HASH_LEN) || a->out_len < 0 || a->out_len > 255 * 32)
    return (int)cudaErrorInvalidValue;
  fsx_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(*a, (uint8_t*)out_bytes, (uint32_t*)x_out,
                                                 (uint8_t*)state_out, (uint32_t*)pairs);
  return (int)cudaGetLastError();
}

extern "C" int vkzg_fsx_compress(const void* aff, void* out, int64_t n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  fsx_compress_kernel<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)aff, (uint8_t*)out, n);
  return (int)cudaGetLastError();
}
