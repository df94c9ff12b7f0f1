// Tensor-core stages of the 4-layer LVC block: both contractions of a layer
// as bf16 mma.sync.m16n8k16 products with f32 accumulation, over
// activations kept sample-major in shared memory, with the block's widths,
// halo and bf16 helpers. Used by lvc_block_ncl_tc.cu (K1, K2, K4),
// lvc_block_ncl_fh.cu (K5) and lvc_block_nwc_tc.cu (K6), the only LVC block
// kernels; they take hops that are multiples of 8, and the ops in ops/
// raise on a CUDA tensor at any other hop.
//
// Layer i of the block, d = 3^i:
//   s     = carry + skip                       (bf16, zero outside [0, L))
//   y     = leaky0.2(W_i . [a(t-d); a; a(t+d); 1]),  a = leaky0.2(s)
//   z     = K_{i,f} . [y(t-1); y; y(t+1); 1]   (per frame f = t / hop, f32)
//   carry = s + bf16(sigmoid(z[:C]) * tanh(z[C:]))
//
// Every stage is called by all THREADS threads of a block whose extent is
// `ext` samples (the tile's outputs plus HALO on each side), row 0 being
// global sample g0. An activation buffer is [ext][ROW] bf16: one sample's
// C = 32 channels, padded to 80 bytes so that the eight 16-byte rows an
// ldmatrix reads (or a quarter-warp of 16-byte stores writes) fall in
// eight distinct bank groups for any first row. A tap is a shift of rows,
// so ldmatrix takes the B operand of tap k straight from row e + (k-1) d,
// with no im2col copy.
//
// GEMM shapes, output channels as M and samples as N (one n8 tile is 8
// samples, which never straddles two frames when hop % 8 == 0):
//   dilated conv  Y (32 x 8)  = W_i (32 x 96) . A_taps (96 x 8) + b_i
//   LVC           Z (64 x 8)  = K_{i,f} (64 x 96) . Y_taps (96 x 8) + bias_f
// Contraction row r = k * C + c (tap k, channel c), as in wstack_t and
// kern_taug, but at hop 8 the LVC permutes the channels within each tap
// (ypos). W_i is staged to shared memory ([C][WROW]) and held in registers
// through the conv; K_{i,f} is read as A fragments straight from global
// memory, each byte of a slab once per warp pair (16-byte loads at hop 8,
// where every n8 tile is a new frame; else 4-byte loads into the
// fragments' own registers; the two are separate instantiations, so
// neither loop regroups registers), and kept in registers while a warp's
// n8 tiles stay in frame f. Each m16 tile sums its two k16 steps per tap
// in two accumulator chains, added at the end.
//
// Kernel B-SR (K4, lvc_block_ncl_tc.cu with SAVE) also writes what the
// stages hold for the tile's own samples (HALO <= e < HALO + tile, g < L):
// s from skip_add, y from conv_tc's accumulators in channel order (not
// ybuf's ypos order) and the pre-gate z from gate_tile's accumulators, each
// into a (rows, L) plane of one batch row and layer as 4-byte stores of two
// consecutive samples. The stages take SAVE as a template flag that
// defaults off, so K1, K2, K5 and K6 compile as before.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 32;                   // inner channels
constexpr int HALO = 48;                // samples recomputed on each side
constexpr int ROWS = 3 * C + 1;         // augmented contraction rows
constexpr int LAYERS = 4;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float leaky(float v) {
  return v >= 0.0f ? v : 0.2f * v;
}

namespace tc {

constexpr int THREADS = 256;              // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int TILE_MAX = 328;             // output samples per block, at most
constexpr int EXT_MAX = TILE_MAX + 2 * HALO;
constexpr int ROW = 40;                   // bf16 per activation row (32 + 8)
constexpr int WROW = 104;                 // bf16 per staged W_i row (96 + 8)
constexpr int APAD = 27;                  // zero rows around act: 3^(LAYERS-1)
constexpr int YPAD = 1;                   // zero rows around ybuf: the LVC taps
constexpr int SMEM_LIMIT = 232448;

// dynamic shared memory of a block whose extent is `ext` samples: carry,
// act and ybuf with their pad rows, W_i, its bias and the final conv (f32)
__host__ __device__ constexpr int smem_bytes(int ext) {
  return (3 * ext + 2 * APAD + 2 * YPAD) * ROW * 2 + C * WROW * 2 +
         (C + 8 * C) * 4;
}
// two blocks (with the 1 KB the runtime reserves for each) share an SM
static_assert(BLOCKS_PER_SM * (smem_bytes(EXT_MAX) + 1024) <= 233472,
              "two blocks of the largest tile must fit one SM");
static_assert(TILE_MAX % 8 == 0 && HALO % 8 == 0, "n8 tiles start on 8");
static_assert(smem_bytes(EXT_MAX) <= SMEM_LIMIT, "a block's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives row (l & 7) of matrix l >> 3
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// the same, each matrix transposed (rows in shared memory are its columns)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The A fragment (m16 x k16, rows m0 .. m0+15, k 16 ks ..) of a K-major
// operand that lies in shared memory as rows of 64 bf16 along M, one row
// per k, 128-byte swizzled (16-byte chunk c of row k at c ^ (k & 7)) from
// the 1,024-byte-aligned address `base`, as a TMA box of 64 columns with
// the 128-byte swizzle leaves it: ldmatrix.trans reads it in place,
// conflict-free.
__device__ __forceinline__ void a_frag_swz(uint32_t (&a)[4], uint32_t base,
                                           int m0, int ks, int lane) {
  const int j = lane >> 3;
  const int k = 16 * ks + (lane & 7) + 8 * (j >> 1);
  const int chunk = (m0 >> 3) + (j & 1);
  ldsm_x4_trans(a, base + k * 128 + ((chunk ^ (k & 7)) << 4));
}

// d += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ldg128(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// sigmoid(zs) * tanh(zt) in f32 from two exponentials and one reciprocal:
// sign(zt) (1 - e2) / ((1 + e2)(1 + es)), e2 = exp(-2|zt|) (no overflow),
// es = exp(-zs) (an overflow to inf gives the limit 0). ex2 and rcp are the
// hardware's approximations (2 ulp), without denormal fix-ups.
__device__ __forceinline__ float gate(float zs, float zt) {
  constexpr float LOG2E = 1.4426950408889634f;
  const float e2 = ex2_ftz(-2.0f * LOG2E * fabsf(zt));
  const float es = ex2_ftz(-LOG2E * zs);
  return copysignf(1.0f - e2, zt) * rcp_ftz((1.0f + e2) * (1.0f + es));
}

// Where channel c of y sits in a ybuf row. The LVC reads ybuf as the B
// operand in row order, so this order is the contraction order of each
// tap; it is chosen so that lane (g, t)'s A fragments of K_{i,f} for both
// k16 steps of a tap (logical k 2t, 2t+1, 2t+8, 2t+9 of each) are the
// eight channels 8t .. 8t+7 of a kern_taug row: 16 contiguous bytes.
__device__ __forceinline__ int ypos(int c) {
  const int t = c >> 3, i = c & 7;
  return ((i & 4) << 2) + 2 * t + (i & 1) + ((i & 2) << 2);
}

__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    __nv_bfloat162 pair;
    *reinterpret_cast<uint32_t*>(&pair) = w[q];
    const float2 p = __bfloat1622float2(pair);
    f[2 * q] = p.x;
    f[2 * q + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
    w[q] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Zero `rows` rows of ROW bf16 from `p`.
__device__ __forceinline__ void zero_rows(bf16* p, int rows, int tid) {
  for (int idx = tid; idx < rows * ROW / 8; idx += THREADS)
    reinterpret_cast<uint4*>(p)[idx] = make_uint4(0, 0, 0, 0);
}

// Channels 8q .. 8q+7 of samples g, g+1 of a (C, L) NCL batch row (g even,
// L even: one 4-byte load per channel), into v0 and v1; zeros when the
// pair lies outside [0, L).
__device__ __forceinline__ void load_pair(const bf16* __restrict__ src,
                                          long g, int q, int L, bool valid,
                                          float* v0, float* v1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float2 p = make_float2(0.0f, 0.0f);
    if (valid) {
      __nv_bfloat162 pair;
      *reinterpret_cast<uint32_t*>(&pair) = __ldg(
          reinterpret_cast<const unsigned int*>(src + (size_t)(8 * q + j) * L +
                                                g));
      p = __bfloat1622float2(pair);
    }
    v0[j] = p.x;
    v1[j] = p.y;
  }
}

// dst[e] = src[:, g0 + e] of a (C, L) NCL batch row, zero outside [0, L);
// one thread per pair of samples (g0, ext and L are even, so a pair lies
// wholly inside or outside [0, L))
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src,
                                          bf16* dst, long g0, int ext, int L,
                                          int tid) {
  for (int e = 2 * tid; e < ext; e += 2 * THREADS) {
    const long g = g0 + e;
    const bool valid = g >= 0 && g < L;
#pragma unroll
    for (int q = 0; q < C / 8; ++q) {
      float v0[8], v1[8];
      load_pair(src, g, q, L, valid, v0, v1);
      reinterpret_cast<uint4*>(dst + e * ROW)[q] = pack8(v0);
      reinterpret_cast<uint4*>(dst + (e + 1) * ROW)[q] = pack8(v1);
    }
  }
}

// Stage W_i, a (C, 3C+1) row of wstack_t, as ws[o][r] bf16 and its bias
// column as wb[o] f32.
__device__ __forceinline__ void stage_weights(const bf16* __restrict__ w,
                                              bf16* ws, float* wb, int tid) {
  for (int idx = tid; idx < C * ROWS; idx += THREADS) {
    const int o = idx / ROWS, r = idx % ROWS;
    if (r < 3 * C)
      ws[o * WROW + r] = w[idx];
    else
      wb[o] = to_f(w[idx]);
  }
}

// Channels 8q .. 8q+7 of the two sample rows from `rows` (row e, row e+1 of
// a [ext][ROW] buffer) into a (C, L) plane from `dst` (sample g): one 4-byte
// store per channel, sample e in the low half.
__device__ __forceinline__ void store_pair8(const bf16* rows, int q,
                                            bf16* __restrict__ dst,
                                            int L) {
  const uint4 v0 = reinterpret_cast<const uint4*>(rows)[q];
  const uint4 v1 = reinterpret_cast<const uint4*>(rows + ROW)[q];
  const uint32_t w0[4] = {v0.x, v0.y, v0.z, v0.w};
  const uint32_t w1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int sh = 16 * (j % 2);
    const uint32_t pair = ((w0[j / 2] >> sh) & 0xffffu) |
                          (((w1[j / 2] >> sh) & 0xffffu) << 16);
    *reinterpret_cast<uint32_t*>(dst + (size_t)(8 * q + j) * L) = pair;
  }
}

// bf16 pair (lo, hi) as one 32-bit word
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// Whether extent row e (sample g = g0 + e) is one the tile outputs.
__device__ __forceinline__ bool centre(int e, long g, int tile, int L) {
  return e >= HALO && e < HALO + tile && g < L;
}

// s = bf16(carry + skip), zero outside [0, L), into carry; a = bf16(leaky(s))
// into act. `sb` is the (C, L) batch row of skip; one thread per pair of
// samples, as load_rows. With SAVE the tile's own samples also write s into
// the (C, L) plane `s_save`.
template <bool SAVE = false>
__device__ __forceinline__ void skip_add(const bf16* __restrict__ sb,
                                         bf16* carry, bf16* act, long g0,
                                         int ext, int L, int tid,
                                         bf16* __restrict__ s_save = nullptr,
                                         int tile = 0) {
  for (int e = 2 * tid; e < ext; e += 2 * THREADS) {
    const long g = g0 + e;
    const bool valid = g >= 0 && g < L;
    const bool save = SAVE && centre(e, g, tile, L);
#pragma unroll
    for (int q = 0; q < C / 8; ++q) {
      float k0[8], k1[8];
      load_pair(sb, g, q, L, valid, k0, k1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* k = r ? k1 : k0;
        float s[8], a[8];
        uint4* crow = reinterpret_cast<uint4*>(carry + (e + r) * ROW) + q;
        unpack8(*crow, s);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j] = valid ? round_bf(s[j] + k[j]) : 0.0f;
          a[j] = leaky(s[j]);
        }
        *crow = pack8(s);
        reinterpret_cast<uint4*>(act + (e + r) * ROW)[q] = pack8(a);
      }
      if constexpr (SAVE)
        if (save) store_pair8(carry + e * ROW, q, s_save + g, L);
    }
  }
}

// y = bf16(leaky(W_i . [a(t-d); a; a(t+d)] + b_i)), zero outside [0, L),
// into ybuf, each row in the channel order that lvc_gate_tc<WIDE> reads
// (ypos with WIDE). Warp w takes n8 tiles w, w + WARPS, ...; it holds
// W_i's A fragments (2 m16 tiles x 6 k16 steps) in registers. act has APAD
// zero rows on each side, so every tap reads inside the buffer. With SAVE
// the tile's own samples also write y, in channel order, into the (C, L)
// plane `y_save`: a lane holds channel o at two consecutive samples.
template <bool WIDE, bool SAVE = false>
__device__ __forceinline__ void conv_tc(const bf16* act, const bf16* ws,
                                        const float* wb, bf16* ybuf, int d,
                                        long g0, int ext, int L, int warp,
                                        int lane,
                                        bf16* __restrict__ y_save = nullptr,
                                        int tile = 0) {
  uint32_t wa[2][6][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int ks = 0; ks < 6; ++ks)
      ldsm_x4(wa[m][ks], ws + (16 * m + (lane & 15)) * WROW + 16 * ks +
                             (lane >> 4) * 8);
  const int gq = lane >> 2, tq = lane & 3;
  float bias[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    bias[m][0] = wb[16 * m + gq];
    bias[m][1] = wb[16 * m + gq + 8];
  }
  for (int j = warp; j < ext / 8; j += WARPS) {
    const int n0 = 8 * j;
    // two accumulator chains per m16 tile (channels 0-15 and 16-31 of each
    // tap), summed at the end: half the dependent mma depth
    float acc[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      acc[m][0][0] = acc[m][0][1] = bias[m][0];
      acc[m][0][2] = acc[m][0][3] = bias[m][1];
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[m][1][v] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      uint32_t b[4];
      ldsm_x4(b, act + (n0 + (lane & 7) + (k - 1) * d) * ROW +
                     (lane >> 3) * 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(acc[m][0], wa[m][2 * k], b[0], b[1]);
        mma_bf16(acc[m][1], wa[m][2 * k + 1], b[2], b[3]);
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int e = n0 + 2 * tq + c;
      const long g = g0 + e;
      const bool valid = g >= 0 && g < L;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y = acc[m][0][2 * h + c] + acc[m][1][2 * h + c];
          const int o = 16 * m + gq + 8 * h;
          ybuf[e * ROW + (WIDE ? ypos(o) : o)] =
              __float2bfloat16(valid ? leaky(y) : 0.0f);
        }
    }
    if constexpr (SAVE) {
      const int e = n0 + 2 * tq;
      const long g = g0 + e;
      if (centre(e, g, tile, L)) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = 16 * m + gq + 8 * h;
            *reinterpret_cast<uint32_t*>(y_save + (size_t)o * L + g) =
                pack2(leaky(acc[m][0][2 * h] + acc[m][1][2 * h]),
                      leaky(acc[m][0][2 * h + 1] + acc[m][1][2 * h + 1]));
          }
      }
    }
  }
}

// One warp's LVC and gate on the n8 tile of samples n0 .. n0+7, with the
// A fragments `ka` of MT m16 tiles (6 k16 steps each, contraction row
// k C + c) and their bias rows `kb` (rows gq and gq + 8 of each tile) in
// registers: z = ka . [y(t-1); y; y(t+1)] + kb, then carry = s +
// bf16(sigmoid(z_s) tanh(z_t)) in place, for channels from `ch0`. The row
// layout is MT's:
// - MT 2: tile 0 holds the sigmoid rows of channels ch0 .. ch0+15, tile 1
//   their tanh rows (K1, K6: z rows 16p.. and C + 16p..);
// - MT 1: one tile whose rows 0-7 are the sigmoid rows of channels
//   ch0 .. ch0+7 and rows 8-15 their tanh rows (K5's slab).
// Either way both halves of a gate sit in the same lane, so nothing is
// exchanged. With SAVE (MT 2) and a non-null `z_save`, the pre-gate z of
// the tile (f32 sums rounded to bf16) goes to the (2C, L) plane `z_save`,
// offset to the tile's first sample: rows gq and gq + 8 of each m16 tile at
// samples n0 + 2 tq and n0 + 2 tq + 1, one 4-byte store each.
template <int MT, bool SAVE = false>
__device__ __forceinline__ void gate_tile(const uint32_t (&ka)[MT][6][4],
                                          const float (&kb)[MT][2],
                                          const bf16* ybuf, bf16* carry,
                                          int n0, int ch0, int lane,
                                          bf16* __restrict__ z_save = nullptr,
                                          int L = 0) {
  static_assert(MT == 1 || MT == 2, "one or two m16 tiles");
  static_assert(!SAVE || MT == 2, "z is saved from the sigmoid/tanh pair");
  const int gq = lane >> 2, tq = lane & 3;
  // two accumulator chains per m16 tile, as in conv_tc
  float acc[MT][2][4];
#pragma unroll
  for (int mm = 0; mm < MT; ++mm) {
    acc[mm][0][0] = acc[mm][0][1] = kb[mm][0];
    acc[mm][0][2] = acc[mm][0][3] = kb[mm][1];
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[mm][1][v] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uint32_t b[4];
    ldsm_x4(b, ybuf + (n0 + (lane & 7) + k - 1) * ROW + (lane >> 3) * 8);
#pragma unroll
    for (int mm = 0; mm < MT; ++mm) {
      mma_bf16(acc[mm][0], ka[mm][2 * k], b[0], b[1]);
      mma_bf16(acc[mm][1], ka[mm][2 * k + 1], b[2], b[3]);
    }
  }
  if constexpr (SAVE) {
    if (z_save != nullptr) {
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = C * mm + ch0 + gq + 8 * h;
          *reinterpret_cast<uint32_t*>(z_save + (size_t)row * L + 2 * tq) =
              pack2(acc[mm][0][2 * h] + acc[mm][1][2 * h],
                    acc[mm][0][2 * h + 1] + acc[mm][1][2 * h + 1]);
        }
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int e = n0 + 2 * tq + c;
#pragma unroll
    for (int h = 0; h < MT; ++h) {
      // MT 2: accumulator 2h + c of each tile; MT 1: c and 2 + c of one
      const int vs = MT == 2 ? 2 * h + c : c;
      const int vt = MT == 2 ? vs : 2 + c;
      bf16* cp = carry + e * ROW + ch0 + gq + 8 * h;
      const float gv = gate(acc[0][0][vs] + acc[0][1][vs],
                            acc[MT - 1][0][vt] + acc[MT - 1][1][vt]);
      *cp = __float2bfloat16(to_f(*cp) + round_bf(gv));
    }
  }
}

// z = K_{i,f} . [y(t-1); y; y(t+1)] + bias_f (f32), then carry = s +
// bf16(sigmoid(z[:C]) * tanh(z[C:])) in place (carry holds s). Warp w owns
// the m16 pair p = w & 1 (z rows 16p.. and C + 16p.., so each lane holds
// both halves of its gates) over a contiguous run of n8 tiles; the pair's
// A fragments of K_{i,f} (and the bias column) are loaded from global
// memory when the run enters a new frame: with WIDE (hop 8, a new frame
// every tile) as 16-byte loads, else as 4-byte loads straight into the
// fragments' registers. `kern_b` is the batch row of kern_taug (F, layers,
// 2C, rows_p). With SAVE, n8 tiles of the tile's own samples write z into
// the (2C, L) plane `z_plane` (gate_tile); a warp's run of tiles is
// contiguous, so it fills each 32-byte sector of a z row in two
// consecutive tiles.
template <bool WIDE, bool SAVE = false>
__device__ __forceinline__ void lvc_gate_tc(const bf16* __restrict__ kern_b,
                                            int layer, const bf16* ybuf,
                                            bf16* carry, int rows_p, int hop,
                                            int F, long g0, int ext,
                                            int warp, int lane,
                                            bf16* __restrict__ z_plane =
                                                nullptr,
                                            int tile = 0) {
  const int p = warp & 1;
  const int runs = WARPS / 2;
  const int nt = ext / 8;
  const int per = (nt + runs - 1) / runs;
  const int j0 = (warp >> 1) * per;
  const int j1 = min(nt, j0 + per);
  const int gq = lane >> 2, tq = lane & 3;
  uint32_t ka[2][6][4];
  float kb[2][2];
  // the frame of the run's first tile (samples before 0 use frame 0), then
  // stepped: tiles advance by 8 <= hop samples, so by at most one frame
  const int gfirst = static_cast<int>(g0) + 8 * j0;
  int f = gfirst < 0 ? 0 : gfirst / hop;
  int fend = (f + 1) * hop;  // first sample of frame f + 1
  int cur = -1;
  for (int j = j0; j < j1; ++j) {
    const int n0 = 8 * j;
    if (static_cast<int>(g0) + n0 >= fend) {
      ++f;
      fend += hop;
    }
    const int fc = min(f, F - 1);
    if (fc != cur) {
      cur = fc;
      const bf16* ki =
          kern_b + ((size_t)fc * LAYERS + layer) * 2 * C * (size_t)rows_p;
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        const bf16* r0 = ki + (size_t)(16 * p + C * mm + gq) * rows_p;
        const bf16* r1 = r0 + 8 * (size_t)rows_p;
        if (WIDE) {
          // a new frame every tile (hop 8): channels 8t .. 8t+7 of each tap hold
          // both k16 steps' fragments (ypos), one 16-byte load per row
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const uint4 u = ldg128(r0 + k * C + 8 * tq);
            const uint4 v = ldg128(r1 + k * C + 8 * tq);
            ka[mm][2 * k][0] = u.x;
            ka[mm][2 * k][1] = v.x;
            ka[mm][2 * k][2] = u.y;
            ka[mm][2 * k][3] = v.y;
            ka[mm][2 * k + 1][0] = u.z;
            ka[mm][2 * k + 1][1] = v.z;
            ka[mm][2 * k + 1][2] = u.w;
            ka[mm][2 * k + 1][3] = v.w;
          }
        } else {
          // frames last several tiles: 4-byte loads straight into the
          // fragments' registers (no regrouping in the loop), channels in
          // their own order
#pragma unroll
          for (int ks = 0; ks < 6; ++ks) {
            ka[mm][ks][0] = ldg32(r0 + 16 * ks + 2 * tq);
            ka[mm][ks][1] = ldg32(r1 + 16 * ks + 2 * tq);
            ka[mm][ks][2] = ldg32(r0 + 16 * ks + 8 + 2 * tq);
            ka[mm][ks][3] = ldg32(r1 + 16 * ks + 8 + 2 * tq);
          }
        }
        kb[mm][0] = to_f(r0[3 * C]);
        kb[mm][1] = to_f(r1[3 * C]);
      }
    }
    if constexpr (SAVE) {
      // an n8 tile lies wholly inside or outside the tile's own samples
      // (HALO, tile and L are multiples of 8)
      const int L = F * hop;
      const long g = g0 + n0;
      gate_tile<2, true>(ka, kb, ybuf, carry, n0, 16 * p, lane,
                         centre(n0, g, tile, L) ? z_plane + g : nullptr, L);
    } else {
      gate_tile<2>(ka, kb, ybuf, carry, n0, 16 * p, lane);
    }
  }
}

// The model's final k=7 C->1 conv over the carry masked to [0, L), f32,
// for the tile's own samples (rows HALO .. HALO + tile): fin[g] = wf[7, 0]
// + sum_{tap, c} carry[c, g + tap - 3] * wf[tap, c].
__device__ __forceinline__ void final_conv_rows(const bf16* carry,
                                                const float* wf,
                                                float* __restrict__ fin_b,
                                                long g0, int tile, int L,
                                                int tid) {
  for (int e = HALO + tid; e < HALO + tile; e += THREADS) {
    const long g = g0 + e;
    if (g >= L) break;
    float acc = wf[7 * C];
#pragma unroll
    for (int tap = 0; tap < 7; ++tap) {
      const long gs = g + tap - 3;
      if (gs < 0 || gs >= L) continue;
      const bf16* src = carry + (e + tap - 3) * ROW;
#pragma unroll
      for (int q = 0; q < C / 8; ++q) {
        float v[8];
        unpack8(reinterpret_cast<const uint4*>(src)[q], v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc = fmaf(v[j], wf[tap * C + 8 * q + j], acc);
      }
    }
    fin_b[g] = acc;
  }
}

// out[:, g] = carry[e] for the tile's own samples, into a (C, L) batch row;
// one thread per pair of samples (one 4-byte store per channel)
__device__ __forceinline__ void store_rows(const bf16* carry,
                                           bf16* __restrict__ ob, long g0,
                                           int tile, int L, int tid) {
  for (int e = HALO + 2 * tid; e < HALO + tile; e += 2 * THREADS) {
    const long g = g0 + e;
    if (g >= L) break;
#pragma unroll
    for (int q = 0; q < C / 8; ++q) store_pair8(carry + e * ROW, q, ob + g, L);
  }
}

}  // namespace tc
}  // namespace
