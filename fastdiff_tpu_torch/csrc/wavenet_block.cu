// DiffWave's whole residual block (models/wavenet.py), one launch per block
// and reverse step, for 64 residual and 64 skip channels and 80 mel bins:
//
//   a    = bf16(x + t_n)               t_n = fc_t(t_emb), (B, 64) f32
//   z    = [W_dil | W_mel] . [a(t - d); a(t); a(t + d); cond(t)]
//          + b_dil + b_mel             (128 x 272) . (272 x L), f32 sums
//   out  = bf16(tanh(z[:64]) * sigmoid(z[64:]))
//   r    = bf16(b_res + W_res . out),  s = bf16(b_skip + W_skip . out)
//   x'   = (x + r) * sqrt(1/2)         f32
//   skip_sum += s                      f32
//
// cond is the block's two mel upsamplers (the stages of csrc/wavenet_cond.cuh:
// cuDNN's conditioning bit for bit), and a is zero
// outside [0, L) (the conv pads a, not x). Block 0 takes x in bf16, as the
// init conv leaves it: a = bf16(x + bf16(t_n)) and x' = bf16(x + r) *
// sqrt(1/2), the bf16 adds of models/wavenet.py, and it writes skip_sum
// (skip_read 0) where later blocks add into it. The last block writes no x'
// (x_out NULL): the forward never reads it.
//
// Rounding against the plain route (ops/wavenet_block.py:wavenet_block_plain):
// the dilated conv and the mel projection share one f32 sum here, where the
// plain route rounds each to bf16 and rounds their sum again; the gate is
// computed in f32 from the f32 sum, where the plain route rounds z, tanh,
// sigmoid and their product to bf16. So the kernel rounds z and the gate
// once, to out's bf16, and never more often than the plain route; r, s, x'
// and skip_sum round where the plain route rounds them.
//
// Replaces no TPU kernel: fastdiff_tpu/models/wavenet.py leaves the block
// to XLA. It was added because on an H100 the block's plain ops were 95 % of
// DiffWave's device time: f32 adds, casts and copies around cuDNN convs at
// f32 / TF32 rates, every intermediate through device memory.
//
// What bounds it: at b 16 x 229,376 samples, x and skip_sum (f32, 64
// channels each) are each read and written: 3.76 GB, 1.12 ms at 3.35 TB/s.
// The two GEMMs are 2 x 128 x 336 FLOP a sample, 316 GFLOP, 0.32 ms at the
// bf16 tensor-core peak, so the bytes bound it.
//
// Design:
// - One block an SM (persistent grid) stages every weight once, rounded to
//   bf16: [W_dil | W_mel] as 128 rows of 272 (taps k = 0, 1, 2 of the 64
//   channels, then the 80 bins) and [W_res; W_skip] as 128 rows of 64, each
//   row padded so that ldmatrix reads no bank twice.
// - The block's threads form GROUPS groups of 128 that run independent tile
//   pipelines (named barriers, no __syncthreads in the loop), so one group's
//   loads overlap another's tensor-core work. Group g of block c takes the
//   tiles (i gridDim.x + c) GROUPS + g: all groups walk the sequence in
//   order, so the shifted windows of x are read from L2 by the neighbours.
// - A tile is TILE samples of one batch row. The group loads a (f32 x +
//   t_n, rounded) into a sample-major bf16 window: rows [t0 - e, t0 + TILE
//   + e) with e = d rounded up to 8 where d <= TILE, else three segments of
//   TILE rows at t0 - d, t0, t0 + d; tap k then starts at a fixed row, and
//   every ldmatrix row stays 16-byte aligned for any d. A warp loads 8
//   chunks of 8 samples of 4 channel pairs at once (lane: chunk, pair), so
//   one load instruction touches 8 cache lines where lanes spread over 32
//   channels would touch 32; the window's 16-byte column chunks are XOR-
//   swizzled by row / 8, so that those lanes' transposed stores, and
//   ldmatrix's reads of 8 rows, fall in distinct banks. Then the group
//   stages the mel and builds the conditioning tile [TILE][80].
// - GEMM 1 on mma.sync.m16n8k16 (bf16 in, f32 accumulate), samples as M:
//   warp (wm, wn) owns samples 32 wm .. 32 wm + 31 and channels 32 wn .. of
//   both halves of z, so tanh and sigmoid of one output channel meet in one
//   thread's registers. The gate (one reciprocal, see gate()) goes to
//   shared memory as bf16 [TILE][64]
//   (in the conditioning tile's place), the A operand of GEMM 2, whose warp
//   (wm, wn) owns the same samples and outputs 64 wn .. (res or skip).
// - The bf16 r and s go to shared memory channel-major (in the window's
//   place); the group then reads x and skip_sum with 16-byte loads along
//   the samples, all of a thread's 16 in flight at once, updates them in
//   f32 and writes them back: x' to x_out (another buffer: neighbouring
//   tiles still read x), skip_sum in place.
// - Tried on the card and left out (b 16 x 896, ten dilations): a bulk L2
//   prefetch of the next tile's window and this tile's skip rows (+10 %),
//   the skip sum by bulk reduce-add from shared memory (+42 %), two groups
//   a block (+13 %), a gate with two correctly rounded reciprocals (+17 %).
// - No host sync, no allocation: the launch is captured in CUDA graphs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wavenet_cond.cuh"

namespace {
namespace wb {

using namespace wcond;

constexpr int C = 64;                 // residual channels
constexpr int CH2 = 2 * C;            // dilated-conv outputs (z)
constexpr int CS = 64;                // skip channels
constexpr int NOUT = C + CS;          // GEMM 2 outputs: res, then skip
constexpr int TILE = 64;              // samples per tile of a group
constexpr int GT = 128;               // threads per group
constexpr int GROUPS = 3;             // groups per block
constexpr int THREADS = GROUPS * GT;
constexpr int KX = 3 * C;             // the dilated conv's contraction
constexpr int K1 = KX + NM;           // GEMM 1's contraction (272)
constexpr int WROW = K1 + 8;          // bf16 per [W_dil | W_mel] row
constexpr int W2ROW = C + 8;          // bf16 per [W_res; W_skip] row
constexpr int XROW = C + 8;           // bf16 per window row
constexpr int XROWS = 3 * TILE;       // window rows at most
constexpr int CROW = NM + 8;          // bf16 per conditioning row
constexpr int OROW = C + 8;           // bf16 per gate row (cs's place)
constexpr int SROW = TILE + 8;        // bf16 per r / s row (the window's place)
constexpr float SQRT_HALF = 0.70710678118654752f;
static_assert(GT == 128 && TILE == 64,
              "warp (wm, wn): 2 x 32 samples, 2 x 32 channels");
static_assert(K1 % 16 == 0 && KX % 16 == 0, "k16 steps");

// bytes of one group's region and of the block's dynamic shared memory:
// the two weight tiles (bf16), GROUPS regions (the window, the
// conditioning tile, the stage-1 and mel rows), then the upsamplers' taps,
// the biases and the upsampler biases (f32, padded to 16 bytes)
template <int S>
struct Layout {
  static constexpr int NP = CondGeo<S, TILE>::NP;
  static constexpr int NF = CondGeo<S, TILE>::NF;
  static constexpr int XS = 2 * XROWS * XROW;
  static constexpr int CSB = 2 * TILE * CROW;
  static constexpr int GROUP = (XS + CSB + 4 * UROW * (NP + NF) + 127) / 128 * 128;
  static constexpr int WA = 2 * CH2 * WROW;
  static constexpr int WO = 2 * NOUT * W2ROW;
  static constexpr int BYTES =
      WA + WO + GROUPS * GROUP + 4 * (2 * 3 * 2 * S + CH2 + NOUT) + 16;
  static_assert(2 * NOUT * SROW <= XS && 2 * TILE * OROW <= CSB,
                "r / s and the gate fit in the places they reuse");
};

// the tile walk and the window of one launch (host-computed, so that they
// sit in the constant bank rather than in registers): where d <= TILE the
// window is [t0 - e, t0 + TILE + e), e = d rounded up to 8, else three
// segments of TILE rows at t0 - d, t0, t0 + d (e = 0); tap k starts at row
// tap[k]
struct Geometry {
  int contiguous, e, nrows, tap[3], tiles_per_row, tiles;
};

Geometry geometry(int B, int L, int d) {
  Geometry g;
  g.contiguous = d <= TILE;
  g.e = g.contiguous ? (d + 7) / 8 * 8 : 0;
  g.nrows = g.contiguous ? TILE + 2 * g.e : 3 * TILE;
  g.tap[0] = g.contiguous ? g.e - d : 0;
  g.tap[1] = g.contiguous ? g.e : TILE;
  g.tap[2] = g.contiguous ? g.e + d : 2 * TILE;
  g.tiles_per_row = (L + TILE - 1) / TILE;
  g.tiles = B * g.tiles_per_row;
  return g;
}

__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(GT) : "memory");
}

// tanh(a) sigmoid(b) in f32 (relative error under 2e-6, a thousandth of
// half a bf16 step), with one approximate reciprocal:
// e = exp(-2 |a|), f = exp(-b), tanh(a) = sign(a) (1 - e) / (1 + e) and
// sigmoid(b) = 1 / (1 + f), so the gate is sign(a) (1 - e) / ((1 + e)(1 +
// f)); below |a| = 1/16, where 1 - e would lose a's leading bits, tanh's
// series to a^5 times (1 + e) takes 1 - e's place. f = inf (b < -88)
// gives 0, sigmoid's limit.
__device__ __forceinline__ float gate(float a, float b) {
  const float e = __expf(-2.0f * fabsf(a));
  const float f = __expf(-b);
  const float a2 = a * a;
  const float num =
      fabsf(a) < 0.0625f
          ? a * (1.0f + a2 * (-1.0f / 3.0f + a2 * (2.0f / 15.0f))) * (1.0f + e)
          : copysignf(1.0f - e, a);
  return __fdividef(num, (1.0f + e) * (1.0f + f));
}

// 8 samples of two channels of x at pos (f32, or bf16 where xbf), plus
// t_n (p0, p1), rounded to bf16: the window's 8 rows of one channel pair
__device__ __forceinline__ void load_pair(__nv_bfloat162 (&v)[8],
                                          const void* x, size_t off0,
                                          size_t off1, bool xbf, float p0,
                                          float p1) {
  if (xbf) {
    const uint4 q0 = *reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(x) + off0);
    const uint4 q1 = *reinterpret_cast<const uint4*>(
        static_cast<const bf16*>(x) + off1);
    const bf16* a0 = reinterpret_cast<const bf16*>(&q0);
    const bf16* a1 = reinterpret_cast<const bf16*>(&q1);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __floats2bfloat162_rn(__bfloat162float(a0[e]) + p0,
                                   __bfloat162float(a1[e]) + p1);
  } else {
    const float4* f0 =
        reinterpret_cast<const float4*>(static_cast<const float*>(x) + off0);
    const float4* f1 =
        reinterpret_cast<const float4*>(static_cast<const float*>(x) + off1);
    const float4 a = f0[0], b = f0[1], c = f1[0], d = f1[1];
    v[0] = __floats2bfloat162_rn(a.x + p0, c.x + p1);
    v[1] = __floats2bfloat162_rn(a.y + p0, c.y + p1);
    v[2] = __floats2bfloat162_rn(a.z + p0, c.z + p1);
    v[3] = __floats2bfloat162_rn(a.w + p0, c.w + p1);
    v[4] = __floats2bfloat162_rn(b.x + p0, d.x + p1);
    v[5] = __floats2bfloat162_rn(b.y + p0, d.y + p1);
    v[6] = __floats2bfloat162_rn(b.z + p0, d.z + p1);
    v[7] = __floats2bfloat162_rn(b.w + p0, d.w + p1);
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1)
wavenet_block_kernel(const void* __restrict__ x, float* __restrict__ x_out,
                     float* __restrict__ skip, const float* __restrict__ part_t,
                     const bf16* __restrict__ mel,
                     const float* __restrict__ wd, const float* __restrict__ bd,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ wm, const float* __restrict__ bm,
                     const float* __restrict__ wr, const float* __restrict__ br,
                     const float* __restrict__ wk, const float* __restrict__ bk,
                     int L, int T, int d, int x_bf16, int skip_read,
                     const Geometry geo) {
  using Y = Layout<S>;
  constexpr int W2S = 3 * 2 * S;        // one upsampler's taps
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* wa = reinterpret_cast<bf16*>(smem_raw);           // [CH2][WROW]
  bf16* wo = wa + CH2 * WROW;                             // [NOUT][W2ROW]
  unsigned char* groups = smem_raw + Y::WA + Y::WO;
  float* wup = reinterpret_cast<float*>(groups + GROUPS * Y::GROUP);
  float* bias1 = wup + 2 * W2S;                           // b_dil + b_mel
  float* bias2 = bias1 + CH2;                             // b_res, b_skip
  float* bup = bias2 + NOUT;                              // [4]

  const int tid = threadIdx.x;
  const bool xbf = x_bf16 != 0;

  // once a block: the weights, rounded to bf16 as the plain route's
  // .to(bf16); W_dil (128, 64, 3) goes to column k * 64 + c
  for (int i = tid; i < CH2 * KX; i += THREADS) {
    const int o = i / KX, r = i % KX;
    wa[o * WROW + (r % 3) * C + r / 3] = __float2bfloat16(__ldg(wd + i));
  }
  for (int i = tid; i < CH2 * NM; i += THREADS)
    wa[(i / NM) * WROW + KX + i % NM] = __float2bfloat16(__ldg(wm + i));
  for (int i = tid; i < C * C; i += THREADS) {
    wo[(i / C) * W2ROW + i % C] = __float2bfloat16(__ldg(wr + i));
    wo[(C + i / C) * W2ROW + i % C] = __float2bfloat16(__ldg(wk + i));
  }
  for (int i = tid; i < W2S; i += THREADS) {
    wup[i] = round_bf(__ldg(w1 + i));
    wup[W2S + i] = round_bf(__ldg(w2 + i));
  }
  for (int i = tid; i < CH2; i += THREADS) bias1[i] = __ldg(bd + i) + __ldg(bm + i);
  for (int i = tid; i < C; i += THREADS) {
    bias2[i] = __ldg(br + i);
    bias2[C + i] = __ldg(bk + i);
  }
  if (tid == 0) {
    bup[0] = round_bf(__ldg(b1));
    bup[1] = round_bf(__ldg(b2));
  }

  const int g = tid / GT, t = tid % GT, warp = t >> 5, lane = tid & 31;
  unsigned char* gb = groups + g * Y::GROUP;
  bf16* xs = reinterpret_cast<bf16*>(gb);                 // [XROWS][XROW]
  bf16* cs = reinterpret_cast<bf16*>(gb + Y::XS);         // [TILE][CROW]
  float* us = reinterpret_cast<float*>(gb + Y::XS + Y::CSB);  // [NP][UROW]
  float* ms = us + Y::NP * UROW;                          // [NF][UROW]
  bf16* os = cs;                                          // [TILE][OROW]
  bf16* st = xs;                                          // [NOUT][SROW]
  // bins -1 and NM of every f32 row are zero and never written again
  for (int i = t; i < Y::NP + Y::NF; i += GT) {
    us[i * UROW] = 0.0f;
    us[i * UROW + UROW - 1] = 0.0f;
  }
  __syncthreads();

  const int bar = 1 + g;
  const int wmi = warp & 1, wni = warp >> 1;
  const int gq = lane >> 2, tq = lane & 3;
  // ldmatrix rows: A (samples) 32 wm + (lane & 15), k + (lane >> 4) 8;
  // B (channels) pair base + (lane >> 4) 8 + (lane & 7), k + bit 3 of lane
  const int arow = 32 * wmi + (lane & 15), acol = (lane >> 4) * 8;
  const int brow = ((lane >> 4) << 3) + (lane & 7), bcol = ((lane >> 3) & 1) * 8;
  const size_t xrow = (size_t)L;

  for (int i = 0;; ++i) {
    const int tile = (i * gridDim.x + blockIdx.x) * GROUPS + g;
    if (tile >= geo.tiles) break;
    const int b = tile / geo.tiles_per_row;
    const int j0 = (tile % geo.tiles_per_row) * TILE;

    // 1. the window of a = bf16(x + t_n), zero outside [0, L), and the mel:
    // a warp unit is 8 chunks of 8 rows x 4 channel pairs, lane (pq, cq)
    // chunk pq and pair cq; 16-byte column chunks swizzled by row / 8
    {
      const int cq = lane & 3, pq = lane >> 2;
      const int nchunks = geo.nrows / 8;
      const int wunits = (nchunks + 7) / 8 * 8;
      for (int wu = warp; wu < wunits; wu += 8) {
        __nv_bfloat162 v[2][8];
        int chunk[2], cpv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int wuu = wu + 4 * h;
          const int cb = wuu & 7, rb = wuu >> 3;
          chunk[h] = 8 * rb + pq;
          cpv[h] = 4 * cb + cq;
          const int r0 = 8 * chunk[h];
          const int pos = geo.contiguous ? j0 - geo.e + r0
                                     : j0 + (r0 / TILE - 1) * d + r0 % TILE;
          if (wuu < wunits && chunk[h] < nchunks && pos >= 0 && pos < L) {
            float p0 = __ldg(part_t + b * C + 2 * cpv[h]);
            float p1 = __ldg(part_t + b * C + 2 * cpv[h] + 1);
            if (xbf) {
              p0 = round_bf(p0);
              p1 = round_bf(p1);
            }
            const size_t base = (size_t)(b * C + 2 * cpv[h]) * xrow + pos;
            load_pair(v[h], x, base, base + xrow, xbf, p0, p1);
          } else {
#pragma unroll
            for (int k = 0; k < 8; ++k) v[h][k] = __floats2bfloat162_rn(0.f, 0.f);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (wu + 4 * h >= wunits || chunk[h] >= nchunks) continue;
          bf16* row0 = xs + 8 * chunk[h] * XROW +
                       (((cpv[h] >> 2) ^ (chunk[h] & 7)) << 3) + 2 * (cpv[h] & 3);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            *reinterpret_cast<__nv_bfloat162*>(row0 + k * XROW) = v[h][k];
        }
      }
    }
    cond_mel<S, TILE, GT>(ms, mel + (size_t)b * T * NM, j0, T, t);
    group_sync(bar);

    // 2. the conditioning tile: upsampler 1, then upsampler 2 into cs
    cond_up1<S, TILE, GT>(us, ms, wup, bup[0], j0, T, t);
    group_sync(bar);
    cond_up2<S, TILE, GT, CROW>(cs, us, wup + W2S, bup[1], t);
    group_sync(bar);

    // 3. GEMM 1: z for samples 32 wm .. (two m16 tiles) and channels 32 wn
    // + 8 j (j < 4) and 64 + 32 wn + 8 (j - 4) (j >= 4); n-tile pair p
    // starts at channel nb(p)
    float acc[2][8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[m][j][v] = 0.0f;
    const bf16* bw = wa + brow * WROW + bcol;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
      const int trow = geo.tap[tap];
      const int ra = trow + arow, rb2 = ra + 16;
      const bf16* ap0 = xs + ra * XROW;
      const bf16* ap1 = xs + rb2 * XROW;
      const int s0 = (ra >> 3) & 7, s1 = (rb2 >> 3) & 7, hi = lane >> 4;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t a[2][4];
        ldsm_x4(a[0], ap0 + (((2 * kc + hi) ^ s0) << 3));
        ldsm_x4(a[1], ap1 + (((2 * kc + hi) ^ s1) << 3));
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int nb = (p >> 1) * C + 32 * wni + 16 * (p & 1);
          uint32_t q[4];
          ldsm_x4(q, bw + nb * WROW + tap * C + 16 * kc);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][2 * p], a[m], q[0], q[1]);
            mma_bf16(acc[m][2 * p + 1], a[m], q[2], q[3]);
          }
        }
      }
    }
    {
      const bf16* ap = cs + arow * CROW + acol;
#pragma unroll
      for (int ks = 0; ks < NM / 16; ++ks) {
        uint32_t a[2][4];
        ldsm_x4(a[0], ap + 16 * ks);
        ldsm_x4(a[1], ap + 16 * CROW + 16 * ks);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int nb = (p >> 1) * C + 32 * wni + 16 * (p & 1);
          uint32_t q[4];
          ldsm_x4(q, bw + nb * WROW + KX + 16 * ks);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][2 * p], a[m], q[0], q[1]);
            mma_bf16(acc[m][2 * p + 1], a[m], q[2], q[3]);
          }
        }
      }
    }
    group_sync(bar);                    // cs read by every warp: now os

    // 4. the gate, in f32 from the f32 sums, into os as bf16: rows
    // (samples) 16 m + gq (+ 8), channels 2 tq (+ 1) of each n-tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 32 * wni + 8 * j + 2 * tq;
      const float ba0 = bias1[c], ba1 = bias1[c + 1];
      const float bb0 = bias1[C + c], bb1 = bias1[C + c + 1];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int s = 32 * wmi + 16 * m + gq + 8 * hh;
          const float o0 = gate(acc[m][j][2 * hh] + ba0,
                                acc[m][j + 4][2 * hh] + bb0);
          const float o1 = gate(acc[m][j][2 * hh + 1] + ba1,
                                acc[m][j + 4][2 * hh + 1] + bb1);
          *reinterpret_cast<__nv_bfloat162*>(os + s * OROW + c) =
              __floats2bfloat162_rn(o0, o1);
        }
    }
    group_sync(bar);

    // 5. GEMM 2: outputs 64 wn .. 64 wn + 63 (wn 0: res, 1: skip) of the
    // same samples, over the 64 gate channels
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[m][j][v] = 0.0f;
    {
      const bf16* ap = os + arow * OROW + acol;
      const bf16* bo = wo + (64 * wni + brow) * W2ROW + bcol;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t a[2][4];
        ldsm_x4(a[0], ap + 16 * kc);
        ldsm_x4(a[1], ap + 16 * OROW + 16 * kc);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t q[4];
          ldsm_x4(q, bo + 16 * p * W2ROW + 16 * kc);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][2 * p], a[m], q[0], q[1]);
            mma_bf16(acc[m][2 * p + 1], a[m], q[2], q[3]);
          }
        }
      }
    }
    // r and s, + bias, rounded to bf16, channel-major into st
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = 64 * wni + 8 * j + 2 * tq;
      const float b0 = bias2[o], b1v = bias2[o + 1];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int s = 32 * wmi + 16 * m + gq + 8 * hh;
          st[o * SROW + s] = __float2bfloat16(acc[m][j][2 * hh] + b0);
          st[(o + 1) * SROW + s] = __float2bfloat16(acc[m][j][2 * hh + 1] + b1v);
        }
    }
    group_sync(bar);

    // 6. x' = (x + r) sqrt(1/2) into x_out, skip_sum (+)= s: 4 samples a
    // unit, rows 8 k + t / 16 (k < 8: res rows, k >= 8: skip rows); every
    // load of the thread in flight before the first store
    {
      constexpr int NQ = TILE / 4;
      constexpr int PER = NOUT * NQ / GT;       // 16 units a thread
      static_assert(PER == 16 && GT % NQ == 0, "units per thread");
      const int q = t % NQ, j = j0 + 4 * q;
      if (j < L) {
        float4 in[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int o = (k * GT + t) / NQ;
          in[k] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k < PER / 2) {
            if (x_out == nullptr) continue;
            const size_t off = (size_t)(b * C + o) * xrow + j;
            if (xbf) {
              const uint2 q2 = *reinterpret_cast<const uint2*>(
                  static_cast<const bf16*>(x) + off);
              const bf16* h4 = reinterpret_cast<const bf16*>(&q2);
              in[k] = make_float4(__bfloat162float(h4[0]),
                                  __bfloat162float(h4[1]),
                                  __bfloat162float(h4[2]),
                                  __bfloat162float(h4[3]));
            } else {
              in[k] = *reinterpret_cast<const float4*>(
                  static_cast<const float*>(x) + off);
            }
          } else if (skip_read) {
            in[k] = *reinterpret_cast<const float4*>(
                skip + (size_t)(b * CS + o - C) * xrow + j);
          }
        }
#pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int o = (k * GT + t) / NQ;
          const bf16* sv = st + o * SROW + 4 * q;
          const float r0 = __bfloat162float(sv[0]), r1 = __bfloat162float(sv[1]);
          const float r2 = __bfloat162float(sv[2]), r3 = __bfloat162float(sv[3]);
          if (k < PER / 2) {
            if (x_out == nullptr) continue;
            float4 v;
            if (xbf) {
              v = make_float4(round_bf(in[k].x + r0) * SQRT_HALF,
                              round_bf(in[k].y + r1) * SQRT_HALF,
                              round_bf(in[k].z + r2) * SQRT_HALF,
                              round_bf(in[k].w + r3) * SQRT_HALF);
            } else {
              v = make_float4((in[k].x + r0) * SQRT_HALF,
                              (in[k].y + r1) * SQRT_HALF,
                              (in[k].z + r2) * SQRT_HALF,
                              (in[k].w + r3) * SQRT_HALF);
            }
            *reinterpret_cast<float4*>(x_out + (size_t)(b * C + o) * xrow +
                                       j) = v;
          } else {
            const float4 v = skip_read
                                 ? make_float4(in[k].x + r0, in[k].y + r1,
                                               in[k].z + r2, in[k].w + r3)
                                 : make_float4(r0, r1, r2, r3);
            *reinterpret_cast<float4*>(skip + (size_t)(b * CS + o - C) * xrow +
                                       j) = v;
          }
        }
      }
    }
    group_sync(bar);                    // the window and cs free again
  }
}

template <int S>
int launch(const void* x, void* x_out, void* skip, const void* part_t,
           const void* mel, const void* wd, const void* bd, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* wm,
           const void* bm, const void* wr, const void* br, const void* wk,
           const void* bk, int B, int L, int T, int d, int x_bf16,
           int skip_read, int grid, int smem, cudaStream_t stream) {
  if (smem != Layout<S>::BYTES || (long)L > (long)T * S * S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      wavenet_block_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wavenet_block_kernel<S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  wavenet_block_kernel<S><<<grid, THREADS, smem, stream>>>(
      x, static_cast<float*>(x_out), static_cast<float*>(skip),
      static_cast<const float*>(part_t), static_cast<const bf16*>(mel),
      static_cast<const float*>(wd), static_cast<const float*>(bd),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(wm), static_cast<const float*>(bm),
      static_cast<const float*>(wr), static_cast<const float*>(br),
      static_cast<const float*>(wk), static_cast<const float*>(bk), L, T, d,
      x_bf16, skip_read, geometry(B, L, d));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wb
}  // namespace

// One residual block. x (B, 64, L) f32, or bf16 with x_bf16 = 1 (block 0);
// x_out (B, 64, L) f32 for x', or NULL (the last block); skip (B, 64, L)
// f32, added into (skip_read 1) or written (0); part_t (B, 64) f32; mel
// (B, T, n_mels) bf16; then f32 weights and biases, each rounded to bf16
// here as the plain route rounds it (the biases stay f32): wd (128, 64, 3)
// and bd (128,) the dilated conv, w1, b1, w2, b2 the upsamplers ((1, 1, 3,
// 2 stride), (1,)), wm (128, n_mels, 1) and bm (128,) the mel projection,
// wr, br and wk, bk the res and skip 1x1 convs ((64, 64, 1), (64,)). Only
// 64 residual and skip channels, n_mels = 80, stride 8 or 16, L a multiple
// of 8 and at most T stride^2, and a dilation that is at most 64 or a
// multiple of 8 are built; `smem` must be the block's shared memory
// (ops/wavenet_block.py:smem_bytes) and `grid` the persistent grid. Returns
// cudaGetLastError() (or an attribute call's error).
extern "C" int wavenet_block_launch(
    const void* x, void* x_out, void* skip, const void* part_t,
    const void* mel, const void* wd, const void* bd, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* wm,
    const void* bm, const void* wr, const void* br, const void* wk,
    const void* bk, int B, int C, int CS, int L, int T, int n_mels,
    int stride, int dilation, int x_bf16, int skip_read, int grid, int smem,
    void* stream) {
  using namespace wb;
  if (C != wb::C || CS != wb::CS || n_mels != NM || L < 1 || L % 8 || B < 1 ||
      T < 1 || grid < 1 || dilation < 1 ||
      (dilation > TILE && dilation % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 16)
    return launch<16>(x, x_out, skip, part_t, mel, wd, bd, w1, b1, w2, b2, wm,
                      bm, wr, br, wk, bk, B, L, T, dilation, x_bf16,
                      skip_read, grid, smem, s);
  if (stride == 8)
    return launch<8>(x, x_out, skip, part_t, mel, wd, bd, w1, b1, w2, b2, wm,
                     bm, wr, br, wk, bk, B, L, T, dilation, x_bf16, skip_read,
                     grid, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
