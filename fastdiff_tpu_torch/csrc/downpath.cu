// K8: the fused down path, the first k=7 conv and the three DBlocks, in two
// launches of this source, with NWC or NCL activations.
//
// Replaces fastdiff_tpu/ops/downpath_pallas.py:_fused_call (its pallas_call,
// body _kernel_body). With factors (4, 8, 8), C = 32:
//
//   af   = bf16(audio)                        zero outside [0, L)
//   x0   = bf16(b0 + sum_k W0[k] af(t+k-3))   -> skip0
//   per DBlock s = 1, 2, 3 (rate R = 4, 32, 256):
//     p    = x_{s-1}[R t]                     nearest downsample, phase 0
//     y    = p; three times, d = 1, 2, 4:
//            y = bf16(b + sum_{k,c} W[k][c] leaky0.2(y)(t+(k-1)d))
//     x_s  = bf16(y + bf16(br + sum_c Wr[c] p))   -> skip1, skip2, x
//
// every stage zero outside its [0, L / R): the sequence edges are zero
// padding, as in the JAX kernel's masks.
//
// Two layouts, one template flag (NCL) of both stage kernels:
// - NWC (downpath_launch, use_pallas_down): outputs (B, L_R, C), biases the
//   bf16 last rows of the packed weights, as JAX's kernel.
// - NCL (downpath_ncl_launch, the "ncl" / "ncl_fh" inference routes, where
//   JAX's _fastdiff_apply_ncl runs XLA): outputs (B, C, L_R), and the cast
//   points of that route's module chain: the biases in float32 from their
//   own array, added to the float32 sums, one bf16 rounding per conv output.
//
// What bounds it on an H100: at 10 s of audio (L = 221,184) the traffic is
// 0.88 MB of f32 audio in and 14.2 + 3.5 + 0.44 + 0.06 MB of bf16 out, about
// 6 us at 3.35 TB/s; the math is 1.1 GFLOP at rate 4 and little elsewhere,
// ~1 us at the bf16 tensor-core peak. So the bytes bound it, skip0 most of
// all.
//
// Design:
// - Two launches, stage 1 then stage 2, on the caller's stream. skip1, an
//   output anyway, is their interface: stage 2 reads it back (3.5 MB, ~1 us)
//   instead of recomputing the rate-4 stage for the deep path's 2,048-sample
//   receptive field.
// - Stage 1 (down_stage1): a block owns T1 = 256 rate-4 outputs (1,024
//   input samples). It writes their skip0 straight from the audio (the
//   first conv on the CUDA cores: NWC, 8 channels of a sample a thread with
//   their weights in registers, 16-byte stores of 64-byte rows; NCL, 8
//   samples of one channel a thread, 16-byte stores along the channel's
//   row), recomputes the picks p1 = x0[4 m] from the audio over the tile
//   plus H1 = 8 rows of halo on each side (a DBlock reaches 1 + 2 + 4 = 7
//   samples), runs DBlock 1 over those E1 = 272 rows and writes the centre
//   rows of skip1. The audio span the block needs is staged once, rounded
//   to bf16, in shared memory.
// - Stage 2 (down_stage2): a block owns T3 = 8 rate-256 outputs. DBlock 3
//   over E3 = 24 rows (8 of halo before, 8 after the tile) needs x2 at its
//   24 picks, each valid only 7 rows inside its buffer, so DBlock 2 runs
//   over E2 = 208 rate-32 rows from 72 before the tile's first sample; its
//   picks p2 = skip1[8 m] are read from device memory. The block writes its
//   64 centre rows of skip2 and its 8 of x.
// - Each DBlock conv, and the 1x1 residual, is a bf16 mma.sync.m16n8k16
//   product with f32 accumulation: output channels as M (two m16 tiles),
//   samples as N (one n8 tile per step), taps x channels as K. Activations
//   lie sample-major in shared memory, [rows][ROW] bf16 (80-byte rows,
//   conflict-free for ldmatrix), so a tap of dilation d is a shift of d
//   rows in ldmatrix's row addresses; the conv's input is held already
//   leaky'd (the conv applies leaky to its input, K1's to its output), and
//   the raw picks p stay beside it for the residual. A warp holds one
//   conv's A fragments (2 m16 x 6 k16) in registers across its n8 tiles.
//   The bias initialises the accumulators; bf16 is rounded where the plain
//   version rounds.
// - NCL: a DBlock's last conv writes its output channel-major into a free
//   buffer, [C][CS] bf16 (CS = 8 mod 64, so a thread's two samples of a
//   channel are one 4-byte word and the warp's 32 words fall in 32 banks,
//   and each channel's row is 16-byte aligned); the block then stores each
//   channel's run of samples in 16-byte vectors, a warp's lanes along one
//   row. Stage 2 reads its picks of skip1 one value at a time.
// - A conv reads zero pad rows beyond its buffer; the error that makes
//   spreads 7 rows a DBlock and never reaches a row that is stored or
//   picked (ops/downpath_pallas.py holds the geometry; the CPU tests check
//   it against the receptive field).
// - 256 threads, two blocks per SM; at 10 s, b 1: 216 stage-1 blocks and
//   108 stage-2 blocks, one wave each on 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {
namespace dp {

constexpr int C = 32;
constexpr int K0 = 7;                   // first conv taps
constexpr int NL = 3;                   // dilated convs per DBlock
constexpr int ROWS = 3 * C + 1;         // conv operand rows: taps x C, bias
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 2;
constexpr int ROW = 40;                 // bf16 per sample row (32 + 8)
constexpr int WROW = 104;               // bf16 per staged conv weight row
constexpr int PAD = 4;                  // zero rows around a buffer: d <= 4
// stage 1: T1 rate-4 outputs per block, H1 rows of halo on each side
constexpr int T1 = 256;
constexpr int H1 = 8;
constexpr int E1 = T1 + 2 * H1;
constexpr int AOFF = 4 * H1 + 4;        // audio staged from 4 j0 - AOFF
constexpr int ASPAN = 4 * E1 + 8;       // audio samples staged per block
// stage 2: T3 rate-256 outputs per block; DBlock 3 over E3 rows from H3
// before the tile, DBlock 2 over E2 rows from H2 before the tile's first
// rate-32 sample 8 j0
constexpr int T3 = 8;
constexpr int H3 = 8;
constexpr int E3 = 24;
constexpr int H2 = 72;
constexpr int E2 = 208;
constexpr int PICK3 = H2 - 8 * H3;      // x2 row of p3 row 0
static_assert(E1 % 8 == 0 && E2 % 8 == 0 && E3 % 8 == 0, "n8 tiles");
static_assert(PICK3 >= 7 && PICK3 + 8 * (E3 - 1) < E2 - 7,
              "every pick of p3 is a valid row of x2");
static_assert(H1 >= 7 && H3 >= 7 && E3 - H3 - T3 >= 7 && H2 >= 7 &&
                  E2 - H2 - 8 * T3 >= 7,
              "halos cover a DBlock's reach");
// NCL: bf16 per channel row of the channel-major output of DBlocks 1, 2, 3
constexpr int CS1 = 328;
constexpr int CS2 = 264;
constexpr int CS3 = 72;
static_assert(CS1 >= E1 && CS2 >= E2 && CS3 >= E3 && CS1 % 64 == 8 &&
                  CS2 % 64 == 8 && CS3 % 64 == 8,
              "a channel row holds the buffer's rows, 16-byte aligned, and "
              "a warp's words fall in 32 banks");
static_assert(H1 % 8 == 0 && H2 % 8 == 0 && H3 % 8 == 0,
              "the stored rows start 16-byte aligned in a channel row");

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// leaky0.2 of a bf16 value, rounded to bf16 (the op on a bf16 tensor)
__device__ __forceinline__ float leaky_bf(float v) {
  return v >= 0.0f ? v : round_bf(0.2f * v);
}

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

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
    w[q] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// leaky_bf of 8 bf16 values packed in a 16-byte vector
__device__ __forceinline__ uint4 leaky8(uint4 v) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float f[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    __nv_bfloat162 pair;
    *reinterpret_cast<uint32_t*>(&pair) = w[q];
    const float2 p = __bfloat1622float2(pair);
    f[2 * q] = leaky_bf(p.x);
    f[2 * q + 1] = leaky_bf(p.y);
  }
  return pack8(f);
}

// One DBlock's weights in shared memory, staged for the mma A operand:
// conv l as ws[l][o][k C + c] (rows padded to WROW), its bias wb[l][o]; the
// residual 1x1 conv as wr[o][c] (rows of ROW), its bias br[o].
struct DWeights {
  bf16 ws[NL][C * WROW];
  bf16 wr[C * ROW];
  float wb[NL][C];
  float br[C];
};
static_assert(sizeof(DWeights) % 16 == 0, "buffers after it stay aligned");

// DBlock bi of conv_aug (nb, NL, 3C+1, C) and res_aug (nb, C+1, C), both
// with the bias in the last row, into w (transposed: outputs as rows). An
// operand row is C bf16 = four 16-byte vectors; each thread loads whole
// vectors, several in flight, and scatters their 8 outputs. With NCL the
// biases come from bias (1 + nb (NL+1), C) float32 instead: row 0 the first
// conv's, then per DBlock its NL convs' and its residual's.
template <bool NCL>
__device__ void stage_dblock(const bf16* __restrict__ conv_aug,
                             const bf16* __restrict__ res_aug,
                             const float* __restrict__ bias, int bi,
                             DWeights* w, int tid) {
  const uint4* cw =
      reinterpret_cast<const uint4*>(conv_aug + (size_t)bi * NL * ROWS * C);
#pragma unroll 4
  for (int idx = tid; idx < NL * ROWS * C / 8; idx += THREADS) {
    const int l = idx / (ROWS * C / 8), r = (idx / (C / 8)) % ROWS;
    const int o0 = 8 * (idx % (C / 8));
    const uint4 v = __ldg(cw + idx);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (r < 3 * C)
        w->ws[l][(o0 + j) * WROW + r] = e[j];
      else if (!NCL)
        w->wb[l][o0 + j] = to_f(e[j]);
    }
  }
  const uint4* rw =
      reinterpret_cast<const uint4*>(res_aug + (size_t)bi * (C + 1) * C);
#pragma unroll 4
  for (int idx = tid; idx < (C + 1) * C / 8; idx += THREADS) {
    const int c = idx / (C / 8), o0 = 8 * (idx % (C / 8));
    const uint4 v = __ldg(rw + idx);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c < C)
        w->wr[(o0 + j) * ROW + c] = e[j];
      else if (!NCL)
        w->br[o0 + j] = to_f(e[j]);
    }
  }
  if (NCL) {
    const float* bb = bias + (1 + bi * (NL + 1)) * C;
    for (int idx = tid; idx < (NL + 1) * C; idx += THREADS) {
      if (idx < NL * C)
        w->wb[idx / C][idx % C] = __ldg(bb + idx);
      else
        w->br[idx - NL * C] = __ldg(bb + idx);
    }
  }
}

// Zero the PAD rows on each side of the `rows`-row buffer at `buf`.
__device__ __forceinline__ void zero_pads(bf16* buf, int rows, int tid) {
  constexpr int V = PAD * ROW / 8;       // 16-byte vectors per side
  for (int idx = tid; idx < 2 * V; idx += THREADS) {
    bf16* side = idx < V ? buf - PAD * ROW : buf + rows * ROW;
    reinterpret_cast<uint4*>(side)[idx % V] = make_uint4(0, 0, 0, 0);
  }
}

// One conv of a DBlock over rows [0, E) (row e is sample g0 + e), n8 tiles
// j = warp, warp + WARPS, ...: acc = b_l + W_l . [src(e-d); src(e); src(e+d)]
// with src already leaky'd; then without LAST dst = leaky_bf(bf16(acc)),
// the next conv's input; with LAST dst = bf16(bf16(acc) + bf16(br + Wr .
// p)), the block's output. Rows outside [0, n) are zero. dst is
// sample-major, [E][ROW], or with CM channel-major, [C][cs]: a thread's two
// samples of a channel (rows n0 + 2 tq, + 1) as one 4-byte word.
template <bool LAST, bool CM>
__device__ void conv_layer(const bf16* src, bf16* dst, const bf16* p,
                           const DWeights& w, int l, int d, long g0, int E,
                           long n, int cs, int warp, int lane) {
  uint32_t wa[2][6][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int ks = 0; ks < 6; ++ks)
      ldsm_x4(wa[m][ks], w.ws[l] + (16 * m + (lane & 15)) * WROW + 16 * ks +
                             (lane >> 4) * 8);
  uint32_t wra[2][2][4];
  if (LAST)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        ldsm_x4(wra[m][ks], w.wr + (16 * m + (lane & 15)) * ROW + 16 * ks +
                                (lane >> 4) * 8);
  const int gq = lane >> 2, tq = lane & 3;
  for (int j = warp; j < E / 8; j += WARPS) {
    const int n0 = 8 * j;
    // two accumulator chains per m16 tile (channels 0-15 and 16-31 of each
    // tap), summed at the end; the biases read from shared memory per tile
    // (registers are the scarce resource here)
    float acc[2][2][4], res[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 16 * m + gq + 8 * h;
        acc[m][0][2 * h] = acc[m][0][2 * h + 1] = w.wb[l][o];
        res[m][2 * h] = res[m][2 * h + 1] = LAST ? w.br[o] : 0.0f;
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[m][1][v] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      uint32_t b[4];
      ldsm_x4(b, src + (n0 + (lane & 7) + (k - 1) * d) * ROW +
                     (lane >> 3) * 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(acc[m][0], wa[m][2 * k], b[0], b[1]);
        mma_bf16(acc[m][1], wa[m][2 * k + 1], b[2], b[3]);
      }
    }
    if (LAST) {
      uint32_t b[4];
      ldsm_x4(b, p + (n0 + (lane & 7)) * ROW + (lane >> 3) * 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_bf16(res[m], wra[m][0], b[0], b[1]);
        mma_bf16(res[m], wra[m][1], b[2], b[3]);
      }
    }
    const long g = g0 + n0 + 2 * tq;      // the sample of c = 0
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ch = 16 * m + gq + 8 * h;
        float out[2];                       // samples g, g + 1
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int v = 2 * h + c;
          const float y = round_bf(acc[m][0][v] + acc[m][1][v]);
          const float o = LAST ? y + round_bf(res[m][v]) : leaky_bf(y);
          out[c] = g + c >= 0 && g + c < n ? o : 0.0f;
        }
        if (CM) {
          *reinterpret_cast<__nv_bfloat162*>(dst + ch * cs + n0 + 2 * tq) =
              __floats2bfloat162_rn(out[0], out[1]);
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c)
            dst[(n0 + 2 * tq + c) * ROW + ch] = __float2bfloat16(out[c]);
        }
      }
  }
}

// The three convs of a DBlock over rows [0, E) of sample g0 + e: p in P,
// leaky(p) in A (both zero outside [0, n)); A and Bb hold PAD zero rows on
// each side. The block's output x lands in Bb, or with CM channel-major in
// out ([C][cs], which may overlay Bb's bytes and its pad rows); A is
// overwritten.
template <bool CM>
__device__ void dblock(const bf16* P, bf16* A, bf16* Bb, bf16* out, int cs,
                       const DWeights& w, long g0, int E, long n, int warp,
                       int lane) {
  conv_layer<false, false>(A, Bb, nullptr, w, 0, 1, g0, E, n, 0, warp, lane);
  __syncthreads();
  conv_layer<false, false>(Bb, A, nullptr, w, 1, 2, g0, E, n, 0, warp, lane);
  __syncthreads();
  conv_layer<true, CM>(A, CM ? out : Bb, P, w, 2, 4, g0, E, n, cs, warp,
                       lane);
  __syncthreads();
}

// Rows [r0, r0 + count) of a [rows][ROW] buffer to the NWC rows pos0 + r
// (< n) of `out`: four 16-byte stores per 64-byte sample row.
__device__ __forceinline__ void store_rows(const bf16* buf, int r0,
                                           int count, long pos0, long n,
                                           bf16* __restrict__ out, int tid) {
  for (int idx = tid; idx < 4 * count; idx += THREADS) {
    const int r = idx >> 2, q = idx & 3;
    const long g = pos0 + r;
    if (g < n)
      reinterpret_cast<uint4*>(out + g * C)[q] =
          reinterpret_cast<const uint4*>(buf + (r0 + r) * ROW)[q];
  }
}

// Rows [r0, r0 + count) of a channel-major [C][cs] buffer to the NCL
// samples pos0 + r (< n) of `out` (B's slice, channel rows n apart): 16-byte
// stores of 8 samples, consecutive lanes along a channel's row. count, pos0
// and n are multiples of 8.
__device__ __forceinline__ void store_cols(const bf16* cm, int cs, int r0,
                                           int count, long pos0, long n,
                                           bf16* __restrict__ out, int tid) {
  const int per = count / 8;
  for (int idx = tid; idx < C * per; idx += THREADS) {
    const int c = idx / per, k = idx % per;
    const long g = pos0 + 8 * k;
    if (g < n)
      *reinterpret_cast<uint4*>(out + c * n + g) =
          *reinterpret_cast<const uint4*>(cm + c * cs + r0 + 8 * k);
  }
}

// x0 channels 8q .. 8q+7 at the sample whose first tap is af[0]:
// bf16(b0 + sum_k W0[k] af[k]), the taps in order
__device__ __forceinline__ void first_conv8(const float* af,
                                            const float (&w0)[K0][8],
                                            const float (&b0)[8], float* v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float acc = b0[j];
#pragma unroll
    for (int k = 0; k < K0; ++k) acc = fmaf(w0[k][j], af[k], acc);
    v[j] = round_bf(acc);
  }
}

// Stage 1. NWC: s0 (B, L, C), s1 (B, L/4, C), bias unused. NCL: s0 (B, C, L),
// s1 (B, C, L/4), the biases from bias (see stage_dblock), L % 2048 == 0.
template <bool NCL>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
down_stage1(const float* __restrict__ audio,
            const bf16* __restrict__ first_aug,
            const bf16* __restrict__ res_aug,
            const bf16* __restrict__ conv_aug,
            const float* __restrict__ bias, bf16* __restrict__ s0,
            bf16* __restrict__ s1, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DWeights* w = reinterpret_cast<DWeights*>(smem_raw);
  float* af = reinterpret_cast<float*>(smem_raw + sizeof(DWeights));
  bf16* P = reinterpret_cast<bf16*>(af + ASPAN) + PAD * ROW;  // [E1][ROW]
  bf16* A = P + (E1 + 2 * PAD) * ROW;
  bf16* Bb = A + (E1 + 2 * PAD) * ROW;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const long n1 = L / 4;
  const long j0 = (long)blockIdx.x * T1;   // first rate-4 output
  const long g1 = j0 - H1;                 // sample of row 0
  const float* a = audio + (size_t)b * L;

  zero_pads(A, E1, tid);
  zero_pads(Bb, E1, tid);
  stage_dblock<NCL>(conv_aug, res_aug, bias, 0, w, tid);
  // af[i] = bf16(audio[4 j0 - AOFF + i]), zero outside [0, L)
  for (int i = tid; i < ASPAN; i += THREADS) {
    const long t = 4 * j0 - AOFF + i;
    af[i] = (t >= 0 && t < L) ? round_bf(__ldg(a + t)) : 0.0f;
  }
  // the first conv's weights for this thread's channels 8q .. 8q+7 (every
  // task below has idx & 3 == tid & 3)
  const int q = tid & 3;
  float w0[K0][8], b0[8];
#pragma unroll
  for (int k = 0; k < K0; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j) w0[k][j] = to_f(first_aug[k * C + 8 * q + j]);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    b0[j] = NCL ? __ldg(bias + 8 * q + j) : to_f(first_aug[K0 * C + 8 * q + j]);
  __syncthreads();

  if (NCL) {
    // skip0 row of channel c = tid >> 3 over [4 j0, 4 j0 + 4 T1): a thread
    // computes 8 samples from the 16 staged ones that hold their taps (the
    // taps in first_conv8's order, so skip0 and the picks agree bit for
    // bit); 8 lanes write 128 contiguous bytes of a row
    const int c = tid >> 3;
    float wc[K0];
#pragma unroll
    for (int k = 0; k < K0; ++k) wc[k] = to_f(first_aug[k * C + c]);
    const float bc = __ldg(bias + c);
    bf16* row = s0 + ((size_t)b * C + c) * L;
#pragma unroll 2
    for (int g = tid & 7; g < T1 / 2; g += 8) {
      const long t = 4 * j0 + 8 * g;
      // af[AOFF - 4 + 8 g + i]: sample 8 g + i's tap k is a[i + k + 1]
      const float4* src =
          reinterpret_cast<const float4*>(af + AOFF - 4 + 8 * g);
      float a16[16], v[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 f = src[u];
        a16[4 * u] = f.x;
        a16[4 * u + 1] = f.y;
        a16[4 * u + 2] = f.z;
        a16[4 * u + 3] = f.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float acc = bc;
#pragma unroll
        for (int k = 0; k < K0; ++k) acc = fmaf(wc[k], a16[i + k + 1], acc);
        v[i] = round_bf(acc);
      }
      if (t < L) *reinterpret_cast<uint4*>(row + t) = pack8(v);
    }
  } else {
    // skip0 rows [4 j0, 4 j0 + 4 T1): a warp writes 8 whole 64-byte rows
#pragma unroll 4
    for (int idx = tid; idx < 4 * 4 * T1; idx += THREADS) {
      const int s = idx >> 2;
      const long t = 4 * j0 + s;
      float v[8];
      first_conv8(af + AOFF + s - K0 / 2, w0, b0, v);
      if (t < L)
        reinterpret_cast<uint4*>(s0 + ((size_t)b * L + t) * C)[q] = pack8(v);
    }
  }
  // picks p1[e] = x0[4 (g1 + e)], zero outside [0, n1), into P; leaky into A
  for (int idx = tid; idx < 4 * E1; idx += THREADS) {
    const int e = idx >> 2;
    const long m = g1 + e;
    float v[8];
    first_conv8(af + 4 * e + 1, w0, b0, v);
    const bool valid = m >= 0 && m < n1;
    uint4 pv = make_uint4(0, 0, 0, 0);
    if (valid) pv = pack8(v);
    reinterpret_cast<uint4*>(P + e * ROW)[q] = pv;
    reinterpret_cast<uint4*>(A + e * ROW)[q] = leaky8(pv);
  }
  __syncthreads();

  if (NCL) {
    // x1 channel-major over Bb's bytes (free once its last conv has read it)
    bf16* cm = Bb - PAD * ROW;
    dblock<true>(P, A, Bb, cm, CS1, *w, g1, E1, n1, warp, lane);
    store_cols(cm, CS1, H1, T1, j0, n1, s1 + (size_t)b * C * n1, tid);
  } else {
    dblock<false>(P, A, Bb, nullptr, 0, *w, g1, E1, n1, warp, lane);
    store_rows(Bb, H1, T1, j0, n1, s1 + (size_t)b * n1 * C, tid);
  }
}

// Stage 2. NWC: s1 (B, L/4, C) in, s2 (B, L/32, C), xf (B, L/256, C) out.
// NCL: s1 (B, C, L/4), s2 (B, C, L/32), xf (B, C, L/256), the biases from
// bias, L % 2048 == 0.
template <bool NCL>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
down_stage2(const bf16* __restrict__ res_aug,
            const bf16* __restrict__ conv_aug,
            const float* __restrict__ bias,
            const bf16* __restrict__ s1, bf16* __restrict__ s2,
            bf16* __restrict__ xf, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DWeights* w2 = reinterpret_cast<DWeights*>(smem_raw);
  DWeights* w3 = w2 + 1;
  bf16* P = reinterpret_cast<bf16*>(w3 + 1) + PAD * ROW;    // [E2][ROW]
  bf16* A = P + (E2 + 2 * PAD) * ROW;
  bf16* Bb = A + (E2 + 2 * PAD) * ROW;
  // DBlock 3's buffers, carved from P's bytes once DBlock 2 is done
  bf16* P3 = P;                                               // [E3][ROW]
  bf16* A3 = P3 + (E3 + 2 * PAD) * ROW;
  bf16* B3 = A3 + (E3 + 2 * PAD) * ROW;
  // NCL: x2 channel-major over Bb's bytes, x3 over A's (from P3, which
  // stays live: A is done with after DBlock 2)
  bf16* cm2 = Bb - PAD * ROW;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const long n1 = L / 4, n2 = L / 32, n3 = L / 256;
  const long j0 = (long)blockIdx.x * T3;    // first rate-256 output
  const long g2 = 8 * j0 - H2;              // rate-32 sample of x2 row 0
  const long g3 = j0 - H3;                  // rate-256 sample of p3 row 0

  zero_pads(A, E2, tid);
  zero_pads(Bb, E2, tid);
  stage_dblock<NCL>(conv_aug, res_aug, bias, 1, w2, tid);
  stage_dblock<NCL>(conv_aug, res_aug, bias, 2, w3, tid);
  // picks p2[e] = skip1[8 (g2 + e)], zero outside [0, n2)
  if (NCL) {
    // one value a thread: 8 rows (lanes & 7) of 4 channels a warp
    const bf16* s1b = s1 + (size_t)b * C * n1;
    for (int idx = tid; idx < C * E2; idx += THREADS) {
      const int e = (idx & 7) + 8 * (idx / (8 * C));
      const int c = (idx >> 3) % C;
      const long m = g2 + e;
      bf16 v = __float2bfloat16(0.0f);
      if (m >= 0 && m < n2) v = s1b[c * n1 + 8 * m];
      P[e * ROW + c] = v;
      A[e * ROW + c] = __float2bfloat16(leaky_bf(to_f(v)));
    }
  } else {
    const bf16* s1b = s1 + (size_t)b * n1 * C;
    for (int idx = tid; idx < 4 * E2; idx += THREADS) {
      const int e = idx >> 2, q = idx & 3;
      const long m = g2 + e;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m >= 0 && m < n2)
        v = __ldg(reinterpret_cast<const uint4*>(s1b + 8 * m * C) + q);
      reinterpret_cast<uint4*>(P + e * ROW)[q] = v;
      reinterpret_cast<uint4*>(A + e * ROW)[q] = leaky8(v);
    }
  }
  __syncthreads();

  // x2 in Bb (NWC) or cm2 (NCL)
  dblock<NCL>(P, A, Bb, cm2, CS2, *w2, g2, E2, n2, warp, lane);
  if (NCL)
    store_cols(cm2, CS2, H2, 8 * T3, 8 * j0, n2, s2 + (size_t)b * C * n2,
               tid);
  else
    store_rows(Bb, H2, 8 * T3, 8 * j0, n2, s2 + (size_t)b * n2 * C, tid);
  // picks p3[e] = x2[8 (g3 + e)] (row PICK3 + 8 e of x2), zero outside
  // [0, n3)
  zero_pads(A3, E3, tid);
  zero_pads(B3, E3, tid);
  if (NCL) {
    for (int idx = tid; idx < C * E3; idx += THREADS) {
      const int e = idx / C, c = idx % C;
      const long m = g3 + e;
      bf16 v = __float2bfloat16(0.0f);
      if (m >= 0 && m < n3) v = cm2[c * CS2 + PICK3 + 8 * e];
      P3[e * ROW + c] = v;
      A3[e * ROW + c] = __float2bfloat16(leaky_bf(to_f(v)));
    }
  } else {
    for (int idx = tid; idx < 4 * E3; idx += THREADS) {
      const int e = idx >> 2, q = idx & 3;
      const long m = g3 + e;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m >= 0 && m < n3)
        v = reinterpret_cast<const uint4*>(Bb + (PICK3 + 8 * e) * ROW)[q];
      reinterpret_cast<uint4*>(P3 + e * ROW)[q] = v;
      reinterpret_cast<uint4*>(A3 + e * ROW)[q] = leaky8(v);
    }
  }
  __syncthreads();

  // x3 in B3 (NWC) or cm3 (NCL)
  bf16* cm3 = P3 + (E2 + PAD) * ROW;
  dblock<NCL>(P3, A3, B3, cm3, CS3, *w3, g3, E3, n3, warp, lane);
  if (NCL)
    store_cols(cm3, CS3, H3, T3, j0, n3, xf + (size_t)b * C * n3, tid);
  else
    store_rows(B3, H3, T3, j0, n3, xf + (size_t)b * n3 * C, tid);
}

constexpr int SMEM1 =
    sizeof(DWeights) + ASPAN * 4 + 3 * (E1 + 2 * PAD) * ROW * 2;
constexpr int SMEM2 = 2 * sizeof(DWeights) + 3 * (E2 + 2 * PAD) * ROW * 2;
static_assert(3 * (E3 + 2 * PAD) <= E2 + 2 * PAD,
              "DBlock 3's buffers fit in P's bytes");
static_assert(C * CS1 <= (E1 + 2 * PAD) * ROW &&
                  C * CS2 <= (E2 + 2 * PAD) * ROW &&
                  C * CS3 <= (E2 + 2 * PAD) * ROW,
              "each channel-major output fits in the buffer it overlays");
static_assert(BLOCKS_PER_SM * (SMEM1 + 1024) <= 233472 &&
                  BLOCKS_PER_SM * (SMEM2 + 1024) <= 233472,
              "two blocks of either stage share an SM");

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Stage 1 then stage 2 on `stream`.
template <bool NCL>
int launch(const void* audio, const void* first_aug, const void* res_aug,
           const void* conv_aug, const void* bias, void* s0, void* s1,
           void* s2, void* xf, int B, int L, void* stream) {
  cudaError_t err = allow_smem(down_stage1<NCL>, SMEM1);
  if (err == cudaSuccess) err = allow_smem(down_stage2<NCL>, SMEM2);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long n1 = L / 4, n3 = L / 256;
  down_stage1<NCL><<<dim3((n1 + T1 - 1) / T1, B), THREADS, SMEM1, s>>>(
      static_cast<const float*>(audio), static_cast<const bf16*>(first_aug),
      static_cast<const bf16*>(res_aug), static_cast<const bf16*>(conv_aug),
      static_cast<const float*>(bias), static_cast<bf16*>(s0),
      static_cast<bf16*>(s1), L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  down_stage2<NCL><<<dim3((n3 + T3 - 1) / T3, B), THREADS, SMEM2, s>>>(
      static_cast<const bf16*>(res_aug), static_cast<const bf16*>(conv_aug),
      static_cast<const float*>(bias), static_cast<const bf16*>(s1),
      static_cast<bf16*>(s2), static_cast<bf16*>(xf), L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dp
}  // namespace

// audio (B, L, 1) f32; first_aug (K0+1, C), res_aug (3, C+1, C), conv_aug
// (3, 3, 3C+1, C), all bf16 with the bias in the last row; outputs s0 (B, L,
// C), s1 (B, L/4, C), s2 (B, L/32, C), xf (B, L/256, C) bf16. Only C = 32,
// factors (4, 8, 8), a k=7 first conv and 3 convs per DBlock are built;
// L must be a multiple of 256 (the Python wrapper checks). Launches stage 1
// then stage 2 on `stream`; returns cudaGetLastError() (or an attribute
// call's error).
extern "C" int downpath_launch(const void* audio, const void* first_aug,
                               const void* res_aug, const void* conv_aug,
                               void* s0, void* s1, void* s2, void* xf, int B,
                               int L, int channels, void* stream) {
  if (channels != dp::C || L % 256 != 0 || B < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return dp::launch<false>(audio, first_aug, res_aug, conv_aug, nullptr, s0,
                           s1, s2, xf, B, L, stream);
}

// The NCL layout: the same audio and packed weights (their bias rows
// unread), bias (1 + 3 (3 + 1), C) f32 (the first conv's, then per DBlock
// its three convs' and its residual's), outputs s0 (B, C, L), s1 (B, C,
// L/4), s2 (B, C, L/32), xf (B, C, L/256) bf16. L must be a multiple of
// 2048, so that every channel row of every output is whole 16-byte vectors.
extern "C" int downpath_ncl_launch(const void* audio, const void* first_aug,
                                   const void* res_aug, const void* conv_aug,
                                   const void* bias, void* s0, void* s1,
                                   void* s2, void* xf, int B, int L,
                                   int channels, void* stream) {
  if (channels != dp::C || L % 2048 != 0 || B < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return dp::launch<true>(audio, first_aug, res_aug, conv_aug, bias, s0, s1,
                          s2, xf, B, L, stream);
}
