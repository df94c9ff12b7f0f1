// K8: the fused down path, the first k=7 conv and the three DBlocks in one
// pass, NWC.
//
// Replaces fastdiff_tpu/ops/downpath_pallas.py:_fused_call (its pallas_call,
// body _kernel_body). With factors (4, 8, 8), C = 32:
//
//   af   = bf16(audio)                        zero outside [0, L)
//   x0   = bf16(b0 + sum_k W0[k] af(t+k-3))   -> skip0 (B, L, C)
//   per DBlock s = 1, 2, 3 (rate R = 4, 32, 256):
//     p    = x_{s-1}[R t]                     nearest downsample, phase 0
//     y    = p; three times, d = 1, 2, 4:
//            y = bf16(b + sum_{k,c} W[k][c] leaky0.2(y)(t+(k-1)d))
//     x_s  = bf16(y + bf16(br + sum_c Wr[c] p))   -> skip1, skip2, x
//
// every stage zero outside its [0, L / R): the sequence edges are zero
// padding, as in the JAX kernel's masks.
//
// What bounds it on an H100: at 10 s of audio (L = 221,184) the traffic is
// 0.88 MB of f32 audio in and 14.2 + 3.5 + 0.44 + 0.06 MB of bf16 out, about
// 6 us at 3.35 TB/s; the math is 1.1 GFLOP at rate 4 (3.4 with the halo
// recompute below) and little elsewhere, on the f32 CUDA cores. The memory
// bound is the floor; this simple version is bound by its f32 math.
//
// Design: one block of 512 threads per 2048 output samples at input rate.
// The JAX kernel holds its whole tile at full rate (12,288 samples plus
// 2 x 2048 of halo, ~1 MB at C = 32); 227 KB of shared memory cannot, so:
//  - skip0 is written as it is computed, straight from the audio (7 taps
//    per sample, read through L1/L2); no full-rate stage is kept;
//  - the picks p of DBlock 1 are recomputed from the audio as well, so the
//    rate-4 stage needs two [C][E1] bf16 buffers (ping-pong over the three
//    convs; the last conv's residual recomputes p again), E1 = 512 center
//    + 2 x 512 halo samples = 192 KB for both;
//  - each later stage keeps only its own receptive field: its buffers are
//    carved from whichever rate-4 buffer is free, E2 = 64 + 2 x 64 at
//    rate 32, E3 = 8 + 2 x 8 at rate 256.
// All stages share one origin, the tile's first sample minus the 2048-sample
// halo of required_halo, so every pick is p[j] = prev[8 j] (4 j from the
// audio). A conv reads zeros beyond its buffer; the error that makes spreads
// 7 samples a stage and never reaches a center sample. Every thread owns
// whole samples: 32 f32 accumulators over 3 taps x 32 channels, the layer's
// weights staged as f32 in shared memory. Tensor cores, and fewer halo
// recomputes at rate 4 (3x its center), come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int C = 32;
constexpr int K0 = 7;                   // first conv taps
constexpr int NL = 3;                   // dilated convs per DBlock
constexpr int HALO_IN = 2048;           // required_halo((4, 8, 8))
constexpr int TILE = 2048;              // output samples at input rate
constexpr int THREADS = 512;
constexpr int E1 = TILE / 4 + 2 * HALO_IN / 4;      // 1536 at rate 4
constexpr int E2 = TILE / 32 + 2 * HALO_IN / 32;    // 192 at rate 32
constexpr int E3 = TILE / 256 + 2 * HALO_IN / 256;  // 24 at rate 256
constexpr int ROWS = 3 * C + 1;
constexpr size_t SMEM_BYTES =
    2 * C * E1 * sizeof(bf16) +
    (3 * C * C + C + C * C + C + K0 * C + C) * sizeof(float);

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// leaky0.2 of a bf16 value, rounded to bf16 (the op on a bf16 tensor)
__device__ __forceinline__ float leaky_bf(float v) {
  return v >= 0.0f ? v : round_bf(0.2f * v);
}

struct Weights {                        // f32 staging in shared memory
  float* wt;                            // [3C][C] current conv layer
  float* wb;                            // [C]
  float* wr;                            // [C][C] current residual 1x1 conv
  float* br;                            // [C]
  float* w0;                            // [K0][C] first conv
  float* b0;                            // [C]
};

// rows [0, n_rows) of a (n_rows + 1, C) bf16 operand into w, its bias row
// into b
__device__ void stage(const bf16* src, int n_rows, float* w, float* b) {
  for (int idx = threadIdx.x; idx < (n_rows + 1) * C; idx += THREADS) {
    const float v = to_f(src[idx]);
    if (idx < n_rows * C)
      w[idx] = v;
    else
      b[idx - n_rows * C] = v;
  }
}

// bf16(audio[p]), zero outside [0, L)
__device__ __forceinline__ float audio_at(const float* a, long p, int L) {
  return (p >= 0 && p < L) ? round_bf(a[p]) : 0.0f;
}

// first-conv output channel c at the sample whose 7 taps are af[]
__device__ __forceinline__ float first_conv(const Weights& w, const float* af,
                                            int c) {
  float acc = w.b0[c];
#pragma unroll
  for (int k = 0; k < K0; ++k) acc = fmaf(w.w0[k * C + c], af[k], acc);
  return round_bf(acc);
}

__device__ __forceinline__ void load_taps(const float* a, long g, int L,
                                          float* af) {
#pragma unroll
  for (int k = 0; k < K0; ++k) af[k] = audio_at(a, g + k - K0 / 2, L);
}

// store 32 channels of one sample as four 16-byte vectors
__device__ __forceinline__ void store_sample(bf16* dst, const float* v) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 u;
    uint32_t* words = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(v[8 * q + 2 * h], v[8 * q + 2 * h + 1]);
      words[h] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    reinterpret_cast<uint4*>(dst)[q] = u;
  }
}

// One dilated conv of a DBlock over a [C][E] stage buffer: dst = bf16(conv_d
// (leaky(src))), zero where the sample lies outside [0, n). With `last`,
// adds the block's residual bf16(br + Wr . p) in bf16, p from `pick_src`
// (a [C][E_prev] buffer read at 8 j) or, when that is NULL, recomputed from
// the audio at 4 j.
template <bool LAST>
__device__ void conv_layer(const bf16* src, bf16* dst, int E, int d, long g0,
                           long n, const Weights& w, const bf16* pick_src,
                           int e_prev, const float* audio, int L) {
  for (int j = threadIdx.x; j < E; j += THREADS) {
    float acc[C];
#pragma unroll
    for (int o = 0; o < C; ++o) acc[o] = w.wb[o];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int sj = j + (k - 1) * d;
      const bool in = sj >= 0 && sj < E;
      for (int c = 0; c < C; ++c) {
        const float a = in ? leaky_bf(to_f(src[c * E + sj])) : 0.0f;
        const float4* wr4 =
            reinterpret_cast<const float4*>(w.wt + (k * C + c) * C);
#pragma unroll
        for (int o4 = 0; o4 < C / 4; ++o4) {
          const float4 w4 = wr4[o4];
          acc[4 * o4 + 0] = fmaf(w4.x, a, acc[4 * o4 + 0]);
          acc[4 * o4 + 1] = fmaf(w4.y, a, acc[4 * o4 + 1]);
          acc[4 * o4 + 2] = fmaf(w4.z, a, acc[4 * o4 + 2]);
          acc[4 * o4 + 3] = fmaf(w4.w, a, acc[4 * o4 + 3]);
        }
      }
    }
    const long g = g0 + j;
    const bool valid = g >= 0 && g < n;
    if (LAST) {
      float res[C];
#pragma unroll
      for (int o = 0; o < C; ++o) res[o] = w.br[o];
      float af[K0];
      if (pick_src == nullptr) load_taps(audio, 4 * g, L, af);
      for (int c = 0; c < C; ++c) {
        float p;
        if (pick_src != nullptr)
          p = to_f(pick_src[c * e_prev + 8 * j]);
        else
          p = valid ? first_conv(w, af, c) : 0.0f;
        const float4* wr4 = reinterpret_cast<const float4*>(w.wr + c * C);
#pragma unroll
        for (int o4 = 0; o4 < C / 4; ++o4) {
          const float4 w4 = wr4[o4];
          res[4 * o4 + 0] = fmaf(w4.x, p, res[4 * o4 + 0]);
          res[4 * o4 + 1] = fmaf(w4.y, p, res[4 * o4 + 1]);
          res[4 * o4 + 2] = fmaf(w4.z, p, res[4 * o4 + 2]);
          res[4 * o4 + 3] = fmaf(w4.w, p, res[4 * o4 + 3]);
        }
      }
#pragma unroll
      for (int o = 0; o < C; ++o)
        acc[o] = round_bf(acc[o]) + round_bf(res[o]);
    }
#pragma unroll
    for (int o = 0; o < C; ++o)
      dst[o * E + j] = __float2bfloat16(valid ? acc[o] : 0.0f);
  }
}

// The three convs of DBlock `bi` at rate `rate`: p in buffer A ([C][E]),
// B the scratch; the block output lands in B.
__device__ void dblock(const bf16* conv_aug, const bf16* res_aug, int bi,
                       bf16* A, bf16* B, int E, long g0, long n,
                       const Weights& w, const bf16* pick_src, int e_prev,
                       const float* audio, int L) {
  stage(res_aug + (size_t)bi * (C + 1) * C, C, w.wr, w.br);
  for (int li = 0; li < NL; ++li) {
    __syncthreads();  // the previous layer's output and weights are done
    stage(conv_aug + ((size_t)bi * NL + li) * ROWS * C, 3 * C, w.wt, w.wb);
    __syncthreads();
    const bf16* src = (li % 2 == 0) ? A : B;
    bf16* dst = (li % 2 == 0) ? B : A;
    if (li == NL - 1)
      conv_layer<true>(src, dst, E, 1 << li, g0, n, w, pick_src, e_prev,
                       audio, L);
    else
      conv_layer<false>(src, dst, E, 1 << li, g0, n, w, nullptr, 0, audio,
                        L);
  }
  __syncthreads();
}

// write the center samples [halo, halo + tile) of a [C][E] stage buffer to
// out (B, n, C) at rate-r position g0 + j
__device__ void store_center(const bf16* buf, int E, int halo, int tile,
                             long g0, long n, bf16* out) {
  for (int j = halo + threadIdx.x; j < halo + tile; j += THREADS) {
    const long g = g0 + j;
    if (g >= n) continue;
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = to_f(buf[c * E + j]);
    store_sample(out + (size_t)g * C, v);
  }
}

// dst[c][j] = src[c][8 j], j < E_dst
__device__ void pick(const bf16* src, int e_src, bf16* dst, int e_dst) {
  for (int idx = threadIdx.x; idx < C * e_dst; idx += THREADS) {
    const int c = idx / e_dst;
    const int j = idx % e_dst;
    dst[c * e_dst + j] = src[c * e_src + 8 * j];
  }
}

__global__ void __launch_bounds__(THREADS, 1)
downpath_kernel(const float* __restrict__ audio,
                const bf16* __restrict__ first_aug,
                const bf16* __restrict__ res_aug,
                const bf16* __restrict__ conv_aug, bf16* __restrict__ s0,
                bf16* __restrict__ s1, bf16* __restrict__ s2,
                bf16* __restrict__ xf, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf0 = reinterpret_cast<bf16*>(smem_raw);      // [C][E1]
  bf16* buf1 = buf0 + C * E1;                           // [C][E1]
  Weights w;
  w.wt = reinterpret_cast<float*>(buf1 + C * E1);
  w.wb = w.wt + 3 * C * C;
  w.wr = w.wb + C;
  w.br = w.wr + C * C;
  w.w0 = w.br + C;
  w.b0 = w.w0 + K0 * C;

  const int b = blockIdx.y;
  const long t0 = (long)blockIdx.x * TILE;     // first center sample
  const float* a = audio + (size_t)b * L;
  stage(first_aug, K0, w.w0, w.b0);
  __syncthreads();

  // skip0, straight from the audio
  for (int t = threadIdx.x; t < TILE; t += THREADS) {
    const long g = t0 + t;
    if (g >= L) continue;
    float af[K0], v[C];
    load_taps(a, g, L, af);
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = first_conv(w, af, c);
    store_sample(s0 + ((size_t)b * L + g) * C, v);
  }

  // DBlock 1 (rate 4): p from the audio into buf1, output in buf0
  const long n1 = L / 4, g1 = (t0 - HALO_IN) / 4;
  for (int idx = threadIdx.x; idx < E1; idx += THREADS) {
    const long g = g1 + idx;
    const bool valid = g >= 0 && g < n1;
    float af[K0];
    load_taps(a, 4 * g, L, af);
    for (int c = 0; c < C; ++c)
      buf1[c * E1 + idx] =
          __float2bfloat16(valid ? first_conv(w, af, c) : 0.0f);
  }
  dblock(conv_aug, res_aug, 0, buf1, buf0, E1, g1, n1, w, nullptr, 0, a, L);
  store_center(buf0, E1, HALO_IN / 4, TILE / 4, g1, n1,
               s1 + (size_t)b * n1 * C);

  // DBlock 2 (rate 32): buffers carved from buf1, picks from buf0
  const long n2 = L / 32, g2 = (t0 - HALO_IN) / 32;
  bf16* p2 = buf1;
  bf16* q2 = buf1 + C * E2;
  pick(buf0, E1, p2, E2);
  dblock(conv_aug, res_aug, 1, p2, q2, E2, g2, n2, w, buf0, E1, a, L);
  store_center(q2, E2, HALO_IN / 32, TILE / 32, g2, n2,
               s2 + (size_t)b * n2 * C);

  // DBlock 3 (rate 256): buffers carved from buf0, picks from q2
  const long n3 = L / 256, g3 = (t0 - HALO_IN) / 256;
  bf16* p3 = buf0;
  bf16* q3 = buf0 + C * E3;
  pick(q2, E2, p3, E3);
  dblock(conv_aug, res_aug, 2, p3, q3, E3, g3, n3, w, q2, E2, a, L);
  store_center(q3, E3, HALO_IN / 256, TILE / 256, g3, n3,
               xf + (size_t)b * n3 * C);
}

}  // namespace

// audio (B, L, 1) f32; first_aug (K0+1, C), res_aug (3, C+1, C), conv_aug
// (3, 3, 3C+1, C), all bf16 with the bias in the last row; outputs s0 (B, L,
// C), s1 (B, L/4, C), s2 (B, L/32, C), xf (B, L/256, C) bf16. Only C = 32,
// factors (4, 8, 8), a k=7 first conv and 3 convs per DBlock are built;
// L must be a multiple of 256 (the Python wrapper checks). Launches on
// `stream`; returns cudaGetLastError() (or the attribute call's error).
extern "C" int downpath_launch(const void* audio, const void* first_aug,
                               const void* res_aug, const void* conv_aug,
                               void* s0, void* s1, void* s2, void* xf, int B,
                               int L, int channels, void* stream) {
  if (channels != C || L % 256 != 0 || B < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      downpath_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + TILE - 1) / TILE, B);
  downpath_kernel<<<grid, THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const bf16*>(first_aug),
      static_cast<const bf16*>(res_aug), static_cast<const bf16*>(conv_aug),
      static_cast<bf16*>(s0), static_cast<bf16*>(s1), static_cast<bf16*>(s2),
      static_cast<bf16*>(xf), L);
  return static_cast<int>(cudaGetLastError());
}
