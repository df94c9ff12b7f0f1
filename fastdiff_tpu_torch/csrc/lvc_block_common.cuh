// What the LVC block kernels share: the tile geometry, the bf16 helpers and
// the CUDA-core per-layer stages. Included by lvc_block_ncl.cu (K1, K2, K4
// and K6 at hops that are no multiple of 8), lvc_block_ncl_fh_cc.cu (K5 at
// such hops) and, for its constants and helpers, lvc_block_tc.cuh (the
// tensor-core stages of K1, K2, K4, K5 and K6). Only the *_cc kernels run
// the stages below. Every stage is called by all EXT threads of a block,
// one thread per sample of the tile's extent (TILE outputs plus a HALO on
// each side).
//
// Layer i of the block, d = 3^i (see lvc_block_ncl.cu):
//   s     = carry + skip                       (bf16, zero outside [0, L))
//   y     = leaky0.2(W_i . [a(t-d); a; a(t+d); 1]),  a = leaky0.2(s)
//   z     = K_{i,f} . [y(t-1); y; y(t+1); 1]   (per frame f = t / hop, f32)
//   carry = s + bf16(sigmoid(z[:C]) * tanh(z[C:]))

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 32;                   // inner channels
constexpr int HALO = 48;
constexpr int EXT = 512;                // samples per block = threads
constexpr int TILE = EXT - 2 * HALO;    // 416 output samples per block
constexpr int ROWS = 3 * C + 1;         // augmented contraction rows
constexpr int LAYERS = 4;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float leaky(float v) {
  return v >= 0.0f ? v : 0.2f * v;
}

// element (c, g) of a (C, L) NCL or (L, C) NWC activation row of one batch
template <bool NWC>
__device__ __forceinline__ size_t act_at(int c, long g, int L) {
  return NWC ? (size_t)g * C + c : (size_t)c * L + g;
}

// acc[j] += k[j] * v over 8 bf16 packed in a 16-byte vector
__device__ __forceinline__ void axpy8(uint4 k, float v, float* acc) {
  const uint32_t words[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    __nv_bfloat162 pair;
    *reinterpret_cast<uint32_t*>(&pair) = words[q];
    const float2 f = __bfloat1622float2(pair);
    acc[2 * q] = fmaf(f.x, v, acc[2 * q]);
    acc[2 * q + 1] = fmaf(f.y, v, acc[2 * q + 1]);
  }
}

// acc + sum_q k[q] * v[q] over 8 bf16 packed in a 16-byte vector
__device__ __forceinline__ float dot8(uint4 k, const float* v, float acc) {
  const uint32_t words[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    __nv_bfloat162 pair;
    *reinterpret_cast<uint32_t*>(&pair) = words[q];
    const float2 f = __bfloat1622float2(pair);
    acc = fmaf(f.x, v[2 * q], acc);
    acc = fmaf(f.y, v[2 * q + 1], acc);
  }
  return acc;
}

// Stage W_i as wt[r][o] (f32) and its bias wb[o] (wstack_t (C, 3C+1) rows are
// outputs, NWC's wstack (3C+1, C) rows are contraction rows), then s = carry
// + skip (masked to [0, L)) into carry and a = leaky(s) into act. With SAVE
// the tile's own samples also write s to `si`. `sb` is the batch row of skip.
template <bool NWC, bool SAVE>
__device__ __forceinline__ void skip_add_stage(
    const bf16* __restrict__ w, const bf16* __restrict__ sb, bf16* carry,
    bf16* act, float* wt, float* wb, int e, long g, int L, bool valid,
    bool save, bf16* si) {
  for (int idx = e; idx < C * ROWS; idx += EXT) {
    const int o = NWC ? idx % C : idx / ROWS;
    const int r = NWC ? idx / C : idx % ROWS;
    const float v = to_f(w[idx]);
    if (r < 3 * C)
      wt[r * C + o] = v;
    else
      wb[o] = v;
  }
  for (int c = 0; c < C; ++c) {
    float s = 0.0f;
    if (valid)
      s = round_bf(to_f(carry[c * EXT + e]) + to_f(sb[act_at<NWC>(c, g, L)]));
    carry[c * EXT + e] = __float2bfloat16(s);
    act[c * EXT + e] = __float2bfloat16(leaky(s));
    if (SAVE && save) si[(size_t)c * L] = __float2bfloat16(s);
  }
}

// y = leaky(W_i . [a(t-d); a; a(t+d)] + bias), masked to [0, L), into ybuf;
// with SAVE the tile's own samples also write y to `yi`.
template <bool SAVE>
__device__ __forceinline__ void dilated_conv(const bf16* act, const float* wt,
                                             const float* wb, bf16* ybuf,
                                             int e, int d, int L, bool valid,
                                             bool save, bf16* yi) {
  const bf16 zero = __float2bfloat16(0.0f);
  float acc[C];
#pragma unroll
  for (int o = 0; o < C; ++o) acc[o] = wb[o];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int src = e + (k - 1) * d;
    const bool in = src >= 0 && src < EXT;
    for (int c = 0; c < C; ++c) {
      const float v = in ? to_f(act[c * EXT + src]) : 0.0f;
      const float4* wr = reinterpret_cast<const float4*>(wt + (k * C + c) * C);
#pragma unroll
      for (int o4 = 0; o4 < C / 4; ++o4) {
        const float4 w4 = wr[o4];
        acc[4 * o4 + 0] = fmaf(w4.x, v, acc[4 * o4 + 0]);
        acc[4 * o4 + 1] = fmaf(w4.y, v, acc[4 * o4 + 1]);
        acc[4 * o4 + 2] = fmaf(w4.z, v, acc[4 * o4 + 2]);
        acc[4 * o4 + 3] = fmaf(w4.w, v, acc[4 * o4 + 3]);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < C; ++o) {
    const bf16 y = valid ? __float2bfloat16(leaky(acc[o])) : zero;
    ybuf[o * EXT + e] = y;
    if (SAVE && save) yi[(size_t)o * L] = y;
  }
}

// 16 bytes at p: through the read-only cache (LDG, global memory) or plain
template <bool LDG>
__device__ __forceinline__ uint4 load16(const bf16* p) {
  return LDG ? __ldg(reinterpret_cast<const uint4*>(p))
             : *reinterpret_cast<const uint4*>(p);
}

// z[oc..oc+7] and z[C+oc..C+oc+7] of sample e from one (2C, rows_p) slab
// `ki` of bf16 kernels (rows padded to a multiple of 8, bias in row 3C), in
// global (LDG) or shared memory: zs, zt are the sigmoid and tanh halves.
template <bool LDG>
__device__ __forceinline__ void lvc_dot_ncl(const bf16* ki, int rows_p,
                                            const bf16* ybuf, int e, int oc,
                                            float* zs, float* zt) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    zs[j] = to_f(ki[(size_t)(oc + j) * rows_p + 3 * C]);
    zt[j] = to_f(ki[(size_t)(C + oc + j) * rows_p + 3 * C]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int src = e + k - 1;
    const bool in = src >= 0 && src < EXT;
    for (int c8 = 0; c8 < C; c8 += 8) {
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[q] = in ? to_f(ybuf[(c8 + q) * EXT + src]) : 0.0f;
      const int r = k * C + c8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint4 ks = load16<LDG>(ki + (size_t)(oc + j) * rows_p + r);
        const uint4 kt = load16<LDG>(ki + (size_t)(C + oc + j) * rows_p + r);
        zs[j] = dot8(ks, v, zs[j]);
        zt[j] = dot8(kt, v, zt[j]);
      }
    }
  }
}

// carry[oc + j][e] = s + bf16(sigmoid(zs[j]) * tanh(zt[j])), s = carry
__device__ __forceinline__ void gate_update(bf16* carry, int e, int oc,
                                            const float* zs, const float* zt) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float gate = tanhf(zt[j]) / (1.0f + expf(-zs[j]));
    const float s = to_f(carry[(oc + j) * EXT + e]);
    carry[(oc + j) * EXT + e] = __float2bfloat16(s + round_bf(gate));
  }
}

// The model's final k=7 C->1 conv of sample g (tile index e) over the carry
// masked to [0, L): sum_{tap,c} carry[c, g+tap-3] * wf[tap, c] + wf[7, 0].
__device__ __forceinline__ float final_conv(const bf16* carry, const float* wf,
                                            int e, long g, int L) {
  float acc = wf[7 * C];
#pragma unroll
  for (int tap = 0; tap < 7; ++tap) {
    const long gs = g + tap - 3;
    if (gs < 0 || gs >= L) continue;
    const int src = e + tap - 3;
    for (int c = 0; c < C; ++c)
      acc = fmaf(to_f(carry[c * EXT + src]), wf[tap * C + c], acc);
  }
  return acc;
}

}  // namespace
