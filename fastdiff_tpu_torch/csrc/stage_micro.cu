// K9: the stage kernels of the LVC-block micro-benchmark, the counterparts
// of scripts/bench_mosaic_micro.py:conv_stage (body _conv_body) and
// :lvc_stage (body _lvc_body). Each times one matmul stage of the block alone
// at the hop-256 block's scale (L = 221,184 samples, 864 frames).
//
//   conv_stage: x = tap (E, 97); for each of 4 layers y = x @ w_i (97, 32)
//               summed in f32, x = [bf16(y), bf16(y), bf16(y), 1];
//               out = bf16(y) of the last layer, (E, 32).
//   lvc_stage:  z[l] = bf16(tap[l] (97) @ kern[l / hop] (97, 64)), f32 sums,
//               one layer's per-frame grouped GEMM, (L, 64).
//
// What bounds them on an H100: conv_stage is 4 x 2 x 97 x 32 FLOPs per row
// (5.5 GFLOP at E = 221,184) against 57 MB (tap in, out); lvc_stage is
// 2 x 97 x 64 per row (2.7 GFLOP) against 82 MB (tap, kern, out). Both are
// memory-bound at the card's bf16 rate, ~17 and ~25 us.
//
// Design (simple first, on the f32 CUDA cores): one thread per row. A
// block stages its weights in shared memory as f32 once and its tap rows in
// steps of 256 rows (coalesced 2-byte loads), so the parameters the script
// sweeps keep their meaning: conv_stage's tile_s is the rows one block
// covers (its weights are staged once per tile), lvc_stage's tf the frames
// one block covers (one frame's kernels staged at a time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int R = 97;            // 3 x 32 taps + 1 bias row
constexpr int CO = 32;           // conv outputs
constexpr int ZO = 64;           // LVC outputs (2C)
constexpr int NL = 4;            // chained conv layers
constexpr int STEP = 256;        // rows per staging step = threads

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// 8 floats -> 8 bf16 (round to nearest) at 16-byte aligned p
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    w[q] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

__global__ void __launch_bounds__(STEP)
conv_stage_kernel(const bf16* __restrict__ tap, const bf16* __restrict__ w,
                  bf16* __restrict__ out, int E, int tile_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);        // [NL][R][CO]
  bf16* tap_s = reinterpret_cast<bf16*>(w_s + NL * R * CO);  // [STEP][R]
  const int t = threadIdx.x;
  const long base = (long)blockIdx.y * E;
  const int r_begin = blockIdx.x * tile_s;
  const int r_end = min(E, r_begin + tile_s);
  for (int idx = t; idx < NL * R * CO; idx += STEP) w_s[idx] = to_f(w[idx]);
  for (int r0 = r_begin; r0 < r_end; r0 += STEP) {
    const int rows = min(STEP, r_end - r0);
    __syncthreads();
    for (int idx = t; idx < rows * R; idx += STEP)
      tap_s[idx] = tap[(base + r0) * R + idx];
    __syncthreads();
    if (t >= rows) continue;
    float acc[CO], y[CO];
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[o] = 0.0f;
    for (int r = 0; r < R; ++r) {              // layer 0 reads the tap row
      const float v = to_f(tap_s[t * R + r]);
      const float* wr = w_s + r * CO;
#pragma unroll
      for (int o = 0; o < CO; ++o) acc[o] = fmaf(v, wr[o], acc[o]);
    }
    for (int i = 1; i < NL; ++i) {             // then [y, y, y, 1]
      const float* wi = w_s + i * R * CO;
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        y[o] = to_f(__float2bfloat16(acc[o]));
        acc[o] = wi[(R - 1) * CO + o];
      }
      for (int k = 0; k < 3; ++k)
        for (int c = 0; c < CO; ++c) {
          const float* wr = wi + (k * CO + c) * CO;
#pragma unroll
          for (int o = 0; o < CO; ++o) acc[o] = fmaf(y[c], wr[o], acc[o]);
        }
    }
    bf16* orow = out + (base + r0 + t) * CO;
#pragma unroll
    for (int o8 = 0; o8 < CO; o8 += 8) store8(orow + o8, acc + o8);
  }
}

__global__ void __launch_bounds__(STEP)
lvc_stage_kernel(const bf16* __restrict__ tap, const bf16* __restrict__ kern,
                 bf16* __restrict__ out, int L, int F, int hop, int tf) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);        // [R][ZO]
  bf16* tap_s = reinterpret_cast<bf16*>(k_s + R * ZO);    // [STEP][R]
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int f_end = min(F, (blockIdx.x + 1) * tf);
  for (int f = blockIdx.x * tf; f < f_end; ++f) {
    __syncthreads();
    const bf16* kf = kern + ((size_t)b * F + f) * R * ZO;
    for (int idx = t; idx < R * ZO; idx += STEP) k_s[idx] = to_f(kf[idx]);
    for (int s0 = 0; s0 < hop; s0 += STEP) {
      const int rows = min(STEP, hop - s0);
      const long row0 = (long)b * L + (long)f * hop + s0;
      __syncthreads();
      for (int idx = t; idx < rows * R; idx += STEP)
        tap_s[idx] = tap[row0 * R + idx];
      __syncthreads();
      if (t >= rows) continue;
      float acc[ZO];
#pragma unroll
      for (int o = 0; o < ZO; ++o) acc[o] = 0.0f;
      for (int r = 0; r < R; ++r) {
        const float v = to_f(tap_s[t * R + r]);
        const float4* kr = reinterpret_cast<const float4*>(k_s + r * ZO);
#pragma unroll
        for (int o4 = 0; o4 < ZO / 4; ++o4) {
          const float4 k4 = kr[o4];
          acc[4 * o4 + 0] = fmaf(v, k4.x, acc[4 * o4 + 0]);
          acc[4 * o4 + 1] = fmaf(v, k4.y, acc[4 * o4 + 1]);
          acc[4 * o4 + 2] = fmaf(v, k4.z, acc[4 * o4 + 2]);
          acc[4 * o4 + 3] = fmaf(v, k4.w, acc[4 * o4 + 3]);
        }
      }
      bf16* orow = out + (row0 + t) * ZO;
#pragma unroll
      for (int o8 = 0; o8 < ZO; o8 += 8) store8(orow + o8, acc + o8);
    }
  }
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

}  // namespace

// tap (B, E, 97) bf16, w (4, 97, 32) bf16 -> out (B, E, 32) bf16; tile_s
// rows per block (>= 1). Launches on `stream`; returns cudaGetLastError()
// (or the attribute call's error).
extern "C" int conv_stage_launch(const void* tap, const void* w, void* out,
                                 int B, int E, int rows, int tile_s,
                                 void* stream) {
  if (rows != R || tile_s < 1 || B < 1 || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = NL * R * CO * sizeof(float) + STEP * R * sizeof(bf16);
  const int err = set_smem(reinterpret_cast<const void*>(conv_stage_kernel),
                           smem);
  if (err) return err;
  const dim3 grid((E + tile_s - 1) / tile_s, B);
  conv_stage_kernel<<<grid, STEP, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(tap), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), E, tile_s);
  return static_cast<int>(cudaGetLastError());
}

// tap (B, L, 97) bf16, kern (B, F, 97, 64) bf16 -> z (B, L, 64) bf16 with
// L == F * hop; tf frames per block (>= 1). Launches on `stream`; returns
// cudaGetLastError() (or the attribute call's error).
extern "C" int lvc_stage_launch(const void* tap, const void* kern, void* out,
                                int B, int L, int F, int hop, int rows,
                                int tf, void* stream) {
  if (rows != R || tf < 1 || B < 1 || hop < 1 || (long)F * hop != L)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = R * ZO * sizeof(float) + STEP * R * sizeof(bf16);
  const int err = set_smem(reinterpret_cast<const void*>(lvc_stage_kernel),
                           smem);
  if (err) return err;
  const dim3 grid((F + tf - 1) / tf, B);
  lvc_stage_kernel<<<grid, STEP, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(tap), static_cast<const bf16*>(kern),
      static_cast<bf16*>(out), L, F, hop, tf);
  return static_cast<int>(cudaGetLastError());
}
