// Kernel B on the CUDA cores: the whole 4-layer time-aware LVC block, NCL
// layout, with an optional epilogue for the model's final k=7 C->1 conv
// (K1 and K2 for hops that are no multiple of 8; lvc_block_ncl_tc.cu runs
// the others on the tensor cores); Kernel B-SR (K4) for such hops, the same
// block writing the per-layer residuals that the training backward reads
// (lvc_block_ncl_tc.cu's SAVE runs the others); and K6 for such hops
// (lvc_block_nwc_tc.cu runs the others on the tensor cores), the same block
// in the NWC layout (template flag NWC). No route's main path runs these
// CUDA-core kernels at the model's hops: they are the fallbacks for other
// hops and the yardsticks that chip_smoke.py races the tensor-core kernels
// against.
//
// Replaces fastdiff_tpu/ops/lvc_block_ncl.py:lvc_block_ncl_aug, both of its
// pallas_call sites (_kernel_body and _kernel_body_final, through
// _kernel_core and _final_conv_epilogue), and lvc_block_ncl_aug_sr
// (_kernel_body_sr). Layer i, with d = 3^i:
//
//   s     = carry + skip                       (bf16, zero outside [0, L))
//   y     = leaky0.2(W_i . [a(t-d); a; a(t+d); 1]),  a = leaky0.2(s)
//           (f32 accumulate, then bf16, zero outside [0, L))
//   z     = K_{i,f} . [y(t-1); y; y(t+1); 1]   (per frame f = t / hop, f32)
//   carry = s + bf16(sigmoid(z[:C]) * tanh(z[C:]))
//
// and with final_wb the f32 output fin[t] = sum_{tap,c} carry[c, t+tap-3]
// * final_wb[tap, c] + final_wb[7, 0], over the carry masked to [0, L).
//
// What bounds it on an H100: per output sample and layer the dilated conv
// is 2 * 32 * 96 and the LVC 2 * 64 * 96 FLOPs, so the full-rate block of
// a 10 s utterance (L = 221,184) is ~16 GFLOP, against ~90 MB of traffic
// (x, skip, out and the 46 MB kern_taug operand). The math bounds it.
//
// Design (simple first): one thread block of 512 threads per tile of 416
// output samples plus a 48-sample halo on each side, one thread per
// sample. Blocks share nothing, so each recomputes its own halo: the four
// layers consume sum(d_i + 1) = 44 samples of it and the epilogue 3 more.
// Halo samples use the kernels of the frame they lie in, so any hop >= 1
// and any frame count work. The carry, a and y live in shared memory as
// bf16 (3 x 32 KB), W_i as f32 (12 KB); the per-frame LVC kernels are read
// from global memory / L1 / L2 as 16-byte vectors (rows padded to a
// multiple of 8). All products run on the f32 CUDA cores;
// lvc_block_ncl_tc.cu runs the two contractions on the tensor cores.
//
// Kernel B-SR (template flag SAVE) adds a store epilogue to each layer: the
// center samples of a tile write s (after the skip-add, masked, before the
// leaky), y (the bf16 input of the LVC) and z (the pre-gate LVC output,
// summed in f32 and stored rounded to bf16), the values the block already
// holds. Per hop-256 block call of the training recipe (B = 20, L = 25,600)
// that is 0.52 GB of extra writes (s and y 131 MB each, z 262 MB), about
// 0.16 ms at 3.35 TB/s against the block's f32 math: the stores, not the
// algorithm, are what the SAVE variant adds.

// K6 (template flag NWC) replaces fastdiff_tpu/ops/lvc_block_pallas.py:
// _fused_call (its pallas_call, body _kernel_body), the block of the NWC
// route. Same formula; the layouts are those of that route:
//   x, skip, out  (B, L, C): one sample's 32 channels are 64 contiguous
//                 bytes; they load into and store from the same [C][EXT]
//                 shared-memory tiles, with no transpose in device memory;
//   kern_aug      (B, F, layers, 3C+1, 2C): the contraction row outermost,
//                 unpadded. Each row is 2C bf16 = 128 bytes, so the LVC loop
//                 runs over rows and reads 16-byte vectors of 8 outputs
//                 (an axpy per row) where the NCL layout reads 8 rows of one
//                 output (a dot); nothing is padded or re-laid in HBM (the
//                 operand is 42.9 MB per block call at 864 frames);
//   wstack        (layers, 3C+1, C): staged into the same f32 tile as
//                 wstack_t, read in its own order.
// Like K1 it recomputes a 48-sample halo per tile, so any hop >= 1 and any
// frame count work; the route calls K6 only where JAX's fusable admits the
// block (hop >= 64, at least 2 frames), and this kernel only where the hop
// is no multiple of 8.

#include "lvc_block_common.cuh"

namespace {

constexpr size_t SMEM_BYTES =
    3 * C * EXT * sizeof(bf16) + (3 * C * C + C + 8 * C) * sizeof(float);

template <bool FINAL, bool SAVE, bool NWC>
__global__ void __launch_bounds__(EXT, 2)
lvc_block_kernel(const bf16* __restrict__ x, const bf16* __restrict__ skip,
                 const bf16* __restrict__ kern,
                 const bf16* __restrict__ wstack,
                 const bf16* __restrict__ final_wb, bf16* __restrict__ out,
                 float* __restrict__ fin, bf16* __restrict__ s_all,
                 bf16* __restrict__ y_all, bf16* __restrict__ z_all, int L,
                 int F, int hop, int rows_p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* carry = reinterpret_cast<bf16*>(smem_raw);   // [C][EXT]
  bf16* act = carry + C * EXT;                        // [C][EXT]
  bf16* ybuf = act + C * EXT;                         // [C][EXT]
  float* wt = reinterpret_cast<float*>(ybuf + C * EXT);  // [3C][C]
  float* wb = wt + 3 * C * C;                         // [C]
  float* wf = wb + C;                                 // [8][C]

  const int e = threadIdx.x;
  const int b = blockIdx.y;
  const long g = (long)blockIdx.x * TILE - HALO + e;  // global sample
  const bool valid = g >= 0 && g < L;
  // SAVE: this thread's sample is one the tile outputs
  const bool save = SAVE && valid && e >= HALO && e < HALO + TILE;
  const bf16* xb = x + (size_t)b * C * L;     // one batch row, either layout
  const bf16* sb = skip + (size_t)b * C * L;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int c = 0; c < C; ++c)
    carry[c * EXT + e] = valid ? xb[act_at<NWC>(c, g, L)] : zero;
  if (FINAL)
    for (int idx = e; idx < 8 * C; idx += EXT) wf[idx] = to_f(final_wb[idx]);

  long f = g < 0 ? 0 : g / hop;
  if (f > F - 1) f = F - 1;
  const bf16* kern_f = kern + (((size_t)b * F + f) * LAYERS) * 2 * C * rows_p;

  int d = 1;
  for (int i = 0; i < LAYERS; ++i, d *= 3) {
    __syncthreads();
    // residual rows of layer i: s/y at (b, i, c, g), z at (b, i, c2, g)
    bf16* si = s_all + ((size_t)b * LAYERS + i) * C * L + g;
    bf16* yi = y_all + ((size_t)b * LAYERS + i) * C * L + g;
    bf16* zi = z_all + ((size_t)b * LAYERS + i) * 2 * C * L + g;
    skip_add_stage<NWC, SAVE>(wstack + (size_t)i * C * ROWS, sb, carry, act,
                              wt, wb, e, g, L, valid, save, si);
    __syncthreads();
    dilated_conv<SAVE>(act, wt, wb, ybuf, e, d, L, valid, save, yi);
    __syncthreads();

    // z = K_{i,f} . [y(t-1); y; y(t+1); 1]; carry = s + bf16(gate)
    const bf16* ki = kern_f + (size_t)i * 2 * C * rows_p;
    for (int oc = 0; oc < C; oc += 8) {
      float zs[8], zt[8];
      if (NWC) {  // ki[r][o]: rows of 2C outputs, 16-byte vectors along o
#pragma unroll
        for (int j = 0; j < 8; ++j) zs[j] = zt[j] = 0.0f;
        const bf16* kb = ki + (size_t)3 * C * 2 * C;   // the bias row
        axpy8(__ldg(reinterpret_cast<const uint4*>(kb + oc)), 1.0f, zs);
        axpy8(__ldg(reinterpret_cast<const uint4*>(kb + C + oc)), 1.0f, zt);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int src = e + k - 1;
          const bool in = src >= 0 && src < EXT;
          for (int c = 0; c < C; ++c) {
            const float v = in ? to_f(ybuf[c * EXT + src]) : 0.0f;
            const bf16* kr = ki + (size_t)(k * C + c) * 2 * C;
            axpy8(__ldg(reinterpret_cast<const uint4*>(kr + oc)), v, zs);
            axpy8(__ldg(reinterpret_cast<const uint4*>(kr + C + oc)), v, zt);
          }
        }
      } else {  // ki[o][r]: rows_p-padded rows, 16-byte vectors along r
        lvc_dot_ncl<true>(ki, rows_p, ybuf, e, oc, zs, zt);
      }
      if (save) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          zi[(size_t)(oc + j) * L] = __float2bfloat16(zs[j]);
          zi[(size_t)(C + oc + j) * L] = __float2bfloat16(zt[j]);
        }
      }
      gate_update(carry, e, oc, zs, zt);
    }
  }
  __syncthreads();

  if (e < HALO || e >= HALO + TILE || !valid) return;
  bf16* ob = out + (size_t)b * C * L;
  for (int c = 0; c < C; ++c) ob[act_at<NWC>(c, g, L)] = carry[c * EXT + e];
  if (FINAL) fin[(size_t)b * L + g] = final_conv(carry, wf, e, g, L);
}

template <bool FINAL, bool SAVE, bool NWC = false>
int launch(const void* x, const void* skip, const void* kern,
           const void* wstack, const void* final_wb, void* out, void* fin,
           void* s_all, void* y_all, void* z_all, int B, int L, int F,
           int hop, int rows_p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      lvc_block_kernel<FINAL, SAVE, NWC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + TILE - 1) / TILE, B);
  lvc_block_kernel<FINAL, SAVE, NWC><<<grid, EXT, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(skip),
      static_cast<const bf16*>(kern), static_cast<const bf16*>(wstack),
      static_cast<const bf16*>(final_wb), static_cast<bf16*>(out),
      static_cast<float*>(fin), static_cast<bf16*>(s_all),
      static_cast<bf16*>(y_all), static_cast<bf16*>(z_all), L, F, hop,
      rows_p);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int channels, int L, int F, int hop, int rows_p, int layers) {
  return channels != C || layers != LAYERS || rows_p % 8 != 0 ||
         rows_p < ROWS || hop < 1 || (long)F * hop != L;
}

}  // namespace

// x, skip (B, C, L) bf16; kern (B, F, layers, 2C, rows_p) bf16;
// wstack_t (layers, C, 3C+1) bf16; final_wb (8, C) bf16 or NULL;
// out (B, C, L) bf16; fin (B, 1, L) f32 or NULL. Only C = 32, layers = 4 and
// rows_p % 8 == 0 are built (the Python wrapper checks). Any hop >= 1.
// Launches on `stream`; returns cudaGetLastError() (or the attribute call's
// error).
extern "C" int lvc_block_ncl_cc_launch(const void* x, const void* skip,
                                       const void* kern, const void* wstack_t,
                                       const void* final_wb, void* out,
                                       void* fin, int B, int channels, int L,
                                       int F, int hop, int rows_p, int layers,
                                       void* stream) {
  if (bad_shape(channels, L, F, hop, rows_p, layers))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (final_wb != nullptr)
    return launch<true, false>(x, skip, kern, wstack_t, final_wb, out, fin,
                               nullptr, nullptr, nullptr, B, L, F, hop,
                               rows_p, s);
  return launch<false, false>(x, skip, kern, wstack_t, nullptr, out, nullptr,
                              nullptr, nullptr, nullptr, B, L, F, hop, rows_p,
                              s);
}

// Kernel B-SR on the CUDA cores (any hop >= 1; lvc_block_ncl_tc.cu runs
// hops that are multiples of 8): Kernel B that also writes s_all, y_all
// (B, layers, C, L) and z_all (B, layers, 2C, L), all bf16, for the center
// samples of every tile (so every sample once). Same operands and checks
// as lvc_block_ncl_cc_launch.
extern "C" int lvc_block_ncl_sr_cc_launch(const void* x, const void* skip,
                                          const void* kern,
                                          const void* wstack_t, void* out,
                                          void* s_all, void* y_all,
                                          void* z_all, int B,
                                          int channels, int L, int F, int hop,
                                          int rows_p, int layers,
                                          void* stream) {
  if (bad_shape(channels, L, F, hop, rows_p, layers))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false, true>(x, skip, kern, wstack_t, nullptr, out, nullptr,
                             s_all, y_all, z_all, B, L, F, hop, rows_p,
                             static_cast<cudaStream_t>(stream));
}

// K6 on the CUDA cores (any hop >= 1; lvc_block_nwc_tc.cu runs hops that
// are multiples of 8): the block in the NWC layout. x, skip, out (B, L, C)
// bf16; kern_aug (B, F, layers, 3C+1, 2C) bf16, rows unpadded (rows ==
// 3C+1); wstack (layers, 3C+1, C) bf16. Only C = 32 and layers = 4 are
// built (the Python wrapper checks). Launches on `stream`; returns
// cudaGetLastError() (or the attribute call's error).
extern "C" int lvc_block_nwc_cc_launch(const void* x, const void* skip,
                                       const void* kern_aug,
                                       const void* wstack, void* out, int B,
                                       int channels, int L, int F, int hop,
                                       int rows, int layers, void* stream) {
  if (channels != C || layers != LAYERS || rows != ROWS || hop < 1 ||
      (long)F * hop != L)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<false, false, true>(x, skip, kern_aug, wstack, nullptr, out,
                                    nullptr, nullptr, nullptr, nullptr, B, L,
                                    F, hop, rows,
                                    static_cast<cudaStream_t>(stream));
}
