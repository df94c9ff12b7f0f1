// Kernel B on the tensor cores: K1 (the whole 4-layer time-aware LVC block,
// NCL) and K2 (the same with the model's final k=7 C->1 conv as an
// epilogue), for every hop that is a multiple of 8.
//
// Replaces fastdiff_tpu/ops/lvc_block_ncl.py:lvc_block_ncl_aug, both of its
// pallas_call sites (_kernel_body and _kernel_body_final). Layer i, with
// d = 3^i (lvc_block_tc.cuh):
//
//   s     = bf16(carry + skip)                 (zero outside [0, L))
//   y     = bf16(leaky0.2(W_i . [a(t-d); a; a(t+d)] + b_i)),  a = leaky0.2(s)
//           (zero outside [0, L))
//   z     = K_{i,f} . [y(t-1); y; y(t+1)] + bias_{i,f}   (f = t / hop, f32)
//   carry = s + bf16(sigmoid(z[:C]) * tanh(z[C:]))
//
// and with final_wb the f32 output fin[t] = sum_{tap,c} carry[c, t+tap-3]
// * final_wb[tap, c] + final_wb[7, 0] over the carry masked to [0, L).
//
// What bounds it on an H100: per output sample and layer 2 * 32 * 97 FLOPs
// of conv and 2 * 64 * 97 of LVC, ~16.5 GFLOP for the hop-256 block of a
// 10 s utterance (L = 221,184): 17 us at the 989 TFLOP/s bf16 peak,
// against 27 us to move its ~90 MB (x, skip, out, fin and the 46 MB
// kern_taug operand) at 3.35 TB/s. So the bytes bound it, and kern_taug is
// half of them: at hop 8 it is nearly all (46 MB of 47).
//
// Design (lvc_block_tc.cuh holds the stages):
// - Both contractions are bf16 mma.sync.m16n8k16 products with f32
//   accumulation, output channels as M and samples as N. The bias row of
//   kern_taug and W_i's bias column initialise the accumulators. bf16 x
//   bf16 products are exact in f32, so only the order of summation differs
//   from the plain version's; bf16 is rounded at the same places.
// - mma.sync fed by ldmatrix, not wgmma: every tap is a row shift of one
//   sample-major tile (+-1 for the LVC, +-1, 3, 9, 27 for the conv), and
//   ldmatrix takes one row address per lane, so any shift reads the B
//   operand in place; wgmma's shared-memory descriptors address 8-row core
//   matrices and swizzle atoms that such shifts break. At these shapes the
//   mma.sync rate still leaves the block near its bytes bound.
// - carry, a and y live in shared memory as bf16 [ext][40] (80-byte rows,
//   conflict-free for ldmatrix and 16-byte accesses); W_i as bf16
//   [32][104], held in registers through the conv. K_{i,f} is read as A
//   fragments straight from global memory, so each byte of kern_taug is
//   loaded once per block that needs its frame, with no staging: at hop 8
//   every n8 tile is its own frame, and a tile's ~20-65 frames of 13.3 KB
//   slabs would not fit an SM.
// - The sigmoid-half and tanh-half m16 tiles of one warp hold the same
//   (channel, sample) positions, so the gate and the residual update run
//   on the accumulators with no exchange.
// - Tiling: 256 threads, two blocks per SM (launch bounds cap a thread at
//   128 registers; ptxas reports no spills), a tile of `tile` output
//   samples (a multiple of 8, at most 328) plus a 48-sample halo on each
//   side, recomputed per block: the four layers consume sum(d_i + 1) = 44
//   samples of it and the epilogue 3 more. The wrapper
//   (ops/lvc_block_ncl.py:block_tile_plan) picks the tile that minimises
//   waves x extent for the card's SM count; at 864 frames it picks 32 at
//   hop 8 (1 wave, 75 % of the extent recomputed), 216 at hop 64 (1 wave,
//   31 %) and 280 at hop 256 (3 waves, 26 %).
// - The final conv epilogue (448 FMAs per sample) stays on the CUDA cores
//   and reads the sample-major carry.
//
// Kernel B-SR (K4, template flag SAVE; replaces fastdiff_tpu/ops/
// lvc_block_ncl.py:lvc_block_ncl_aug_sr, pallas_call of _kernel_body_sr) is
// the same block writing the per-layer residuals that the training backward
// reads: s (after the skip-add, masked, before the leaky), y (the bf16 input
// of the LVC, in channel order) and the pre-gate z (f32 sums rounded to
// bf16), for the tile's own samples only, into s_all, y_all (B, layers, C,
// L) and z_all (B, layers, 2C, L). The stages already hold these values, so
// SAVE adds only 4-byte stores of sample pairs (lvc_block_tc.cuh): at the
// training recipe (b 20 x 100 frames) 0.52 GB per hop-256 call, 0.16 ms at
// 3.35 TB/s, of a 0.22 ms bytes bound.
//
// Hops that are no multiple of 8 (an n8 tile would straddle two frames)
// run the plain version (ops/lvc_block_ncl.py), as JAX does on the blocks
// its kernels decline.

#include "lvc_block_tc.cuh"

namespace {

// WIDE: hop == 8 (16-byte fragment loads of K_{i,f}, y in ypos order);
// SAVE: Kernel B-SR, writes s_all, y_all, z_all (never with FINAL)
template <bool FINAL, bool WIDE, bool SAVE = false>
__global__ void __launch_bounds__(tc::THREADS, tc::BLOCKS_PER_SM)
lvc_block_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ skip,
                    const bf16* __restrict__ kern,
                    const bf16* __restrict__ wstack_t,
                    const bf16* __restrict__ final_wb, bf16* __restrict__ out,
                    float* __restrict__ fin, int L, int F, int hop,
                    int rows_p, int tile, bf16* __restrict__ s_all,
                    bf16* __restrict__ y_all, bf16* __restrict__ z_all) {
  static_assert(!(FINAL && SAVE), "Kernel B-SR has no epilogue");
  using namespace tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ext = tile + 2 * HALO;
  bf16* carry = reinterpret_cast<bf16*>(smem_raw);  // [ext][ROW]
  bf16* act = carry + (ext + APAD) * ROW;           // [-APAD, ext + APAD)
  bf16* ybuf = act + (ext + APAD + YPAD) * ROW;     // [-YPAD, ext + YPAD)
  bf16* ws = ybuf + (ext + YPAD) * ROW;             // [C][WROW]
  float* wb = reinterpret_cast<float*>(ws + C * WROW);  // [C]
  float* wf = wb + C;                                   // [8][C]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const long g0 = (long)blockIdx.x * tile - HALO;
  const size_t brow = (size_t)b * C * L;

  zero_rows(act - APAD * ROW, APAD, tid);
  zero_rows(act + ext * ROW, APAD, tid);
  zero_rows(ybuf - YPAD * ROW, YPAD, tid);
  zero_rows(ybuf + ext * ROW, YPAD, tid);
  load_rows(x + brow, carry, g0, ext, L, tid);
  if (FINAL)
    for (int idx = tid; idx < 8 * C; idx += THREADS)
      wf[idx] = to_f(final_wb[idx]);
  const bf16* kern_b = kern + (size_t)b * F * LAYERS * 2 * C * rows_p;

  int d = 1;
  for (int i = 0; i < LAYERS; ++i, d *= 3) {
    // SAVE: layer i's (C, L) planes of s and y, (2C, L) of z, batch row b
    const size_t plane = ((size_t)b * LAYERS + i) * C * L;
    bf16* s_i = SAVE ? s_all + plane : nullptr;
    bf16* y_i = SAVE ? y_all + plane : nullptr;
    bf16* z_i = SAVE ? z_all + 2 * plane : nullptr;
    __syncthreads();  // the last layer's gate is done with carry and ws
    stage_weights(wstack_t + (size_t)i * C * ROWS, ws, wb, tid);
    skip_add<SAVE>(skip + brow, carry, act, g0, ext, L, tid, s_i, tile);
    __syncthreads();
    conv_tc<WIDE, SAVE>(act, ws, wb, ybuf, d, g0, ext, L, warp, lane, y_i,
                        tile);
    __syncthreads();
    lvc_gate_tc<WIDE, SAVE>(kern_b, i, ybuf, carry, rows_p, hop, F, g0, ext,
                            warp, lane, z_i, tile);
  }
  __syncthreads();
  store_rows(carry, out + brow, g0, tile, L, tid);
  if (FINAL) final_conv_rows(carry, wf, fin + (size_t)b * L, g0, tile, L, tid);
}

template <bool FINAL, bool WIDE, bool SAVE = false>
int launch(const void* x, const void* skip, const void* kern,
           const void* wstack_t, const void* final_wb, void* out, void* fin,
           int B, int L, int F, int hop, int rows_p, int tile,
           cudaStream_t stream, void* s_all, void* y_all, void* z_all) {
  const int smem = tc::smem_bytes(tile + 2 * HALO);
  cudaError_t err = cudaFuncSetAttribute(
      lvc_block_tc_kernel<FINAL, WIDE, SAVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(lvc_block_tc_kernel<FINAL, WIDE, SAVE>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + tile - 1) / tile, B);
  lvc_block_tc_kernel<FINAL, WIDE, SAVE>
      <<<grid, tc::THREADS, smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(skip),
          static_cast<const bf16*>(kern), static_cast<const bf16*>(wstack_t),
          static_cast<const bf16*>(final_wb), static_cast<bf16*>(out),
          static_cast<float*>(fin), L, F, hop, rows_p, tile,
          static_cast<bf16*>(s_all), static_cast<bf16*>(y_all),
          static_cast<bf16*>(z_all));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int channels, int L, int F, int hop, int rows_p, int layers,
               int tile) {
  return channels != C || layers != LAYERS || rows_p % 8 != 0 ||
         rows_p < ROWS || hop < 8 || hop % 8 != 0 || (long)F * hop != L ||
         tile < 8 || tile % 8 != 0 || tile > tc::TILE_MAX;
}

}  // namespace

// x, skip (B, C, L) bf16; kern (B, F, layers, 2C, rows_p) bf16; wstack_t
// (layers, C, 3C+1) bf16; final_wb (8, C) bf16 or NULL; out (B, C, L) bf16;
// fin (B, 1, L) f32 or NULL; tile from ops/lvc_block_ncl.py:block_tile_plan.
// Only C = 32, layers = 4, rows_p % 8 == 0, hop % 8 == 0 and tile % 8 == 0
// up to tc::TILE_MAX are built (the Python wrapper checks). Launches on
// `stream`; returns cudaGetLastError() (or an attribute call's error).
extern "C" int lvc_block_ncl_launch(const void* x, const void* skip,
                                    const void* kern, const void* wstack_t,
                                    const void* final_wb, void* out,
                                    void* fin, int B, int channels, int L,
                                    int F, int hop, int rows_p, int layers,
                                    int tile, void* stream) {
  if (bad_shape(channels, L, F, hop, rows_p, layers, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = hop == 8;
  if (final_wb != nullptr)
    return (wide ? launch<true, true> : launch<true, false>)(
        x, skip, kern, wstack_t, final_wb, out, fin, B, L, F, hop, rows_p,
        tile, s, nullptr, nullptr, nullptr);
  return (wide ? launch<false, true> : launch<false, false>)(
      x, skip, kern, wstack_t, nullptr, out, nullptr, B, L, F, hop, rows_p,
      tile, s, nullptr, nullptr, nullptr);
}

// Kernel B-SR on the tensor cores: Kernel B that also writes s_all, y_all
// (B, layers, C, L) and z_all (B, layers, 2C, L), all bf16, for the tile's
// own samples (so every sample once). The operands and checks of
// lvc_block_ncl_launch, without final_wb and fin; tile from
// ops/lvc_block_ncl.py:block_tile_plan.
extern "C" int lvc_block_ncl_sr_launch(const void* x, const void* skip,
                                       const void* kern, const void* wstack_t,
                                       void* out, void* s_all, void* y_all,
                                       void* z_all, int B, int channels,
                                       int L, int F, int hop, int rows_p,
                                       int layers, int tile, void* stream) {
  if (bad_shape(channels, L, F, hop, rows_p, layers, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (hop == 8 ? launch<false, true, true> : launch<false, false, true>)(
      x, skip, kern, wstack_t, nullptr, out, nullptr, B, L, F, hop, rows_p,
      tile, s, s_all, y_all, z_all);
}
