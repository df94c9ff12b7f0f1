// K5 on the CUDA cores (lvc_block_ncl_fh_cc_launch): the fused-head LVC
// block for hops that are no multiple of 8; lvc_block_ncl_fh.cu runs the
// others on the tensor cores, and chip_smoke.py races this one against it.
// Kernel B's whole 4-layer block (NCL, see lvc_block_ncl.cu) with the
// kernel-predictor head GEMM run inside the kernel, so the per-frame LVC
// kernels (kern_taug, 46 MB per block call at 864 frames) never reach
// device memory. With final_wb the block also runs Kernel B's final-conv
// epilogue (K5 final).
//
// Replaces fastdiff_tpu/ops/lvc_block_ncl.py:lvc_block_ncl_fh, both of its
// pallas_call sites (_kernel_body_fh and _kernel_body_fh_final, whose head
// is _compute_kern_slabs). For every frame f a tile touches and layer i:
//
//   K_{i,f}[o, r] = bf16( sum_k tap_c[f, k] * w_head[k, i, o, r]
//                         + b_head[i, o, r] )          (f32 accumulation)
//
// then the layer of lvc_block_common.cuh with K_{i,f}. The head's cast
// points are Kernel A's (taug_head.cu): f32 sums, f32 bias, one rounding.
//
// What bounds it on an H100: the useful work of one block call at 864
// frames is the head (864 x 192 x 26,624 x 2 = 8.8 GFLOP) plus the block
// (~16.5 GFLOP at hop 256), against x, skip and out (3 x 14 MB at hop 256),
// the taps (0.3 MB) and w_head (10.2 MB) in device memory: the math bounds
// it. Each tile recomputes the head for every frame it touches, halo
// included (65 / 9 / 3 frames per tile at hops 8 / 64 / 256).
//
// Design (simple first): Kernel B's tile (512 threads, 416 outputs + a
// 48-sample halo each side, one thread per sample; carry and y as bf16 in
// shared memory) with the LVC of each layer run in chunks of FC = 8 frames.
// One frame's slab for one layer is 2C x rows_p bf16 = 13.3 KB, so a chunk
// is 107 KB; it lives where the conv's input `a` lived (free once y is
// made), so the block needs 207 KB of shared memory and one block per SM.
// Per chunk: the chunk's 8 tap rows go to shared memory; the 16 warps share
// the chunk's 208 column tiles of 32 and run the head on the tensor cores
// (WMMA bf16 m8n32k16, f32 accumulators, the B fragments read straight from
// w_head, which stays in the 50 MB L2), add the bias and round into the
// slab; then every (sample, 8-channel group) of the chunk's samples runs the
// LVC from the slab in shared memory and the gate. Slab rows are padded by
// 16 bytes so the four frames a warp spans at hop 8 fall on other banks.
// Samples outside [0, L) skip the LVC: they are masked to zero in every
// layer, as in Kernel B, and no output reads them.

#include <mma.h>

#include "lvc_block_common.cuh"

using namespace nvcuda;

namespace {

constexpr int KH = 192;              // head contraction: conv taps x hidden
constexpr int FC = 8;                // frames per slab chunk (the WMMA M)
constexpr int TAP_LD = KH + 8;       // tap rows in shared memory (elements)
constexpr int NWARPS = EXT / 32;
constexpr int ST_LD = 36;            // per-warp f32 staging tile (8 x 32)
constexpr size_t MAX_SMEM = 232448;  // what one block may use on sm_90

size_t fh_smem_bytes(int rows_p) {
  const size_t slab = (size_t)FC * (2 * C * rows_p + 8) * sizeof(bf16);
  const size_t act = (size_t)C * EXT * sizeof(bf16);
  return (NWARPS * FC * ST_LD + 3 * C * C + C + 8 * C) * sizeof(float) +
         (2 * (size_t)C * EXT + FC * TAP_LD) * sizeof(bf16) +
         (slab > act ? slab : act);
}

// The head of one layer for the chunk's FC frames: slab[j][n] = bf16(
// tap_s[j] . wi[:, n] + bi[n]) for n < n_slab; warps take column tiles of 32
// in turn. wi is layer i's column block of w_head (row length n_all).
__device__ __forceinline__ void head_slabs(const bf16* tap_s,
                                           const bf16* __restrict__ wi,
                                           const float* __restrict__ bi,
                                           int n_slab, int n_all, bf16* slab,
                                           int slab_ld, float* st, int warp,
                                           int lane) {
  wmma::fragment<wmma::matrix_a, FC, 32, 16, bf16, wmma::row_major>
      a[KH / 16];
#pragma unroll
  for (int kk = 0; kk < KH / 16; ++kk)
    wmma::load_matrix_sync(a[kk], tap_s + kk * 16, TAP_LD);
  const int row = lane / 4;
  const int col = (lane % 4) * 8;
  for (int n0 = warp * 32; n0 < n_slab; n0 += NWARPS * 32) {
    wmma::fragment<wmma::accumulator, FC, 32, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < KH / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, FC, 32, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(bw, wi + (size_t)kk * 16 * n_all + n0, n_all);
      wmma::mma_sync(acc, a[kk], bw, acc);
    }
    wmma::store_matrix_sync(st, acc, ST_LD, wmma::mem_row_major);
    __syncwarp();
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bi + n0 + col));
    const float4 b1 =
        __ldg(reinterpret_cast<const float4*>(bi + n0 + col + 4));
    const float* sr = st + row * ST_LD + col;
    const __nv_bfloat162 p0 = __floats2bfloat162_rn(sr[0] + b0.x, sr[1] + b0.y);
    const __nv_bfloat162 p1 = __floats2bfloat162_rn(sr[2] + b0.z, sr[3] + b0.w);
    const __nv_bfloat162 p2 = __floats2bfloat162_rn(sr[4] + b1.x, sr[5] + b1.y);
    const __nv_bfloat162 p3 = __floats2bfloat162_rn(sr[6] + b1.z, sr[7] + b1.w);
    uint4 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&p0);
    packed.y = *reinterpret_cast<const uint32_t*>(&p1);
    packed.z = *reinterpret_cast<const uint32_t*>(&p2);
    packed.w = *reinterpret_cast<const uint32_t*>(&p3);
    *reinterpret_cast<uint4*>(slab + (size_t)row * slab_ld + n0 + col) =
        packed;
    __syncwarp();
  }
}

template <bool FINAL>
__global__ void __launch_bounds__(EXT, 1)
lvc_block_fh_kernel(const bf16* __restrict__ x, const bf16* __restrict__ skip,
                    const bf16* __restrict__ tap_c,
                    const bf16* __restrict__ w_head,
                    const float* __restrict__ b_head,
                    const bf16* __restrict__ wstack,
                    const bf16* __restrict__ final_wb, bf16* __restrict__ out,
                    float* __restrict__ fin, int L, int F, int hop,
                    int rows_p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* stage = reinterpret_cast<float*>(smem_raw);  // [NWARPS][FC][ST_LD]
  float* wt = stage + NWARPS * FC * ST_LD;             // [3C][C]
  float* wb = wt + 3 * C * C;                          // [C]
  float* wf = wb + C;                                  // [8][C]
  bf16* carry = reinterpret_cast<bf16*>(wf + 8 * C);   // [C][EXT]
  bf16* ybuf = carry + C * EXT;                        // [C][EXT]
  bf16* tap_s = ybuf + C * EXT;                        // [FC][TAP_LD]
  bf16* act = tap_s + FC * TAP_LD;                     // [C][EXT], then
  bf16* slab = act;                                    // [FC][slab_ld]

  const int n_slab = 2 * C * rows_p;
  const int slab_ld = n_slab + 8;
  const int n_all = LAYERS * n_slab;
  const int e = threadIdx.x;
  const int warp = e / 32;
  const int lane = e % 32;
  const int b = blockIdx.y;
  const long g0 = (long)blockIdx.x * TILE - HALO;     // the extent's first
  const long g = g0 + e;                              // global sample
  const bool valid = g >= 0 && g < L;
  const bf16* xb = x + (size_t)b * C * L;
  const bf16* sb = skip + (size_t)b * C * L;
  const bf16* tb = tap_c + (size_t)b * F * KH;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int c = 0; c < C; ++c)
    carry[c * EXT + e] = valid ? xb[(size_t)c * L + g] : zero;
  if (FINAL)
    for (int idx = e; idx < 8 * C; idx += EXT) wf[idx] = to_f(final_wb[idx]);

  // the extent's samples in [0, L) and the frames they lie in
  const long g_lo = g0 < 0 ? 0 : g0;
  const long g_hi = (g0 + EXT < L ? g0 + EXT : (long)L) - 1;
  const int f_lo = (int)(g_lo / hop);
  const int f_hi = (int)(g_hi / hop);

  int d = 1;
  for (int i = 0; i < LAYERS; ++i, d *= 3) {
    __syncthreads();
    skip_add_stage<false, false>(wstack + (size_t)i * C * ROWS, sb, carry,
                                 act, wt, wb, e, g, L, valid, false, nullptr);
    __syncthreads();
    dilated_conv<false>(act, wt, wb, ybuf, e, d, L, valid, false, nullptr);

    const bf16* wi = w_head + (size_t)i * n_slab;
    const float* bi = b_head + (size_t)i * n_slab;
    for (int fa = f_lo; fa <= f_hi; fa += FC) {
      const int nf = min(FC, f_hi - fa + 1);
      // y is made, `a` and the last chunk's slabs are read: reuse them
      __syncthreads();
      for (int v = e; v < FC * KH / 8; v += EXT) {
        const int j = v / (KH / 8);
        const int k8 = (v % (KH / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (j < nf)
          val = __ldg(reinterpret_cast<const uint4*>(
              tb + (size_t)(fa + j) * KH + k8));
        *reinterpret_cast<uint4*>(tap_s + j * TAP_LD + k8) = val;
      }
      __syncthreads();
      head_slabs(tap_s, wi, bi, n_slab, n_all, slab, slab_ld,
                 stage + warp * FC * ST_LD, warp, lane);
      __syncthreads();
      // the LVC and gate of the chunk's samples, one (sample, group of 8
      // channels) per item
      const long s_lo = (long)fa * hop > g_lo ? (long)fa * hop : g_lo;
      const long s_end = (long)(fa + nf) * hop - 1;
      const long s_hi = s_end < g_hi ? s_end : g_hi;
      const int e_lo = (int)(s_lo - g0);
      const int n = (int)(s_hi - s_lo + 1);
      for (int it = e; it < (C / 8) * n; it += EXT) {
        const int oc = (it / n) * 8;
        const int ee = e_lo + it % n;
        const int jf = (int)((g0 + ee) / hop) - fa;
        float zs[8], zt[8];
        lvc_dot_ncl<false>(slab + (size_t)jf * slab_ld, rows_p, ybuf, ee, oc,
                           zs, zt);
        gate_update(carry, ee, oc, zs, zt);
      }
    }
  }
  __syncthreads();

  if (e < HALO || e >= HALO + TILE || !valid) return;
  bf16* ob = out + (size_t)b * C * L;
  for (int c = 0; c < C; ++c) ob[(size_t)c * L + g] = carry[c * EXT + e];
  if (FINAL) fin[(size_t)b * L + g] = final_conv(carry, wf, e, g, L);
}

template <bool FINAL>
int launch_fh(const void* x, const void* skip, const void* tap_c,
              const void* w_head, const void* b_head, const void* wstack,
              const void* final_wb, void* out, void* fin, int B, int L,
              int F, int hop, int rows_p, cudaStream_t stream) {
  const size_t smem = fh_smem_bytes(rows_p);
  cudaError_t err = cudaFuncSetAttribute(
      lvc_block_fh_kernel<FINAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + TILE - 1) / TILE, B);
  lvc_block_fh_kernel<FINAL><<<grid, EXT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(skip),
      static_cast<const bf16*>(tap_c), static_cast<const bf16*>(w_head),
      static_cast<const float*>(b_head), static_cast<const bf16*>(wstack),
      static_cast<const bf16*>(final_wb), static_cast<bf16*>(out),
      static_cast<float*>(fin), L, F, hop, rows_p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, skip (B, C, L) bf16; tap_c (B, F, khead) bf16; w_head (khead, layers *
// 2C * rows_p) bf16 (Kernel A's packing); b_head (layers * 2C * rows_p,) f32;
// wstack_t (layers, C, 3C+1) bf16; final_wb (8, C) bf16 or NULL; out
// (B, C, L) bf16; fin (B, 1, L) f32 or NULL. Only C = 32, 4 layers, khead =
// 192 and rows_p % 8 == 0 are built; w_head must be 32-byte aligned and the
// other pointers 16-byte aligned (the Python wrapper checks). Launches on
// `stream`; returns cudaGetLastError() (or the attribute call's error).
extern "C" int lvc_block_ncl_fh_cc_launch(
    const void* x, const void* skip, const void* tap_c, const void* w_head,
    const void* b_head, const void* wstack_t, const void* final_wb, void* out,
    void* fin, int B, int channels, int L, int F, int hop, int khead,
    int rows_p, int layers, void* stream) {
  if (channels != C || layers != LAYERS || khead != KH || rows_p % 8 != 0 ||
      rows_p < ROWS || hop < 1 || (long)F * hop != L ||
      fh_smem_bytes(rows_p) > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (final_wb != nullptr)
    return launch_fh<true>(x, skip, tap_c, w_head, b_head, wstack_t,
                           final_wb, out, fin, B, L, F, hop, rows_p, s);
  return launch_fh<false>(x, skip, tap_c, w_head, b_head, wstack_t, nullptr,
                          out, nullptr, B, L, F, hop, rows_p, s);
}
