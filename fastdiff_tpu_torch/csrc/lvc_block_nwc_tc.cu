// K6 on the tensor cores: the whole 4-layer LVC block of the NWC route, for
// every hop that is a multiple of 8 (the route's K6 hops are 64 and 256).
//
// Replaces fastdiff_tpu/ops/lvc_block_pallas.py:_fused_call (its
// pallas_call, body _kernel_body). Other hops run the plain version
// (ops/lvc_block_pallas.py:lvc_block_nwc_plain). Layer i with d = 3^i:
//
//   s     = bf16(carry + skip)                 (zero outside [0, L))
//   y     = bf16(leaky0.2(W_i . [a(t-d); a; a(t+d)] + b_i)),  a = leaky0.2(s)
//   z     = K_{i,f} . [y(t-1); y; y(t+1)] + bias_{i,f}   (f = t / hop, f32)
//   carry = s + bf16(sigmoid(z[:C]) * tanh(z[C:]))
//
// with the route's layouts: x, skip, out (B, L, C); kern_aug (B, F, layers,
// 3C+1, 2C), contraction row r = k C + c, the bias in row 3C, unpadded;
// wstack (layers, 3C+1, C).
//
// What bounds it on an H100: at 864 frames a hop-64 call moves 10.6 MB of
// x, skip and out and 42.9 MB of kern_aug (16 us at 3.35 TB/s) for 4.1
// GFLOP (4 us at 989 TFLOP/s bf16); at hop 256 it is 42.5 + 42.9 MB (25
// us) for 16.5 GFLOP (17 us). The bytes bound it.
//
// Design (the stages are lvc_block_tc.cuh's, as K1's):
// - I/O. A sample's 32 channels are one 64-byte row in device memory, so x
//   and skip load and out stores as 16-byte vectors straight into and out
//   of the sample-major [ext][ROW] shared-memory rows, with no per-channel
//   gather. wstack (97, C) is staged as ws[o][r] for conv_tc.
// - Both contractions are bf16 mma.sync.m16n8k16 with f32 accumulation,
//   output channels as M and samples as N, as in K1: conv_tc as it is, and
//   the LVC through gate_tile<2>, whose sigmoid and tanh m16 tiles hold the
//   same (channel, sample) positions in one lane, so the gate and the
//   residual update run on the accumulators.
// - K_{i,f} comes by TMA: one box of 97 rows x 128 bytes (its (3C+1, 2C)
//   slab as it lies) with the 128-byte swizzle, into a ring of two slots
//   across the frames a tile spans; frame j + 2 is requested as soon as
//   every warp is done with frame j, so the next frame's slab is in flight
//   while one is computed. The slab is K-major for the LVC's A operand, so
//   ldmatrix.trans reads the A fragments in place, conflict-free
//   (a_frag_swz); its bias row initialises the accumulators.
// - Outputs as M rather than samples as M (stage_micro.cu's lvc_stage):
//   with samples as M a warp would hold the B fragments of all 64 outputs
//   (96 registers) or reload them per m16 tile, and the conv would need the
//   other orientation too; with outputs as M the conv, the ybuf rows, the
//   gate and the 256-thread, two-blocks-per-SM tile are K1's, and an n8
//   tile of samples lies in one frame whenever hop % 8 == 0.
// - Shared memory: the ring (2 x 13 KB) shares its bytes with the conv's
//   input `a`, which is dead once y is made; the pad rows around `a` are
//   zeroed again in every layer. So the tile is K1's (ops/lvc_block_ncl.
//   py:block_tile_plan, two blocks per SM) at 55-114 KB a block.
// - n8 tiles wholly outside [0, L) skip the LVC: their s is zero and is
//   masked again in the next layer, and no output reads them.

#include "lvc_block_tc.cuh"
#include "tma.cuh"

namespace {
namespace tc {

constexpr int NWC_STAGES = 2;             // ring slots of K_{i,f}
constexpr int NWC_SLOT = 13312;           // a slot: 13 swizzle atoms
constexpr int NWC_KBYTES = ROWS * 2 * C * 2;  // one slab: 12,416 bytes
constexpr int NWC_ALIGN = 1024;           // the 128-byte swizzle's atom
static_assert(NWC_KBYTES <= NWC_SLOT && NWC_SLOT % NWC_ALIGN == 0,
              "a slot holds a slab and keeps the swizzle");

// the bytes `a` (with its pad rows) and the ring share
__host__ __device__ constexpr int nwc_union_bytes(int ext) {
  return (ext + 2 * APAD) * ROW * 2 > NWC_STAGES * NWC_SLOT
             ? (ext + 2 * APAD) * ROW * 2
             : NWC_STAGES * NWC_SLOT;
}

// dynamic shared memory of a block whose extent is `ext` samples: the
// alignment slack, a and the ring, carry, ybuf with its pad rows, W_i, its
// bias and two mbarriers
__host__ __device__ constexpr int nwc_smem_bytes(int ext) {
  return NWC_ALIGN + nwc_union_bytes(ext) + (2 * ext + 2 * YPAD) * ROW * 2 +
         C * WROW * 2 + C * 4 + 16;
}
static_assert(BLOCKS_PER_SM * (nwc_smem_bytes(EXT_MAX) + 1024) <= 233472,
              "two blocks of the largest tile must fit one SM");

// dst[e] = src[g0 + e] of an (L, C) batch row, zero outside [0, L)
__device__ __forceinline__ void load_rows_nwc(const bf16* __restrict__ src,
                                              bf16* dst, long g0, int ext,
                                              int L, int tid) {
  for (int idx = tid; idx < ext * (C / 8); idx += THREADS) {
    const int e = idx / (C / 8), q = idx % (C / 8);
    const long g = g0 + e;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g >= 0 && g < L) v = ldg128(src + g * C + 8 * q);
    reinterpret_cast<uint4*>(dst + e * ROW)[q] = v;
  }
}

// s = bf16(carry + skip), zero outside [0, L), into carry; a = bf16(
// leaky(s)) into act; `sb` is the (L, C) batch row of skip
__device__ __forceinline__ void skip_add_nwc(const bf16* __restrict__ sb,
                                             bf16* carry, bf16* act, long g0,
                                             int ext, int L, int tid) {
  for (int idx = tid; idx < ext * (C / 8); idx += THREADS) {
    const int e = idx / (C / 8), q = idx % (C / 8);
    const long g = g0 + e;
    const bool valid = g >= 0 && g < L;
    float k[8], s[8], a[8];
    unpack8(valid ? ldg128(sb + g * C + 8 * q) : make_uint4(0u, 0u, 0u, 0u),
            k);
    uint4* crow = reinterpret_cast<uint4*>(carry + e * ROW) + q;
    unpack8(*crow, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = valid ? round_bf(s[j] + k[j]) : 0.0f;
      a[j] = leaky(s[j]);
    }
    *crow = pack8(s);
    reinterpret_cast<uint4*>(act + e * ROW)[q] = pack8(a);
  }
}

// Stage W_i, a (3C+1, C) block of wstack, as ws[o][r] bf16 and its bias
// row as wb[o] f32.
__device__ __forceinline__ void stage_weights_nwc(const bf16* __restrict__ w,
                                                  bf16* ws, float* wb,
                                                  int tid) {
  for (int idx = tid; idx < C * ROWS; idx += THREADS) {
    const int r = idx / C, o = idx % C;
    if (r < 3 * C)
      ws[o * WROW + r] = w[idx];
    else
      wb[o] = to_f(w[idx]);
  }
}

// out[g] = carry[e] for the tile's own samples, into an (L, C) batch row
__device__ __forceinline__ void store_rows_nwc(const bf16* carry,
                                               bf16* __restrict__ ob,
                                               long g0, int tile, int L,
                                               int tid) {
  for (int idx = tid; idx < tile * (C / 8); idx += THREADS) {
    const int e = HALO + idx / (C / 8), q = idx % (C / 8);
    const long g = g0 + e;
    if (g < L)
      reinterpret_cast<uint4*>(ob + g * C)[q] =
          reinterpret_cast<const uint4*>(carry + e * ROW)[q];
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
lvc_block_nwc_tc_kernel(const __grid_constant__ CUtensorMap map_k,
                        const bf16* __restrict__ x,
                        const bf16* __restrict__ skip,
                        const bf16* __restrict__ wstack,
                        bf16* __restrict__ out, int L, int F, int hop,
                        int tile) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + NWC_ALIGN - 1) & ~uint32_t(NWC_ALIGN - 1);
  unsigned char* base = smem_raw + (ring - raw);
  const int ext = tile + 2 * HALO;
  // [ring | a with its pad rows], carry, ybuf with its pad rows, ws, wb
  bf16* act = reinterpret_cast<bf16*>(base) + APAD * ROW;
  bf16* carry = reinterpret_cast<bf16*>(base + nwc_union_bytes(ext));
  bf16* ybuf = carry + (ext + YPAD) * ROW;
  bf16* ws = ybuf + (ext + YPAD) * ROW;
  float* wb = reinterpret_cast<float*>(ws + C * WROW);
  const uint32_t full = smem_u32(wb + C);  // one mbarrier per slot

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const long g0 = (long)blockIdx.x * tile - HALO;
  const size_t brow = (size_t)b * L * C;
  if (tid == 0) {
    for (int s = 0; s < NWC_STAGES; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  zero_rows(ybuf - YPAD * ROW, YPAD, tid);
  zero_rows(ybuf + ext * ROW, YPAD, tid);
  load_rows_nwc(x + brow, carry, g0, ext, L, tid);

  // the extent's samples in [0, L) ([lo, hi), never empty) and their frames
  const int lo = g0 < 0 ? 0 : static_cast<int>(g0);
  const int hi = g0 + ext < L ? static_cast<int>(g0 + ext) : L;
  const int f_lo = lo / hop;
  const int nf = (hi - 1) / hop - f_lo + 1;
  const int p = warp & 1, run = warp >> 1, gq = lane >> 2;

  int d = 1;
  for (int i = 0, n = 0; i < LAYERS; ++i, d *= 3, n += nf) {
    __syncthreads();  // the last layer's gate is done with carry and ws
    stage_weights_nwc(wstack + (size_t)i * ROWS * C, ws, wb, tid);
    // the ring overwrote a's pad rows in the last layer
    zero_rows(act - APAD * ROW, APAD, tid);
    zero_rows(act + ext * ROW, APAD, tid);
    skip_add_nwc(skip + brow, carry, act, g0, ext, L, tid);
    __syncthreads();
    conv_tc<false>(act, ws, wb, ybuf, d, g0, ext, L, warp, lane);
    __syncthreads();  // a is read: the ring may take its bytes

    // load n + j (frame f_lo + j of this layer) into slot (n + j) & 1
    auto request = [&](int j) {
      const int s = (n + j) & 1;
      mbar_expect_tx(full + 8 * s, NWC_KBYTES);
      tma_load(ring + s * NWC_SLOT, &map_k, full + 8 * s, 0,
               (((b * F) + f_lo + j) * LAYERS + i) * ROWS);
    };
    if (tid == 0) {
      // a's generic-proxy writes before the TMA's async-proxy writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      for (int j = 0; j < NWC_STAGES && j < nf; ++j) request(j);
    }
    for (int j = 0; j < nf; ++j) {
      const int s = (n + j) & 1;
      mbar_wait_or_trap(full + 8 * s, ((n + j) >> 1) & 1);
      // the frame's n8 tiles inside [lo, hi), as extent rows
      const int f = f_lo + j;
      const int e_a = max(f * hop, lo) - static_cast<int>(g0);
      const int e_b = min((f + 1) * hop, hi) - static_cast<int>(g0);
      const int tiles = (e_b - e_a) / 8;
      if (run < tiles) {
        const uint32_t slot = ring + s * NWC_SLOT;
        const unsigned char* bias_row = base + s * NWC_SLOT + 3 * C * 128;
        uint32_t ka[2][6][4];
        float kb[2][2];
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          const int m0 = 16 * p + C * mm;
#pragma unroll
          for (int ks = 0; ks < 6; ++ks)
            a_frag_swz(ka[mm][ks], slot, m0, ks, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + gq + 8 * h;  // swizzle of row 3C: none
            kb[mm][h] = to_f(*reinterpret_cast<const bf16*>(
                bias_row + ((m >> 3) << 4) + (m & 7) * 2));
          }
        }
        for (int t = run; t < tiles; t += WARPS / 2)
          gate_tile<2>(ka, kb, ybuf, carry, e_a + 8 * t, 16 * p, lane);
      }
      __syncthreads();  // every warp is done with slot s
      if (tid == 0 && j + NWC_STAGES < nf) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        request(j + NWC_STAGES);
      }
    }
  }
  __syncthreads();
  store_rows_nwc(carry, out + brow, g0, tile, L, tid);
}

}  // namespace tc
}  // namespace

// K6 on the tensor cores. x, skip, out (B, L, C) bf16; kern_aug (B, F,
// layers, 3C+1, 2C) bf16, rows unpadded (rows == 3C+1), 128-byte aligned;
// wstack (layers, 3C+1, C) bf16; tile and smem from ops/lvc_block_pallas.
// py:nwc_tile_plan. Only C = 32, 4 layers, hop % 8 == 0, tile % 8 == 0 up
// to tc::TILE_MAX and smem == tc::nwc_smem_bytes(tile + 2 HALO) are built
// (the Python wrapper checks). Launches on `stream`; returns
// cudaGetLastError() (or the tensor map's or an attribute call's error).
extern "C" int lvc_block_nwc_launch(const void* x, const void* skip,
                                    const void* kern_aug, const void* wstack,
                                    void* out, int B, int channels, int L,
                                    int F, int hop, int rows, int layers,
                                    int tile, int smem, void* stream) {
  using namespace tc;
  if (channels != C || layers != LAYERS || rows != ROWS || hop < 8 ||
      hop % 8 != 0 || (long)F * hop != L || tile < 8 || tile % 8 != 0 ||
      tile > TILE_MAX || smem != nwc_smem_bytes(tile + 2 * HALO) || B < 1 ||
      (long long)B * F * LAYERS * ROWS > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(kern_aug) % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_k;
  int err = tensor_map(&map_k, kern_aug, 2 * C,
                       (uint64_t)B * F * LAYERS * ROWS, 2 * C, ROWS);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      lvc_block_nwc_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(lvc_block_nwc_tc_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((L + tile - 1) / tile, B);
  lvc_block_nwc_tc_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      map_k, static_cast<const bf16*>(x), static_cast<const bf16*>(skip),
      static_cast<const bf16*>(wstack), static_cast<bf16*>(out), L, F, hop,
      tile);
  return static_cast<int>(cudaGetLastError());
}
