// K5 on the tensor cores: the fused-head LVC block (NCL) for every hop that
// is a multiple of 8. Kernel B's whole 4-layer block with the
// kernel-predictor head GEMM run inside the kernel, so the per-frame LVC
// kernels (kern_taug, 46 MB per block call at 864 frames) never reach
// device memory; with final_wb also Kernel B's final-conv epilogue (K5
// final). Other hops run the plain version (ops/lvc_block_ncl.py).
//
// Replaces fastdiff_tpu/ops/lvc_block_ncl.py:lvc_block_ncl_fh, both of its
// pallas_call sites (_kernel_body_fh and _kernel_body_fh_final, whose head
// is _compute_kern_slabs). For every frame f a CTA touches and layer i:
//
//   K_{i,f}[o, r] = bf16( sum_k tap_c[f, k] * w_head[k, (i, o, r)]
//                         + b_head[(i, o, r)] )        (f32 sums and bias)
//
// Kernel A's cast points (taug_head.cu), then K1's layer with K_{i,f}
// (lvc_block_ncl_tc.cu) and K2's final conv.
//
// What bounds it on an H100: the useful work of one call at 864 frames is
// the head (864 x 192 x 26,624 x 2 = 8.8 GFLOP) and the block (4.1 / 16.5
// GFLOP at hops 64 / 256), against 0.3 MB of taps, 10.2 MB of w_head and x,
// skip and out in device memory: 9-26 us at 989 TFLOP/s, the operations
// bound it. But every CTA needs all of w_head (10,223,616 bytes: 4 layers x
// 64 output rows x 104 kern rows x 192) for the frames it touches, so the
// bytes that reach the SMs from L2 are CTAs x 10.2 MB per call, and that is
// what holds the kernel back. Reckoned from ops/lvc_block_ncl.py:
// fh_tile_plan at 864 frames, b 1, on 132 SMs:
//
//   hop  tile  CTAs  waves  frames/CTA  w_head L2 -> SMs
//     8    56   124      1    19 (24)     1.27 GB
//    64   424   131      1     9 (16)     1.34 GB
//   256   424   522      4     3 (8)      5.34 GB
//
// against the 92 MB that K3 + K1 move through HBM. Reading w_head once per
// CTA and call, not once per chunk of 8 frames as the CUDA-core kernel
// did (1.56 / 2.7 / 5.4 GB per hop, plus its re-reads), is the cut; TMA
// brings it: chunks of 64 columns x 192 rows (two boxes of 96 rows x 128
// bytes, the 128-byte swizzle) into a 3-stage ring, issued by one producer
// warp and counted on mbarriers (tma.cuh's tensor-map cache encodes the
// map once per pointer). w_head's rows are 53,248 bytes apart: a multiple
// of 16, under the tensor map's 2^40 limit; its base must be 128-byte
// aligned (the wrapper and this entry check). One CTA per SM and no
// cluster: clusters of 2 that multicast each chunk (L2 serving it once per
// pair) ran 2.3x slower on the H100 at every hop (root PERF.md, section
// 7). Without a cluster the w_head bytes reach the SMs at ~4.1 TB/s at
// every hop: L2's rate sets the kernel's time.
// Frames per CTA: the tile that minimises waves x extent whose shared
// memory fits one CTA per SM (fh_tile_plan). At hop 8, b 1, 124 CTAs of 56
// outputs fill the card (the CUDA-core kernel ran 17 tiles on 17 SMs).
//
// Design (the block is lvc_block_tc.cuh's):
// - 288 threads: 8 consumer warps run every stage and sync on a named
//   barrier of 256 threads; one producer warp streams w_head (416 chunks
//   per call: 4 layers x 4 groups x 26, the same for every CTA).
// - The head on the tensor cores with w_head's columns as M and the CTA's
//   frames as N (n8 steps), so a few frames waste no 64-row M tile:
//   mma.sync.m16n8k16, A = w_head^T read by ldmatrix.trans from the
//   swizzled stage as it lies (a_frag_swz), B = the CTA's tap rows, staged
//   once ([frames][200] bf16, conflict-free ldmatrix). Warp w takes the
//   chunk's m16 tile w & 3 against n8 frame tiles w >> 2 and w >> 2 + 2
//   (at most 32 frames), K in two halves of 6 k16 steps whose A fragments
//   serve both tiles (holding all 12 spilled at the 168 registers that 288
//   threads leave); it frees the stage as soon as the second half's
//   fragments are in registers. The epilogue adds the f32 bias (read once
//   per chunk), rounds once and writes the slab.
// - Slabs by output-channel group: a layer's LVC runs in 4 groups of 8
//   output channels, and a group's slab holds, per frame, one m16 tile of
//   16 rows (sigmoid rows o .. o+7, then tanh rows o .. o+7) x 104 kern
//   rows: 3,344 bytes a frame (208-byte rows, conflict-free for ldmatrix;
//   frames 16 bytes apart in banks, so the epilogue's stores do not
//   collide). All of a CTA's frames stay resident, and w_head streams once
//   per layer. The slabs share their bytes with the conv's input `a`, dead
//   once y is made; a's pad rows are zeroed again in every layer.
// - The LVC reads its A fragments from the slab with ldmatrix; a sigmoid
//   row and its tanh row are rows g and g + 8 of one m16 tile, so the
//   gate runs on one lane's accumulators (gate_tile<1>). y stays in its own channel order
//   in ybuf (conv_tc<false>): the A fragments come from shared memory, so
//   the hop-8 permutation that K1 needs for 16-byte global loads (ypos) has
//   no use here. The bias row (kern row 96) initialises the accumulators.
// - skip_add, conv_tc, final_conv_rows and store_rows are K1's stages.
//   n8 tiles wholly outside [0, L) skip the LVC (their s is zero and is
//   masked again in the next layer; no output reads them); frames past the
//   ends are clamped to 0 / F-1.
// - Every mbarrier wait traps after ~10 s, so a fault ends the launch with
//   an error instead of hanging the card.

#include "lvc_block_tc.cuh"
#include "tma.cuh"

namespace {
namespace tc {

// The tensor-core K5's geometry; ops/lvc_block_ncl.py computes the same
// numbers (fh_tile_plan) and the entry point refuses a plan that differs.
constexpr int KH = 192;                   // head contraction
constexpr int FH_RP = 104;                // kern rows: 97 padded to 8
constexpr int FH_GROUP = 8;               // output channels per slab group
constexpr int FH_GROUPS = C / FH_GROUP;
constexpr int FH_HALF = FH_GROUP * FH_RP; // w_head columns of one half: 832
constexpr int FH_COLS = 64;               // columns per chunk
constexpr int FH_HALF_CHUNKS = FH_HALF / FH_COLS;      // 13
constexpr int FH_CHUNKS = 2 * FH_HALF_CHUNKS;          // per group: 26
constexpr int FH_TOTAL = LAYERS * FH_GROUPS * FH_CHUNKS;  // per call: 416
constexpr int FH_BOX_K = KH / 2;          // rows per TMA box
constexpr int FH_CHUNK_BYTES = KH * FH_COLS * 2;       // 24,576
constexpr int FH_STAGES = 3;
constexpr int FH_TROW = KH + 8;           // bf16 per staged tap row
constexpr int FH_FRAME = 2 * FH_GROUP * FH_RP * 2 + 16;  // 3,344 bytes
constexpr int FH_ALIGN = 1024;
constexpr int FH_BAR_BYTES = 64;
constexpr int FH_THREADS = THREADS + 32;
constexpr int FH_NPAD_MAX = 32;           // head frames: 4 n8 tiles at most
static_assert(FH_HALF % FH_COLS == 0, "a half group is whole chunks");
static_assert(2 * FH_STAGES * 8 <= FH_BAR_BYTES, "the mbarriers fit");

__host__ __device__ constexpr int fh_frames_max(int ext, int hop) {
  return (ext + hop - 2) / hop + 1;
}

// dynamic shared memory of a CTA whose extent is `ext` samples and whose
// head covers `npad` frames
__host__ __device__ constexpr int fh_smem_bytes(int ext, int npad) {
  return FH_ALIGN + FH_STAGES * FH_CHUNK_BYTES +
         (2 * ext + 2 * YPAD) * ROW * 2 +
         ((ext + 2 * APAD) * ROW * 2 > npad * FH_FRAME
              ? (ext + 2 * APAD) * ROW * 2
              : npad * FH_FRAME) +
         npad * FH_TROW * 2 + C * WROW * 2 + 9 * C * 4 + FH_BAR_BYTES;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

// w_head's first column of chunk c of the call's stream: layer, group,
// then the sigmoid half's 13 chunks and the tanh half's
__device__ __forceinline__ int chunk_col(int c, int* half) {
  const int i = c / (FH_GROUPS * FH_CHUNKS);
  const int q = (c / FH_CHUNKS) % FH_GROUPS;
  const int cc = c % FH_CHUNKS;
  *half = cc / FH_HALF_CHUNKS;
  return (i * 2 * C + *half * C + q * FH_GROUP) * FH_RP +
         (cc % FH_HALF_CHUNKS) * FH_COLS;
}

template <bool FINAL>
__global__ void __launch_bounds__(FH_THREADS, 1)
lvc_block_fh_tc_kernel(const __grid_constant__ CUtensorMap map_w,
                       const bf16* __restrict__ x,
                       const bf16* __restrict__ skip,
                       const bf16* __restrict__ tap_c,
                       const float* __restrict__ b_head,
                       const bf16* __restrict__ wstack_t,
                       const bf16* __restrict__ final_wb,
                       bf16* __restrict__ out, float* __restrict__ fin, int L,
                       int F, int hop, int tile, int npad) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + FH_ALIGN - 1) & ~uint32_t(FH_ALIGN - 1);
  unsigned char* base = smem_raw + (ring - raw);
  const int ext = tile + 2 * HALO;
  // ring, carry, ybuf (pad rows), [a (pad rows) | slab], taps, ws, wb, wf,
  // mbarriers
  unsigned char* p = base + FH_STAGES * FH_CHUNK_BYTES;
  bf16* carry = reinterpret_cast<bf16*>(p);
  bf16* ybuf = carry + (ext + YPAD) * ROW;
  unsigned char* uni = reinterpret_cast<unsigned char*>(ybuf + (ext + YPAD) *
                                                                   ROW);
  bf16* act = reinterpret_cast<bf16*>(uni) + APAD * ROW;
  const int ubytes = (ext + 2 * APAD) * ROW * 2 > npad * FH_FRAME
                         ? (ext + 2 * APAD) * ROW * 2
                         : npad * FH_FRAME;
  bf16* taps = reinterpret_cast<bf16*>(uni + ubytes);
  bf16* ws = taps + npad * FH_TROW;
  float* wb = reinterpret_cast<float*>(ws + C * WROW);
  float* wf = wb + C;
  const uint32_t full = smem_u32(wf + 8 * C);
  const uint32_t empty = full + 8 * FH_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y;
  const long g0 = (long)blockIdx.x * tile - HALO;
  const size_t brow = (size_t)b * C * L;
  if (tid == 0) {
    for (int s = 0; s < FH_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WARPS);  // every consumer warp, once per chunk
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    // ---- producer: one thread streams w_head, chunk after chunk ---------
    if (lane == 0) {
      for (int c = 0; c < FH_TOTAL; ++c) {
        const int s = c % FH_STAGES;
        mbar_wait_or_trap(empty + 8 * s, ((c / FH_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, FH_CHUNK_BYTES);
        int half;
        const int col = chunk_col(c, &half);
        for (int h = 0; h < 2; ++h)
          tma_load(ring + s * FH_CHUNK_BYTES + h * FH_BOX_K * 128, &map_w,
                   full + 8 * s, col, h * FH_BOX_K);
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  // the extent's samples in [0, L) ([lo, hi), never empty: the plan's grid
  // has no CTA past the last tile) and their frames
  const int lo = g0 < 0 ? 0 : static_cast<int>(g0);
  const int hi = g0 + ext < L ? static_cast<int>(g0 + ext) : L;
  const int f_lo = lo / hop;
  const int gq = lane >> 2, tq = lane & 3;

  zero_rows(ybuf - YPAD * ROW, YPAD, tid);
  zero_rows(ybuf + ext * ROW, YPAD, tid);
  load_rows(x + brow, carry, g0, ext, L, tid);
  // the CTA's tap rows, frames f_lo .. f_lo + npad - 1 (clamped to F - 1)
  const bf16* tb = tap_c + (size_t)b * F * KH;
  for (int idx = tid; idx < npad * (KH / 8); idx += THREADS) {
    const int n = idx / (KH / 8), k8 = idx % (KH / 8);
    const int f = min(f_lo + n, F - 1);
    reinterpret_cast<uint4*>(taps + n * FH_TROW)[k8] =
        ldg128(tb + (size_t)f * KH + 8 * k8);
  }
  if (FINAL)
    for (int idx = tid; idx < 8 * C; idx += THREADS)
      wf[idx] = to_f(final_wb[idx]);

  // the LVC's n8 tiles inside [lo, hi), cut into one contiguous run per warp
  const int j_lo = (lo - static_cast<int>(g0)) / 8;
  const int j_hi = (hi - static_cast<int>(g0)) / 8;
  const int per = (j_hi - j_lo + WARPS - 1) / WARPS;
  const int r0 = j_lo + warp * per;
  const int r1 = min(j_hi, r0 + per);
  // the head: warp w takes m16 tile w & 3 of every chunk against n8 frame
  // tiles w >> 2 and w >> 2 + 2 (npad <= FH_NPAD_MAX: at most 4 tiles)
  const int mt = warp & 3, nt0 = warp >> 2;
  const int my_nt = (npad / 8 > nt0) + (npad / 8 > nt0 + 2);

  int c = 0;  // the stream's chunk
  int d = 1;
  for (int i = 0; i < LAYERS; ++i, d *= 3) {
    consumer_sync();  // the last layer's gate is done with carry and ws
    stage_weights(wstack_t + (size_t)i * C * ROWS, ws, wb, tid);
    zero_rows(act - APAD * ROW, APAD, tid);  // the slabs overwrote them
    zero_rows(act + ext * ROW, APAD, tid);
    skip_add(skip + brow, carry, act, g0, ext, L, tid);
    consumer_sync();
    conv_tc<false>(act, ws, wb, ybuf, d, g0, ext, L, warp, lane);
    consumer_sync();  // a is read: the slabs may take its bytes

    for (int q = 0; q < FH_GROUPS; ++q) {
      // -- the head of group q: its 26 chunks -> slab[frame][16][FH_RP]
      for (int cc = 0; cc < FH_CHUNKS; ++cc, ++c) {
        const int s = c % FH_STAGES;
        const uint32_t stage = ring + s * FH_CHUNK_BYTES;
        mbar_wait_or_trap(full + 8 * s, (c / FH_STAGES) & 1);
        // K = 192 in two halves of 6 k16 steps, each half's A fragments
        // held while they serve both of the warp's n8 frame tiles
        float acc[2][2][4] = {};  // [frame tile][accumulator chain]
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          uint32_t a[6][4];
          if (my_nt > 0) {
#pragma unroll
            for (int ks = 0; ks < 6; ++ks)
              a_frag_swz(a[ks], stage, 16 * mt, 6 * kh + ks, lane);
          }
          if (kh == 1) {  // the stage is read: free it
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * s);
          }
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            if (t >= my_nt) continue;
            const bf16* trow = taps + (8 * (nt0 + 2 * t) + (lane & 7)) *
                                          FH_TROW + 96 * kh + (lane >> 3) * 8;
#pragma unroll
            for (int kp = 0; kp < 3; ++kp) {
              uint32_t bb[4];
              ldsm_x4(bb, trow + 32 * kp);
              mma_bf16(acc[t][0], a[2 * kp], bb[0], bb[1]);
              mma_bf16(acc[t][1], a[2 * kp + 1], bb[2], bb[3]);
            }
          }
        }
        if (my_nt == 0) continue;
        int half;
        const int col0 = chunk_col(c, &half);
        const int m_a = 16 * mt + gq;  // chunk columns m_a and m_a + 8
        const float bias[2] = {__ldg(b_head + col0 + m_a),
                               __ldg(b_head + col0 + m_a + 8)};
        // slab element of chunk column m: (row, kern row) of the group
        int at[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int local = (cc % FH_HALF_CHUNKS) * FH_COLS + m_a + 8 * h;
          at[h] = (local / FH_RP + FH_GROUP * half) * FH_RP + local % FH_RP;
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t >= my_nt) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int cn = 0; cn < 2; ++cn) {
              const int n = 8 * (nt0 + 2 * t) + 2 * tq + cn;  // the frame
              const int v = 2 * h + cn;
              *reinterpret_cast<bf16*>(uni + n * FH_FRAME + at[h] * 2) =
                  __float2bfloat16(acc[t][0][v] + acc[t][1][v] + bias[h]);
            }
        }
      }
      consumer_sync();  // the group's slabs are whole

      // -- the LVC and gate of output channels 8q .. 8q+7
      int cur = -1;
      uint32_t ka[1][6][4];
      float kb[1][2] = {};
      for (int j = r0; j < r1; ++j) {
        const int n0 = 8 * j;
        const int f = (static_cast<int>(g0) + n0) / hop - f_lo;
        if (f != cur) {
          cur = f;
          const bf16* sl = reinterpret_cast<const bf16*>(uni + f * FH_FRAME);
#pragma unroll
          for (int ks = 0; ks < 6; ++ks)
            ldsm_x4(ka[0][ks], sl + (lane & 15) * FH_RP + 16 * ks +
                                   (lane >> 4) * 8);
          kb[0][0] = to_f(sl[gq * FH_RP + 3 * C]);
          kb[0][1] = to_f(sl[(gq + 8) * FH_RP + 3 * C]);
        }
        gate_tile<1>(ka, kb, ybuf, carry, n0, FH_GROUP * q, lane);
      }
      consumer_sync();  // the slabs are read: the next group may write
    }
  }
  store_rows(carry, out + brow, g0, tile, L, tid);
  if (FINAL) final_conv_rows(carry, wf, fin + (size_t)b * L, g0, tile, L, tid);
}

// the plan's checks; 0 if the kernel takes it
bool fh_bad_plan(int B, int L, int F, int hop, int tile, int npad,
                 int grid_x, int smem) {
  const int ext = tile + 2 * HALO;
  return B < 1 || hop < 8 || hop % 8 != 0 || (long)F * hop != L ||
         tile < 8 || tile % 8 != 0 || tile > L + 8 ||
         npad != (fh_frames_max(ext, hop) + 7) / 8 * 8 || npad > FH_NPAD_MAX ||
         (long)grid_x * tile < L || (long)(grid_x - 1) * tile >= L ||
         smem != fh_smem_bytes(ext, npad) || smem > SMEM_LIMIT;
}

template <bool FINAL>
int launch_fh(const CUtensorMap& map, const void* x, const void* skip,
              const void* tap_c, const void* b_head, const void* wstack,
              const void* final_wb, void* out, void* fin, int B, int L, int F,
              int hop, int tile, int npad, int grid_x, int smem,
              cudaStream_t stream) {
  auto kernel = lvc_block_fh_tc_kernel<FINAL>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x, B), FH_THREADS, smem, stream>>>(
      map, static_cast<const bf16*>(x), static_cast<const bf16*>(skip),
      static_cast<const bf16*>(tap_c), static_cast<const float*>(b_head),
      static_cast<const bf16*>(wstack), static_cast<const bf16*>(final_wb),
      static_cast<bf16*>(out), static_cast<float*>(fin), L, F, hop, tile,
      npad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// x, skip (B, C, L) bf16; tap_c (B, F, khead) bf16; w_head (khead, layers *
// 2C * rows_p) bf16 (Kernel A's packing), 128-byte aligned; b_head (layers
// * 2C * rows_p,) f32; wstack_t (layers, C, 3C+1) bf16; final_wb (8, C)
// bf16 or NULL; out (B, C, L) bf16; fin (B, 1, L) f32 or NULL; tile, npad,
// grid_x and smem from ops/lvc_block_ncl.py:fh_tile_plan. Only
// C = 32, 4 layers, khead = 192, rows_p = 104 and hop % 8 == 0 are built,
// the other pointers 16-byte aligned (the Python wrapper checks). Launches
// on `stream`; returns cudaGetLastError() (or the tensor map's, an
// attribute call's or the launch's error).
extern "C" int lvc_block_ncl_fh_launch(
    const void* x, const void* skip, const void* tap_c, const void* w_head,
    const void* b_head, const void* wstack_t, const void* final_wb, void* out,
    void* fin, int B, int channels, int L, int F, int hop, int khead,
    int rows_p, int layers, int tile, int npad, int grid_x, int smem,
    void* stream) {
  using namespace tc;
  if (channels != C || layers != LAYERS || khead != KH || rows_p != FH_RP ||
      fh_bad_plan(B, L, F, hop, tile, npad, grid_x, smem) ||
      reinterpret_cast<uintptr_t>(w_head) % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int err = tensor_map(&map, w_head, (uint64_t)LAYERS * 2 * C * FH_RP,
                             KH, FH_COLS, FH_BOX_K);
  if (err) return err;
  return (final_wb != nullptr ? launch_fh<true> : launch_fh<false>)(
      map, x, skip, tap_c, b_head, wstack_t, final_wb, out, fin, B, L, F, hop,
      tile, npad, grid_x, smem, static_cast<cudaStream_t>(stream));
}
