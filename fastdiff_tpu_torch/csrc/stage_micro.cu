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
// (5.5 GFLOP at E = 221,184: ~6 us at the bf16 peak, ~9 us at the ~600
// TFLOP/s that mma.sync reaches) against 194 +
// 64 bytes per row (57 MB: tap in, out): 0.0170 ms at 3.35 TB/s; lvc_stage
// is 2 x 97 x 64 per row (2.7 GFLOP, ~3 us) against 82 MB (tap, kern, out):
// 0.0245 ms. Both are memory-bound.
//
// Both run on the tensor cores, on one persistent walk:
// - A persistent grid, one block per SM: 8 consumer warps and one producer
//   warp. The work is cut into pieces of at most 256 rows; the units of the
//   walk go to the blocks round robin, unit u to block u % grid, so the
//   unit sets the grain of the walk and nothing else: a piece's sums do not
//   depend on which block runs it. lvc_stage's unit is `tf` frames, each
//   frame its own pieces (one piece per frame at hop 256; tf 1: 864 units
//   over 132 SMs, 6 or 7 frames each; 8: 108 units, so 24 SMs idle).
//   conv_stage has no frames: tap is one (B * E, 97) matrix whose rows are
//   independent, the unit is `tile_s` consecutive rows, and a piece may
//   cross a batch item.
// - Stream, don't stall: a ring of two stages, each one piece's tap span
//   (and for lvc_stage its frame's kernels). The producer's single thread
//   fills a stage while the consumers run the other: the tap span (194-byte
//   rows, 16-byte aligned only every 8 rows, so no tensor map can describe
//   it) by one bulk copy (cp.async.bulk) of the 16-byte-aligned span that
//   covers the piece (load_tap_span), and K_f (97 rows of 128 bytes) by one
//   TMA load with the 128-byte swizzle, both counted on the stage's
//   mbarrier.
// - A is repacked per warp (repack_rows): each consumer warp shifts its 32
//   tap rows out of the raw span (two 16-byte loads and byte permutes per
//   16-byte chunk, skipping the span's leading bytes) into rows of 240
//   bytes, columns 97 and up zero, which ldmatrix reads conflict-free. A
//   warp owns its rows from repack to store, so it syncs with no other warp.
// - K = 97 runs as 7 k16 steps of mma.sync.m16n8k16 (zero A columns 97..111
//   times zero B rows 97..111) instead of 6 plus a rank-1 update of row 96:
//   one code path, and the 14 % more mma work is nothing beside the bytes.
//   mma.sync and not wgmma: a piece is 8 warps x 32 rows, and wgmma's
//   64-row A would have to come from the repacked rows all the same.
// - Each lane's accumulators are adjacent output channels (pairs 2t, 2t+1
//   of every n8 tile), rounded once to bf16 pairs, written by stmatrix into
//   the warp's own staging rows (chunks swizzled by row) and stored as
//   16-byte coalesced rows of out, masked past the piece's last row.
//
// lvc_stage: samples as M, the 64 outputs as N, the 97 taps as K: per frame
// Z_f (hop x 64) = T_f (hop x 97) . K_f (97 x 64). K_f is the B operand as
// it lies, N-contiguous: ldmatrix.trans reads its fragments straight from
// the swizzled stage, conflict-free; rows 97..111 of each kern stage are
// zeroed once and never written. The stage is released (one arrival per
// warp) as soon as its mma.syncs have read it. Any hop with F * hop == L
// runs; a frame shorter than 256 rows is a piece of its own, so small hops
// leave warps idle (hop 256 is the measured one).
//
// conv_stage: four dependent layers, chained in registers.
// - The weights are staged once per block: layer 0 as 112 rows (97..111
//   zero) and layers 1-3's rows 0..95 as bf16 rows of 80 bytes (the
//   padding makes ldmatrix.trans conflict-free), each layer's row 96 (the
//   `1` column's weights) as f32. The tap stage is read by the repack alone,
//   so it is released as soon as the repack is done, before any mma.sync:
//   two stages keep a piece's copy in flight through the whole chain (three
//   would not fit beside the weights: 243,248 bytes).
// - Layer 0: each warp's 32 rows as 2 m16 x 4 n8 accumulator tiles (32 f32
//   per lane), A by ldmatrix from the repacked rows.
// - A lane of an accumulator tile holds rows g and g+8 at columns 2t, 2t+1
//   of each n8 tile: the A-fragment layout of a k16 step spanning two
//   adjacent n8 tiles. So bf16(y) becomes the next layer's A by packing
//   accumulator pairs (the plain version's rounding between layers, once
//   per value): no shared memory, no ldmatrix.
// - Layers 1-3: 6 k16 steps reusing the same two A fragments against W_i's
//   rows 0-31, 32-63 and 64-95 (three products, each summed in f32; a
//   folded W_i[0:32] + W_i[32:64] + W_i[64:96] rounded to bf16 would be
//   another function), the accumulators started at W_i[96] (1 x a bf16
//   weight is exact in f32).

#include "tma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int R = 97;            // 3 x 32 taps + 1 bias row
constexpr int CO = 32;           // conv outputs
constexpr int ZO = 64;           // LVC outputs (2C)
constexpr int NL = 4;            // chained conv layers

// ---- lvc_stage on the tensor cores --------------------------------------
// Its geometry; fastdiff_tpu_torch/scripts/bench_mosaic_micro.py passes the
// same numbers and the entry point refuses others.
constexpr int LVC_KPAD = 112;       // 97 taps padded to 7 k16 steps
constexpr int LVC_PIECE = 256;      // rows per piece (one ring stage)
constexpr int LVC_STAGES = 2;       // ring stages
constexpr int LVC_WARPS = 8;        // consumer warps, 32 rows each
constexpr int LVC_THREADS = 32 * (LVC_WARPS + 1);
constexpr int KERN_BYTES = R * ZO * 2;          // a frame's kernels (TMA)
constexpr int KERN_STAGE = LVC_KPAD * ZO * 2;   // with the zero rows 97..111
constexpr int TAP_STAGE = 49792;    // a piece's aligned tap span, and slack
constexpr int AROW = 120;           // bf16 per repacked A row (112 + 8)
constexpr int WARP_BUF = 32 * AROW * 2;
constexpr int LVC_ALIGN = 1024;     // the 128-byte swizzle's atom
constexpr int LVC_SMEM = LVC_ALIGN + LVC_STAGES * (KERN_STAGE + TAP_STAGE) +
                         LVC_WARPS * WARP_BUF + 16 * LVC_STAGES;
static_assert(TAP_STAGE >= ((14 + R * 2 * LVC_PIECE + 15) / 16) * 16 + 32,
              "a stage holds a piece's span and the repack's overread");
static_assert(KERN_STAGE % LVC_ALIGN == 0, "kern stages keep the swizzle");
static_assert(LVC_SMEM <= 232448, "a block's shared memory");

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0,
                                        uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
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

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Producer, one thread: the 16-byte-aligned span of tap (rows of R bf16,
// `total` bytes) that covers rows [row0, row0 + n), into the stage at shared
// `dst` (generic pointer `dst_p`): tap's last bytes past its last 16-byte
// boundary by 2-byte copies, the rest by one bulk copy counted on `bar`,
// which is told to expect it and `extra` bytes more.
__device__ __forceinline__ void load_tap_span(unsigned char* dst_p,
                                              uint32_t dst, const char* tap_b,
                                              long long total, long long row0,
                                              int n, uint32_t bar,
                                              uint32_t extra) {
  const long long total16 = total & ~15LL;
  const long long a0 = (row0 * R * 2) & ~15LL;
  long long a1 = ((row0 + n) * R * 2 + 15) & ~15LL;
  if (a1 > total) {  // tap's last bytes, past its last 16-byte boundary
    for (long long at = total16; at < total; at += 2)
      *reinterpret_cast<uint16_t*>(dst_p + (at - a0)) =
          *reinterpret_cast<const uint16_t*>(tap_b + at);
    a1 = total16;
  }
  mbar_expect_tx(bar, static_cast<uint32_t>(a1 - a0) + extra);
  bulk_load(dst, tap_b + a0, static_cast<uint32_t>(a1 - a0), bar);
}

// Consumer warp: rows [r_begin, r_begin + 32) of a piece's raw span `raw`
// (its first row starts off0 bytes in) repacked into rows of AROW bf16 at
// `abuf`, columns 97.. zero. 16-byte chunk c of row r is bytes off0 + 194 r
// + 16 c of the span, two aligned chunks shifted by an even byte count.
__device__ __forceinline__ void repack_rows(const unsigned char* raw,
                                            unsigned char* abuf, int off0,
                                            int r_begin, int lane) {
#pragma unroll 2
  for (int it = 0; it < 14; ++it) {
    const int q = lane + 32 * it;
    const int row = q / 14, c = q - row * 14;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (c < 13) {
      const int p = off0 + (r_begin + row) * R * 2 + 16 * c;
      const uint4 lo = *reinterpret_cast<const uint4*>(raw + (p & ~15));
      const uint4 hi = *reinterpret_cast<const uint4*>(raw + (p & ~15) + 16);
      uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const int sh = p & 15;
#pragma unroll
      for (int k = 0; k < 6; ++k) x[k] = (sh & 8) ? x[k + 2] : x[k];
#pragma unroll
      for (int k = 0; k < 5; ++k) x[k] = (sh & 4) ? x[k + 1] : x[k];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = (sh & 2) ? __byte_perm(x[k], x[k + 1], 0x5432) : x[k];
      if (c == 12) {  // tap 96 only; columns 97.. are zero
        w[0] &= 0xFFFFu;
        w[1] = w[2] = w[3] = 0u;
      }
    }
    *reinterpret_cast<uint4*>(abuf + row * AROW * 2 + c * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A block's pieces, in order: units of tf frames (unit u: frames
// [(u % upb) tf, + tf) of batch item u / upb) dealt round robin (unit
// blockIdx.x, + gridDim.x, ...), each frame cut into pieces of at most
// LVC_PIECE rows. fn(row0, n, slab): the piece's first row of tap and out
// as (B * L, .) matrices, its row count, and its frame's first row of kern
// as a (B * F * 97, 64) matrix.
template <typename Fn>
__device__ __forceinline__ void for_each_piece(int B, int L, int F, int hop,
                                               int tf, Fn&& fn) {
  const int upb = (F + tf - 1) / tf;
  for (int u = blockIdx.x; u < B * upb; u += gridDim.x) {
    const int b = u / upb;
    const int f0 = (u - b * upb) * tf;
    const int f1 = min(F, f0 + tf);
    for (int f = f0; f < f1; ++f)
      for (int s0 = 0; s0 < hop; s0 += LVC_PIECE)
        fn((long long)b * L + (long long)f * hop + s0,
           min(LVC_PIECE, hop - s0), (b * F + f) * R);
  }
}

__global__ void __launch_bounds__(LVC_THREADS, 1)
lvc_stage_kernel(const __grid_constant__ CUtensorMap map_k,
                 const bf16* __restrict__ tap, bf16* __restrict__ out, int B,
                 int L, int F, int hop, int tf) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + LVC_ALIGN - 1) & ~uint32_t(LVC_ALIGN - 1);
  unsigned char* smem = smem_raw + (base - raw_base);
  const uint32_t kern_s = base;  // [STAGES][KPAD][64], 128-byte swizzle
  const uint32_t tap_s = kern_s + LVC_STAGES * KERN_STAGE;  // raw spans
  const uint32_t wbuf = tap_s + LVC_STAGES * TAP_STAGE;     // per warp
  const uint32_t full = wbuf + LVC_WARPS * WARP_BUF;
  const uint32_t empty = full + 8 * LVC_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < LVC_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, LVC_WARPS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // rows 97..111 of each kern stage: zero, and never written by the TMA
  constexpr int ZERO_CHUNKS = (LVC_KPAD - R) * ZO * 2 / 16;
  for (int q = tid; q < LVC_STAGES * ZERO_CHUNKS; q += LVC_THREADS)
    *reinterpret_cast<uint4*>(smem + (q / ZERO_CHUNKS) * KERN_STAGE +
                              KERN_BYTES + (q % ZERO_CHUNKS) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  if (warp == LVC_WARPS) {
    // ---- producer: one thread issues every copy ---------------------------
    if (lane != 0) return;
    const char* tap_b = reinterpret_cast<const char*>(tap);
    const long long total = (long long)B * L * R * 2;  // tap's bytes
    int i = 0;
    for_each_piece(B, L, F, hop, tf, [&](long long row0, int n, int slab) {
      const int s = i % LVC_STAGES;
      mbar_wait(empty + 8 * s, ((i / LVC_STAGES) & 1) ^ 1);
      const uint32_t dst = tap_s + s * TAP_STAGE;
      load_tap_span(smem + (dst - base), dst, tap_b, total, row0, n,
                    full + 8 * s, KERN_BYTES);
      tma_load(kern_s + s * KERN_STAGE, &map_k, full + 8 * s, 0, slab);
      ++i;
    });
    return;
  }

  // ---- consumers: warp w owns rows [32 w, 32 w + 32) of every piece -------
  const uint32_t abuf = wbuf + warp * WARP_BUF;
  int i = 0;
  for_each_piece(B, L, F, hop, tf, [&](long long row0, int n, int) {
    const int s = i % LVC_STAGES;
    mbar_wait(full + 8 * s, (i / LVC_STAGES) & 1);
    ++i;
    const int r_begin = warp * 32;
    if (r_begin >= n) {
      if (lane == 0) mbar_arrive(empty + 8 * s);
      return;
    }
    // 1. repack: the warp's 32 tap rows into 240-byte rows
    const uint32_t raw = tap_s + s * TAP_STAGE;
    repack_rows(smem + (raw - base), smem + (abuf - base),
                static_cast<int>((row0 * R * 2) & 15), r_begin, lane);
    __syncwarp();

    // 2. Z (32 x 64) = A (32 x 112) . K_f (112 x 64): 2 m16 tiles x 8 n8
    // tiles x 7 k16 steps; B by ldmatrix.trans from the swizzled stage
    const uint32_t kb = kern_s + s * KERN_STAGE;
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < LVC_KPAD / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(a[mt], abuf + (mt * 16 + (lane & 15)) * AROW * 2 +
                           (2 * ks + (lane >> 4)) * 16);
      const int k = ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldsm_x4_trans(b, kb + k * 128 + (((2 * jp + (lane >> 4)) ^ (k & 7))
                                         << 4));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * jp], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * jp + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // the stage is read

    // 3. one rounding per value, stmatrix into the warp's rows (128 bytes,
    // chunk ^ row & 7), 16-byte coalesced stores of the rows the piece has
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int q = lane >> 3;
        const int row = mt * 16 + (q & 1) * 8 + (lane & 7);
        const int chunk = 2 * jp + (q >> 1);
        const float* d0 = acc[mt][2 * jp];
        const float* d1 = acc[mt][2 * jp + 1];
        stsm_x4(abuf + row * 128 + ((chunk ^ (row & 7)) << 4),
                bf16x2(d0[0], d0[1]), bf16x2(d0[2], d0[3]),
                bf16x2(d1[0], d1[1]), bf16x2(d1[2], d1[3]));
      }
    __syncwarp();
    const int rows_here = min(32, n - r_begin);
    bf16* dst = out + (row0 + r_begin) * ZO;
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int q = lane + 32 * it;
      const int row = q >> 3, c = q & 7;
      if (row < rows_here)
        *reinterpret_cast<uint4*>(dst + row * ZO + c * 8) =
            *reinterpret_cast<const uint4*>(smem + (abuf - base) + row * 128 +
                                            ((c ^ (row & 7)) << 4));
    }
    __syncwarp();
  });
}

// ---- conv_stage on the tensor cores -------------------------------------
// Its geometry beside lvc_stage's (pieces, warps, tap stages, repacked rows);
// fastdiff_tpu_torch/scripts/bench_mosaic_micro.py passes the same numbers
// and the entry point refuses others.
constexpr int CONV_STAGES = 2;      // ring stages
constexpr int WROW = 40;            // bf16 per staged weight row (32 + 8)
constexpr int W_ROWS = LVC_KPAD + (NL - 1) * (R - 1);  // 112 + 3 x 96
constexpr int CONV_W_BYTES = W_ROWS * WROW * 2 + (NL - 1) * CO * 4;
constexpr int CONV_SMEM = CONV_W_BYTES + CONV_STAGES * TAP_STAGE +
                          LVC_WARPS * WARP_BUF + 16 * CONV_STAGES;
static_assert(CONV_W_BYTES % 16 == 0, "the tap stages stay 16-byte aligned");
static_assert(CONV_SMEM <= 232448, "a block's shared memory");
static_assert(CONV_SMEM + TAP_STAGE > 232448, "a third stage would not fit");

// A block's pieces, in order: units of tile_s rows of tap and out as
// (B * E, .) matrices (unit u: rows [u tile_s, + tile_s)) dealt round robin
// (unit blockIdx.x, + gridDim.x, ...), each cut into pieces of at most
// LVC_PIECE rows. fn(row0, n): the piece's first row and its row count.
template <typename Fn>
__device__ __forceinline__ void for_each_row_piece(long long rows,
                                                   int tile_s, Fn&& fn) {
  const long long units = (rows + tile_s - 1) / tile_s;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long end = (u + 1) * tile_s < rows ? (u + 1) * tile_s : rows;
    for (long long r0 = u * tile_s; r0 < end; r0 += LVC_PIECE)
      fn(r0, static_cast<int>(end - r0 < LVC_PIECE ? end - r0 : LVC_PIECE));
  }
}

__global__ void __launch_bounds__(LVC_THREADS, 1)
conv_stage_kernel(const bf16* __restrict__ tap, const bf16* __restrict__ w,
                  bf16* __restrict__ out, long long rows, int tile_s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  // [W_ROWS][WROW] bf16: layer 0's rows 0..111, then layers 1-3's 0..95
  const uint32_t w_s = base;
  float* w_one = reinterpret_cast<float*>(smem + W_ROWS * WROW * 2);  // [3][CO]
  const uint32_t tap_s = base + CONV_W_BYTES;                // raw spans
  const uint32_t wbuf = tap_s + CONV_STAGES * TAP_STAGE;     // per warp
  const uint32_t full = wbuf + LVC_WARPS * WARP_BUF;
  const uint32_t empty = full + 8 * CONV_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < CONV_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, LVC_WARPS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the weights, once per block, in 16-byte chunks (rows of w are 64 bytes)
  for (int q = tid; q < NL * R * 4; q += LVC_THREADS) {
    const int i = q / (R * 4), r = (q >> 2) % R, c = q & 3;
    const uint4 v =
        *reinterpret_cast<const uint4*>(w + (i * R + r) * CO + c * 8);
    if (i > 0 && r == R - 1) {  // the `1` column's weights, as f32
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
      float* dst = w_one + (i - 1) * CO + c * 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dst[2 * j] = __uint_as_float(u[j] << 16);
        dst[2 * j + 1] = __uint_as_float(u[j] & 0xFFFF0000u);
      }
    } else {
      const int row = i == 0 ? r : LVC_KPAD + (i - 1) * (R - 1) + r;
      *reinterpret_cast<uint4*>(smem + row * WROW * 2 + c * 16) = v;
    }
  }
  for (int q = tid; q < (LVC_KPAD - R) * 4; q += LVC_THREADS)  // rows 97..111
    *reinterpret_cast<uint4*>(smem + (R + (q >> 2)) * WROW * 2 +
                              (q & 3) * 16) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  if (warp == LVC_WARPS) {
    // ---- producer: one thread issues every copy ---------------------------
    if (lane != 0) return;
    const char* tap_b = reinterpret_cast<const char*>(tap);
    int i = 0;
    for_each_row_piece(rows, tile_s, [&](long long row0, int n) {
      const int s = i % CONV_STAGES;
      mbar_wait_or_trap(empty + 8 * s, ((i / CONV_STAGES) & 1) ^ 1);
      const uint32_t dst = tap_s + s * TAP_STAGE;
      load_tap_span(smem + (dst - base), dst, tap_b, rows * R * 2, row0, n,
                    full + 8 * s, 0u);
      ++i;
    });
    return;
  }

  // ---- consumers: warp w owns rows [32 w, 32 w + 32) of every piece -------
  const uint32_t abuf = wbuf + warp * WARP_BUF;
  const int t2 = 2 * (lane & 3);  // a lane's first column in each n8 tile
  int i = 0;
  for_each_row_piece(rows, tile_s, [&](long long row0, int n) {
    const int s = i % CONV_STAGES;
    mbar_wait_or_trap(full + 8 * s, (i / CONV_STAGES) & 1);
    ++i;
    const int r_begin = warp * 32;
    if (r_begin >= n) {
      if (lane == 0) mbar_arrive(empty + 8 * s);
      return;
    }
    // the repack is the stage's only reader: released before any mma.sync
    const uint32_t span = tap_s + s * TAP_STAGE;
    repack_rows(smem + (span - base), smem + (abuf - base),
                static_cast<int>((row0 * R * 2) & 15), r_begin, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);

    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
    // layer 0: Y (32 x 32) = A (32 x 112) . W_0 (112 x 32): 2 m16 x 4 n8
    // tiles x 7 k16 steps, A by ldmatrix, B by ldmatrix.trans
#pragma unroll
    for (int kt = 0; kt < LVC_KPAD / 16; ++kt) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(a[mt], abuf + (mt * 16 + (lane & 15)) * AROW * 2 +
                           (2 * kt + (lane >> 4)) * 16);
      const int k = kt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t b[4];
        ldsm_x4_trans(b, w_s + k * WROW * 2 + (2 * jp + (lane >> 4)) * 16);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * jp], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * jp + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // layers 1-3: x = [bf16(y), bf16(y), bf16(y), 1], in registers
#pragma unroll
    for (int layer = 1; layer < NL; ++layer) {
      uint32_t a[2][2][4];  // [m16 tile][k16 step of y]: bf16(y) as A
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* lo = acc[mt][2 * kk];
          const float* hi = acc[mt][2 * kk + 1];
          a[mt][kk][0] = bf16x2(lo[0], lo[1]);
          a[mt][kk][1] = bf16x2(lo[2], lo[3]);
          a[mt][kk][2] = bf16x2(hi[0], hi[1]);
          a[mt][kk][3] = bf16x2(hi[2], hi[3]);
        }
      const float* one = w_one + (layer - 1) * CO;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(one + 8 * j + t2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          acc[mt][j][0] = acc[mt][j][2] = v.x;
          acc[mt][j][1] = acc[mt][j][3] = v.y;
        }
      }
      const uint32_t wl = w_s + (LVC_KPAD + (layer - 1) * (R - 1)) * WROW * 2;
#pragma unroll
      for (int kt = 0; kt < 6; ++kt) {  // rows 16 kt.. of W_i: copy kt / 2
        const int k = kt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          ldsm_x4_trans(b, wl + k * WROW * 2 + (2 * jp + (lane >> 4)) * 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * jp], a[mt][kt & 1], b[0], b[1]);
            mma_bf16(acc[mt][2 * jp + 1], a[mt][kt & 1], b[2], b[3]);
          }
        }
      }
    }

    // one rounding per value, stmatrix into the warp's rows (64 bytes, the
    // A rows are read: chunk ^ (row / 2) & 3), 16-byte coalesced stores
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int q = lane >> 3;
        const int row = mt * 16 + (q & 1) * 8 + (lane & 7);
        const int chunk = 2 * jp + (q >> 1);
        const float* d0 = acc[mt][2 * jp];
        const float* d1 = acc[mt][2 * jp + 1];
        stsm_x4(abuf + row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4),
                bf16x2(d0[0], d0[1]), bf16x2(d0[2], d0[3]),
                bf16x2(d1[0], d1[1]), bf16x2(d1[2], d1[3]));
      }
    __syncwarp();
    const int mine = min(32, n - r_begin);
    bf16* dst = out + (row0 + r_begin) * CO;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int q = lane + 32 * it;
      const int row = q >> 2, c = q & 3;
      if (row < mine)
        *reinterpret_cast<uint4*>(dst + row * CO + c * 8) =
            *reinterpret_cast<const uint4*>(smem + (abuf - base) + row * 64 +
                                            ((c ^ ((row >> 1) & 3)) << 4));
    }
    __syncwarp();
  });
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

}  // namespace

// tap (B, E, 97) bf16, w (4, 97, 32) bf16 -> out (B, E, 32) bf16, the
// pointers 16-byte aligned; tile_s rows per unit of the walk (>= 1), grid
// persistent blocks (at most the units, ceil(B * E / tile_s)). stages and
// smem are the kernel's geometry as the Python wrapper computes it
// (CONV_STAGES, CONV_SMEM); any other value returns cudaErrorInvalidValue.
// Launches on `stream`; returns cudaGetLastError() (or the attribute call's
// error).
extern "C" int conv_stage_launch(const void* tap, const void* w, void* out,
                                 int B, int E, int rows, int tile_s,
                                 int stages, int smem, int grid,
                                 void* stream) {
  const long long n = (long long)B * E;
  if (rows != R || tile_s < 1 || B < 1 || E < 1 || stages != CONV_STAGES ||
      smem != CONV_SMEM || grid < 1 ||
      (long long)grid > (n + tile_s - 1) / tile_s ||
      n > 0x7fffffffLL / (R * 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = set_smem(reinterpret_cast<const void*>(conv_stage_kernel),
                           smem);
  if (err) return err;
  conv_stage_kernel<<<grid, LVC_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(tap), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), n, tile_s);
  return static_cast<int>(cudaGetLastError());
}

// tap (B, L, 97) bf16, kern (B, F, 97, 64) bf16 -> z (B, L, 64) bf16 with
// L == F * hop, the pointers 16-byte aligned; tf frames per unit of the
// walk (>= 1), grid persistent blocks (at most the units, B * ceil(F / tf)).
// k_pad, stages and smem are the kernel's geometry as the Python wrapper
// computes it (LVC_KPAD, LVC_STAGES, LVC_SMEM); any other value returns
// cudaErrorInvalidValue. Launches on `stream`; returns cudaGetLastError()
// (or the tensor map's or the attribute call's error).
extern "C" int lvc_stage_launch(const void* tap, const void* kern, void* out,
                                int B, int L, int F, int hop, int rows,
                                int tf, int k_pad, int stages, int smem,
                                int grid, void* stream) {
  if (rows != R || tf < 1 || B < 1 || F < 1 || hop < 1 ||
      (long long)F * hop != L || k_pad != LVC_KPAD || stages != LVC_STAGES ||
      smem != LVC_SMEM || grid < 1 ||
      (long long)grid > (long long)B * ((F + tf - 1) / tf) ||
      (long long)B * F * R > 0x7fffffffLL ||
      (long long)B * L > 0x7fffffffLL / (R * 2))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_k;
  int err = tensor_map(&map_k, kern, ZO, (uint64_t)B * F * R, ZO, R);
  if (!err)
    err = set_smem(reinterpret_cast<const void*>(lvc_stage_kernel), smem);
  if (err) return err;
  lvc_stage_kernel<<<grid, LVC_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      map_k, static_cast<const bf16*>(tap), static_cast<bf16*>(out), B, L, F,
      hop, tf < F ? tf : F);  // a unit of more than F frames is all of them
  return static_cast<int>(cudaGetLastError());
}
