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
// 2 x 97 x 64 per row (2.7 GFLOP, ~3 us of bf16 tensor-core time) against
// 82 MB (tap, kern, out): 0.0245 ms at 3.35 TB/s. Both are memory-bound.
//
// conv_stage (simple first, on the f32 CUDA cores): one thread per row. A
// block stages its weights in shared memory as f32 once and its tap rows in
// steps of 256 rows (coalesced 2-byte loads); tile_s is the rows one block
// covers (its weights are staged once per tile).
//
// lvc_stage on the tensor cores, samples as M, the 64 outputs as N, the 97
// taps as K: per frame Z_f (hop x 64) = T_f (hop x 97) . K_f (97 x 64).
// - A persistent grid, one block per SM (190,752 bytes of shared memory):
//   8 consumer warps and one producer warp. The work is cut into pieces of
//   at most 256 rows of one frame (one piece per frame at hop 256); the
//   frames go to the blocks in units of `tf` frames, unit u to block
//   u % grid, so tf sets the grain of the walk (1: 864 units over 132 SMs,
//   6 or 7 frames each; 8: 108 units, so 24 SMs idle). Every tf gives the
//   same output: a piece's sums do not depend on which block runs it.
// - Stream, don't stall: a ring of two stages, each one piece's tap span and
//   its frame's kernels. The producer's single thread fills a stage while
//   the consumers run the other: the tap span (194-byte rows, 16-byte
//   aligned only every 8 rows, so no tensor map can describe it) by one
//   bulk copy (cp.async.bulk) of the 16-byte-aligned span that covers the
//   piece, and K_f (97 rows of 128 bytes) by one TMA load with the 128-byte
//   swizzle, both counted on the stage's mbarrier.
// - K_f is the B operand as it lies, N-contiguous: ldmatrix.trans reads its
//   fragments for mma.sync.m16n8k16 straight from the swizzled stage,
//   conflict-free. Rows 97..111 of each kern stage are zeroed once and never
//   written, so K = 97 runs as 7 k16 steps (zero A columns 97..111 times zero
//   B rows) instead of 6 plus a rank-1 update of row 96: one code path, and
//   the 14 % more mma work is nothing beside the bytes. mma.sync and not
//   wgmma: a piece is 8 warps x 32 rows x 64 outputs, and wgmma's 64-row A
//   would have to come from the repacked rows all the same.
// - A is repacked per warp: each consumer warp shifts its 32 tap rows out
//   of the raw span (two 16-byte loads and byte permutes per 16-byte chunk,
//   skipping the span's leading bytes) into rows of 240 bytes, columns 97
//   and up zero, which ldmatrix reads conflict-free. A warp owns its rows
//   from repack to store, so it syncs with no other warp; the stage is
//   released (one arrival per warp) as soon as its mma.syncs have read it.
// - Each lane's accumulators are adjacent output channels (pairs 2t, 2t+1
//   of every n8 tile: the gate-ready layout), rounded once to bf16 pairs,
//   written by stmatrix into the warp's own staging rows (128 bytes, 16-byte
//   chunks swizzled by row) and stored as 16-byte coalesced rows of out.
// Any hop with F * hop == L runs; a frame shorter than 256 rows is a piece
// of its own, so small hops leave warps idle (hop 256 is the measured one).

#include "tma.cuh"

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
    const long long total16 = total & ~15LL;
    int i = 0;
    for_each_piece(B, L, F, hop, tf, [&](long long row0, int n, int slab) {
      const int s = i % LVC_STAGES;
      mbar_wait(empty + 8 * s, ((i / LVC_STAGES) & 1) ^ 1);
      const long long a0 = (row0 * R * 2) & ~15LL;
      long long a1 = ((row0 + n) * R * 2 + 15) & ~15LL;
      const uint32_t dst = tap_s + s * TAP_STAGE;
      if (a1 > total) {  // tap's last bytes, past its last 16-byte boundary
        for (long long at = total16; at < total; at += 2)
          *reinterpret_cast<uint16_t*>(smem + (dst - base) + (at - a0)) =
              *reinterpret_cast<const uint16_t*>(tap_b + at);
        a1 = total16;
      }
      mbar_expect_tx(full + 8 * s, static_cast<uint32_t>(a1 - a0) +
                                       KERN_BYTES);
      bulk_load(dst, tap_b + a0, static_cast<uint32_t>(a1 - a0),
                full + 8 * s);
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
    // 1. repack: 16-byte chunk c of row r is bytes off0 + 194 r + 16 c of
    // the raw span, two aligned chunks shifted by an even byte count
    const uint32_t raw = tap_s + s * TAP_STAGE;
    const int off0 = static_cast<int>((row0 * R * 2) & 15);
#pragma unroll 2
    for (int it = 0; it < 14; ++it) {
      const int q = lane + 32 * it;
      const int row = q / 14, c = q - row * 14;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (c < 13) {
        const int p = off0 + (r_begin + row) * R * 2 + 16 * c;
        const uint4 lo = *reinterpret_cast<const uint4*>(
            smem + (raw - base) + (p & ~15));
        const uint4 hi = *reinterpret_cast<const uint4*>(
            smem + (raw - base) + (p & ~15) + 16);
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
      *reinterpret_cast<uint4*>(smem + (abuf - base) + row * AROW * 2 +
                                c * 16) = make_uint4(w[0], w[1], w[2], w[3]);
    }
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
