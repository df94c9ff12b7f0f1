// K3 (Kernel A) and K7: the LVC kernel-predictor head GEMM, emitted in the
// operand layout of the LVC block that reads it. One GEMM, two layouts: the
// output is row-major (M, N) for both, and the packed weights' column order
// makes it K1's kern_taug (2C, rows_p)-minor (K3, taug_head_launch) or K6's
// kern_aug (3C+1, 2C)-minor with no row padding (K7, aug_head_launch).
// K10 (taug_head_variant_launch, at the end of this file) is the first
// version of this GEMM (WMMA tiles) with its grid order and M tile as launch
// parameters, the twin of an experiment script.
//
// Replaces fastdiff_tpu/ops/lvc_block_pallas.py:taug_head_matmul_5d (body
// _head_mm5d_body; K3) and aug_head_matmul (body _head_mm_body; K7). It
// computes
//
//   out[m, n] = bf16( sum_k tap[m, k] * w_head[k, n] + b_head[n] )
//
// with tap (M, K) bf16 and w_head (K, N) bf16 row-major, b_head (N,) f32:
// f32 accumulation, f32 bias, one rounding. N = layers * 2C * rows_p (K3),
// so out read as (B, F, layers, 2C, rows_p) is Kernel B's kern_taug with no
// copy; N = layers * (3C+1) * 2C for K7.
//
// What bounds it on an H100: at 10 s of audio (M = 864 frames, K = 192,
// N = 26,624 for K3, 24,832 for K7) one call is 8.8 GFLOP (8.9 us at
// 989 TFLOP/s bf16) against 56.5 MB (K3) / 52.7 MB (K7) of HBM traffic, 81 %
// of it the output: 16.9 / 15.8 us at 3.35 TB/s. The output write bounds it.
//
// Design, each choice against that bound:
// - Persistent blocks, one per SM (231,680 bytes of shared memory at
//   K = 192), each walking a contiguous, balanced run of 128 x 128 output
//   units in N-major order (ops/lvc_head.py:head_gemm_plan computes the
//   walk; the runs differ by at most one unit: 11 or 12 at 864 frames). A
//   block reloads its w_head tile (K x 128) and that tile's 128 f32 biases
//   only when its N tile changes, and requests the next tile a whole tile
//   of units early, so the stores of every SM run back to back for the
//   whole call instead of in 5.5 waves of short blocks.
// - One producer warp issues TMA loads (cp.async.bulk.tensor, 128-byte
//   swizzle) into a ring of tap chunks (128 rows x 64 k, 16 KB, 4 stages at
//   K = 192) and two w_head + bias slots, signalled by mbarriers; no thread
//   spends registers or __syncthreads on loads.
// - Two consumer warpgroups run wgmma.mma_async m64n128k16 (bf16 in, f32
//   accumulators, 64 rows each) straight from shared memory: tap K-major,
//   w_head as it lies, N-contiguous ("MN-major", the transpose bit of B),
//   so the training path's per-step repack of w_head needs no transposed
//   copy. K = 192 is 3 chunks of 4 k16 steps, unrolled (KC is a template
//   parameter); a tap chunk is released as soon as the wgmmas that read it
//   retire.
// - Epilogue: the f32 bias is read from shared memory (a load from global
//   memory here shows its latency after every drain), added in registers,
//   each value rounded once to bf16 and written to a 128-byte-swizzled bf16
//   staging tile (no f32 shared tile), then stored by TMA
//   (cp.async.bulk.tensor global <- shared) from two staging buffers per
//   warpgroup: the store of unit i is in flight while unit i+1 loads and
//   computes. The ragged M edge (864 = 6 * 128 + 96, 100, 2,000) is
//   zero-filled by the TMA loads and clipped by the TMA stores, with no
//   per-element branch.
// - The three tensor maps are encoded on the host with
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
//   library links no libcuda), and cached by (pointer, dims, box): a call
//   whose operands were seen before encodes nothing.
// What holds it back (root PERF.md, section 6): each unit's wgmmas and its
// epilogue run one after the other in both warpgroups, ~1.8 us per unit
// against the 1.3 us its 32 KB of output take at the card's write rate.

#include <cuda.h>  // CUtensorMap types; cuTensorMapEncodeTiled is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <mutex>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

// The head GEMM's geometry; ops/lvc_head.py:head_gemm_plan computes the
// same numbers and the entry point refuses a plan that differs.
constexpr int HM = 128;            // unit rows: 2 consumer warpgroups x 64
constexpr int HN = 128;            // unit columns: one wgmma n128
constexpr int HK = 64;             // k per chunk: one 128-byte swizzle row
constexpr int HEAD_THREADS = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int MAX_STAGES = 8;      // tap ring stages at most
constexpr int A_CHUNK = HM * HK * 2;      // one ring stage: 16 KB
constexpr int B_HALF = HK * 64 * 2;       // 64 k x 64 n of w_head: 8 KB
constexpr int B_CHUNK = 2 * B_HALF;       // 64 k x 128 n
constexpr int OUT_HALF = 64 * 64 * 2;     // 64 rows x 64 columns, bf16
constexpr int OUT_TILE = 2 * OUT_HALF;    // one warpgroup's 64 x 128 tile
constexpr int SMEM_ALIGN = 1024;          // the 128-byte swizzle's atom
constexpr int BARRIER_BYTES = 256;
constexpr int BIAS_BYTES = 2 * HN * 4;     // two slots of a tile's f32 bias
constexpr int MAX_KC = 4;                 // K at most 256
constexpr int SMEM_LIMIT = 232448;        // opt-in shared memory per block

// Dynamic shared memory of a block: the tap ring, two w_head + bias slots,
// two staging tiles per consumer warpgroup, the mbarriers and the alignment
// slack; and the most ring stages that fit (0 if K is deeper than 256).
int head_fixed_smem(int k_chunks) {
  return SMEM_ALIGN + BARRIER_BYTES + BIAS_BYTES + 2 * k_chunks * B_CHUNK +
         4 * OUT_TILE;
}

int head_stages(int k_chunks) {
  const int s = (SMEM_LIMIT - head_fixed_smem(k_chunks)) / A_CHUNK;
  return k_chunks > MAX_KC || s < 2 ? 0 : (s > MAX_STAGES ? MAX_STAGES : s);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. The loop is in
// PTX so that the compiler sees no divergent branch around the wgmmas.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// TMA: box at (c0 inner, c1 outer) of `map` -> shared `dst`, completion
// counted in bytes on `bar`; out-of-bounds elements are filled with zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// TMA: shared `src` -> box at (c0, c1) of `map`, clipped to its bounds.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 128, f32, this warpgroup's rows) (+)= A (64 x 16, K-major) @
// B (16 x 128, N-major: transpose bit set); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma (issued before, retired by wgmma.wait_group).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Non-tensor bulk copy global -> shared, counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

template <int KC>
__global__ void __launch_bounds__(HEAD_THREADS, 1)
head_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out,
                 const float* __restrict__ bias, int M, int N, int stages,
                 int m_tiles, int units) {
  extern __shared__ unsigned char smem_raw[];
  constexpr uint32_t B_SLOT = KC * B_CHUNK;
  const uint32_t a_ring =
      (smem_u32(smem_raw) + SMEM_ALIGN - 1) & ~uint32_t(SMEM_ALIGN - 1);
  const uint32_t b_slots = a_ring + stages * A_CHUNK;
  const uint32_t out_tiles = b_slots + 2 * B_SLOT;  // two per consumer wg
  const uint32_t bias_slots = out_tiles + 4 * OUT_TILE;
  // full_a[MAX_STAGES], empty_a[MAX_STAGES], full_b[2], empty_b[2]
  const uint32_t full_a = bias_slots + BIAS_BYTES;
  const uint32_t empty_a = full_a + 8 * MAX_STAGES;
  const uint32_t full_b = empty_a + 8 * MAX_STAGES;
  const uint32_t empty_b = full_b + 16;

  // this block's run of units (head_gemm_plan's ranges), over N tiles
  // nt_first..nt_last; the i-th of them lives in w_head slot i & 1
  const int q = units / gridDim.x, r = units % gridDim.x;
  const int bid = blockIdx.x;
  const int u_begin = bid * q + min(bid, r);
  const int u_end = u_begin + q + (bid < r ? 1 : 0);
  const int nt_first = u_begin / m_tiles;
  const int nt_last = (u_end - 1) / m_tiles;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty_b + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler, so the wgmma path is not divergent
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 2) {
    // ---- producer: one thread issues every load -------------------------
    if (tid != 2 * 128) return;
    // w_head tile i (K x 128) and its 128 biases into slot i & 1. Tile
    // i + 1 is requested as soon as tile i's first unit has its tap chunks
    // in flight (its slot frees when the consumers finish tile i - 1), so
    // it lands a whole tile of units before it is needed.
    auto load_b = [&](int i) {
      const int slot = i & 1;
      const int n0 = (nt_first + i) * HN;
      const uint32_t bias_bytes = 4 * min(HN, N - n0);
      mbar_wait(empty_b + 8 * slot, ((i >> 1) & 1) ^ 1);
      mbar_expect_tx(full_b + 8 * slot, B_SLOT + bias_bytes);
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        for (int h = 0; h < 2; ++h)
          tma_load(b_slots + slot * B_SLOT + kc * B_CHUNK + h * B_HALF,
                   &map_b, full_b + 8 * slot, n0 + h * 64, kc * HK);
      bulk_load(bias_slots + slot * (HN * 4), bias + n0, bias_bytes,
                full_b + 8 * slot);
    };
    load_b(0);
    for (int u = u_begin, c = 0; u < u_end; ++u) {
      const int nt = u / m_tiles, mt = u - nt * m_tiles;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc, ++c) {
        const int s = c % stages;
        mbar_wait(empty_a + 8 * s, ((c / stages) & 1) ^ 1);
        mbar_expect_tx(full_a + 8 * s, A_CHUNK);
        tma_load(a_ring + s * A_CHUNK, &map_a, full_a + 8 * s, kc * HK,
                 mt * HM);
      }
      if ((u == u_begin || mt == 0) && nt < nt_last) load_b(nt - nt_first + 1);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a unit ----
  const int lane = tid % 32;
  const bool leader = tid % 128 == 0;
  // accumulator fragment: d[4j + {0,1}] is row r0, d[4j + {2,3}] row r0 + 8,
  // both at columns 8j + cq + {0, 1}
  const int r0 = (tid % 128) / 32 * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const uint32_t my_tiles = out_tiles + wg * 2 * OUT_TILE;
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  for (int u = u_begin; u < u_end; ++u) {
    const int t = u - u_begin;
    const int nt = u / m_tiles, mt = u - nt * m_tiles;
    const int slot = (nt - nt_first) & 1;
    if (u == u_begin || mt == 0)  // the first unit of a w_head tile
      mbar_wait(full_b + 8 * slot, ((nt - nt_first) >> 1) & 1);
    const uint32_t b_base = b_slots + slot * B_SLOT;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int c = t * KC + kc, s = c % stages;
      mbar_wait(full_a + 8 * s, (c / stages) & 1);
      const uint32_t a_addr = a_ring + s * A_CHUNK + wg * (64 * HK * 2);
      const uint32_t b_addr = b_base + kc * B_CHUNK;
#pragma unroll
      for (int ks = 0; ks < HK / 16; ++ks)
        // A: +32 bytes per k16 inside the swizzled 128-byte rows, 8-row
        // groups 1,024 bytes apart. B: +16 rows of 128 bytes per k16, the
        // two 64-column halves B_HALF apart, 8-row groups 1,024 apart.
        wgmma_m64n128k16(d, wgmma_desc(a_addr + ks * 32, 16, 1024),
                         wgmma_desc(b_addr + ks * 2048, B_HALF, 1024),
                         (kc | ks) != 0);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if (kc > 0) {  // the previous chunk's wgmmas have retired
        wgmma_wait<1>();
        if (leader) mbar_arrive(empty_a + 8 * ((c - 1) % stages));
      }
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (leader) mbar_arrive(empty_a + 8 * ((t * KC + KC - 1) % stages));

    // epilogue: bias, one rounding, swizzled bf16 staging, TMA store
    const uint32_t tile = my_tiles + (t & 1) * OUT_TILE;
    const uint32_t bias_at = bias_slots + slot * (HN * 4) + cq * 4;
    if (leader)  // the store that last read this buffer (unit t - 2) is done
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    warpgroup_sync(1 + wg);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float bx, by;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                   : "=f"(bx), "=f"(by)
                   : "r"(bias_at + 32 * j));
      const uint32_t at = tile + (j / 8) * OUT_HALF +
                          ((((j % 8) ^ (r0 & 7)) << 4) | (cq * 2));
      const uint32_t lo = bf16x2(d[4 * j] + bx, d[4 * j + 1] + by);
      const uint32_t hi = bf16x2(d[4 * j + 2] + bx, d[4 * j + 3] + by);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(at + r0 * 128), "r"(lo)
                   : "memory");
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(at + (r0 + 8) * 128),
                   "r"(hi)
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    warpgroup_sync(1 + wg);
    if (leader) {
      const int row = mt * HM + wg * 64;
      if (row < M) {
        tma_store(&map_out, tile, nt * HN, row);
        tma_store(&map_out, tile + OUT_HALF, nt * HN + 64, row);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // the tile's last unit here: its w_head and bias slot is free
      if (u + 1 == u_end || (u + 1) % m_tiles == 0)
        mbar_arrive(empty_b + 8 * slot);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---- host side: tensor maps, encoded once per (pointer, dims, box) ------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

struct MapEntry {
  const void* ptr;
  uint64_t inner, outer;
  uint32_t box_inner, box_outer;
  CUtensorMap map;
};

constexpr int MAP_CACHE = 64;
std::mutex g_mutex;
MapEntry g_maps[MAP_CACHE];
int g_map_count = 0, g_map_next = 0;
EncodeTiledFn g_encode = nullptr;
bool g_smem_set[64] = {};

EncodeTiledFn encode_fn() {  // under g_mutex
  if (!g_encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      g_encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  return g_encode;
}

// A row-major bf16 (outer, inner) matrix read or written in boxes of
// (box_outer, box_inner) with the 128-byte swizzle; 0 or a cudaError_t.
int tensor_map(CUtensorMap* out, const void* ptr, uint64_t inner,
               uint64_t outer, uint32_t box_inner, uint32_t box_outer) {
  std::lock_guard<std::mutex> lock(g_mutex);
  for (int i = 0; i < g_map_count; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.ptr == ptr && e.inner == inner && e.outer == outer &&
        e.box_inner == box_inner && e.box_outer == box_outer) {
      *out = e.map;
      return 0;
    }
  }
  EncodeTiledFn encode = encode_fn();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  MapEntry e{ptr, inner, outer, box_inner, box_outer, {}};
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * sizeof(bf16)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  g_maps[g_map_next] = e;
  g_map_next = (g_map_next + 1) % MAP_CACHE;
  if (g_map_count < MAP_CACHE) ++g_map_count;
  *out = e.map;
  return 0;
}

int allow_head_smem() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(g_mutex);
  if (dev >= 0 && dev < 64 && g_smem_set[dev]) return 0;
  const void* kernels[MAX_KC] = {
      reinterpret_cast<const void*>(head_gemm_kernel<1>),
      reinterpret_cast<const void*>(head_gemm_kernel<2>),
      reinterpret_cast<const void*>(head_gemm_kernel<3>),
      reinterpret_cast<const void*>(head_gemm_kernel<4>)};
  for (const void* kernel : kernels) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dev >= 0 && dev < 64) g_smem_set[dev] = true;
  return 0;
}

}  // namespace

// tap (M, K) bf16, w_head (K, N) bf16, b_head (N,) f32 -> out (M, N) bf16.
// K and N must be multiples of 8, K at most 256, and every pointer 16-byte
// aligned (the Python wrapper checks all three). tile_m, tile_n, stages,
// units, grid and smem are ops/lvc_head.py:head_gemm_plan's; a plan that
// differs from this kernel's geometry returns cudaErrorInvalidValue.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int taug_head_launch(const void* tap, const void* w_head,
                                const void* b_head, void* out, int M, int N,
                                int K, int tile_m, int tile_n, int stages,
                                int units, int grid, int smem, void* stream) {
  if (M < 1 || K < 8 || K % 8 != 0 || N < 8 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k_chunks = (K + HK - 1) / HK;
  const int m_tiles = (M + HM - 1) / HM;
  const int n_tiles = (N + HN - 1) / HN;
  const int want_stages = head_stages(k_chunks);
  if (want_stages == 0 || tile_m != HM || tile_n != HN ||
      stages != want_stages || units != m_tiles * n_tiles || grid < 1 ||
      grid > units ||
      smem != head_fixed_smem(k_chunks) + want_stages * A_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b, map_out;
  int err = tensor_map(&map_a, tap, K, M, HK, HM);
  if (!err) err = tensor_map(&map_b, w_head, N, K, 64, HK);
  if (!err) err = tensor_map(&map_out, out, N, M, 64, 64);
  if (!err) err = allow_head_smem();
  if (err) return err;
  const float* bias = static_cast<const float*>(b_head);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k_chunks) {
    case 1:
      head_gemm_kernel<1><<<grid, HEAD_THREADS, smem, s>>>(
          map_a, map_b, map_out, bias, M, N, stages, m_tiles, units);
      break;
    case 2:
      head_gemm_kernel<2><<<grid, HEAD_THREADS, smem, s>>>(
          map_a, map_b, map_out, bias, M, N, stages, m_tiles, units);
      break;
    case 3:
      head_gemm_kernel<3><<<grid, HEAD_THREADS, smem, s>>>(
          map_a, map_b, map_out, bias, M, N, stages, m_tiles, units);
      break;
    default:
      head_gemm_kernel<4><<<grid, HEAD_THREADS, smem, s>>>(
          map_a, map_b, map_out, bias, M, N, stages, m_tiles, units);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7: the same GEMM for the NWC route's head (replaces fastdiff_tpu/ops/
// lvc_block_pallas.py:aug_head_matmul). tap (M, K) @ w_aug (K, N) + b_aug
// (N,) -> out (M, N) bf16, row-major with no row padding: N = layers *
// (3C+1) * 2C, so out read as (B, F, layers, 3C+1, 2C) is K6's kern_aug
// (24,832 columns at C = 32 against K3's 26,624). N must be a multiple of
// 16; otherwise as taug_head_launch (the Python wrapper raises first).
extern "C" int aug_head_launch(const void* tap, const void* w_aug,
                               const void* b_aug, void* out, int M, int N,
                               int K, int tile_m, int tile_n, int stages,
                               int units, int grid, int smem, void* stream) {
  if (N % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return taug_head_launch(tap, w_aug, b_aug, out, M, N, K, tile_m, tile_n,
                          stages, units, grid, smem, stream);
}

// K10: the first version of Kernel A's GEMM (WMMA tiles, one 8-warp block
// per output region) with the grid order and the M tile as parameters, the
// counterpart of scripts/exp_r4b.py:_taug_head_variant (experiment B: the
// head's grid order, m-outer or weight-resident, and its M tile). Each block
// owns an (m_tile, 128) output region: it loads its (K, 128) column block of
// w_head into shared memory once and runs over the region in 64-row steps
// (WMMA bf16 16x16x16, f32 accumulation, f32 bias, one rounding), so a
// larger m_tile reads the weights fewer times over fewer blocks. The linear
// block index walks the column blocks first (m_outer: a row stripe's blocks
// run together and share its tap rows) or the row stripes first
// (w_resident: a column block's stripes run together and share its weights
// in L2). Same row-major (M, N) output as Kernel A.
namespace {

constexpr int BN = 128;
constexpr int C_LD = BN + 4;
constexpr int THREADS = 256;    // 8 warps: 2 (rows) x 4 (cols), 32x32 each
constexpr int VBM = 64;                 // rows per step of a block

__global__ void __launch_bounds__(THREADS)
taug_head_variant_kernel(const bf16* __restrict__ tap,
                         const bf16* __restrict__ w,
                         const float* __restrict__ bias,
                         bf16* __restrict__ out, int M, int N, int K,
                         int m_tile, int w_resident) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int w_ld = BN + 8;
  const int a_ld = K + 8;
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);          // [K][w_ld]
  bf16* a_s = w_s + K * w_ld;                             // [VBM][a_ld]
  float* c_s = reinterpret_cast<float*>(a_s + VBM * a_ld);  // [VBM][C_LD]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const int n_tiles = (N + BN - 1) / BN;
  const int m_tiles = (M + m_tile - 1) / m_tile;
  const int bid = blockIdx.x;
  const int mi = w_resident ? bid % m_tiles : bid / n_tiles;
  const int ni = w_resident ? bid / m_tiles : bid % n_tiles;
  const int n0 = ni * BN;
  const int m_begin = mi * m_tile;
  const int m_end = min(M, m_begin + m_tile);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int idx = tid; idx < K * (BN / 8); idx += THREADS) {
    const int k = idx / (BN / 8);
    const int nv = (idx % (BN / 8)) * 8;
    uint4 v = zero;
    if (n0 + nv < N)
      v = *reinterpret_cast<const uint4*>(w + (size_t)k * N + n0 + nv);
    *reinterpret_cast<uint4*>(w_s + k * w_ld + nv) = v;
  }
  for (int m0 = m_begin; m0 < m_end; m0 += VBM) {
    for (int idx = tid; idx < VBM * (K / 8); idx += THREADS) {
      const int row = idx / (K / 8);
      const int kv = (idx % (K / 8)) * 8;
      uint4 v = zero;
      if (m0 + row < m_end)
        v = *reinterpret_cast<const uint4*>(tap + (size_t)(m0 + row) * K +
                                            kv);
      *reinterpret_cast<uint4*>(a_s + row * a_ld + kv) = v;
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a_s + (wm * 32 + i * 16) * a_ld + kk,
                               a_ld);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], w_s + kk * w_ld + wn * 32 + j * 16,
                               w_ld);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            c_s + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
            C_LD, wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < VBM * BN / 2; idx += THREADS) {
      const int row = idx / (BN / 2);
      const int col = (idx % (BN / 2)) * 2;
      const int m = m0 + row;
      const int n = n0 + col;
      if (m < m_end && n < N) {
        const float v0 = c_s[row * C_LD + col] + bias[n];
        const float v1 = c_s[row * C_LD + col + 1] + bias[n + 1];
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// K10: tap (M, K) bf16 @ w_head (K, N) bf16 + b_head (N,) f32 -> out (M, N)
// bf16, as taug_head_launch, with the grid order (w_resident 0: m-outer, 1:
// weight-resident) and the rows per block (m_tile, a multiple of 8) as
// parameters. K must be a multiple of 16 and at most 256, N of 8; other
// values return cudaErrorInvalidValue (the Python wrapper raises first).
extern "C" int taug_head_variant_launch(const void* tap, const void* w_head,
                                        const void* b_head, void* out, int M,
                                        int N, int K, int m_tile,
                                        int w_resident, void* stream) {
  if (K % 16 != 0 || K > 256 || N % 8 != 0 || M < 1 || m_tile < 8 ||
      m_tile % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)K * (BN + 8) * sizeof(bf16) +
                      (size_t)VBM * (K + 8) * sizeof(bf16) +
                      (size_t)VBM * C_LD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      taug_head_variant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = ((N + BN - 1) / BN) * ((M + m_tile - 1) / m_tile);
  taug_head_variant_kernel<<<blocks, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(tap), static_cast<const bf16*>(w_head),
      static_cast<const float*>(b_head), static_cast<bf16*>(out), M, N, K,
      m_tile, w_resident);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fastdiff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
