// K3 (Kernel A) and K7: the LVC kernel-predictor head GEMM, emitted in the
// operand layout of the LVC block that reads it. One GEMM, two layouts: the
// output is row-major (M, N) for both, and the packed weights' column order
// makes it K1's kern_taug (2C, rows_p)-minor (K3, taug_head_launch) or K6's
// kern_aug (3C+1, 2C)-minor with no row padding (K7, aug_head_launch).
// K10 (taug_head_variant_launch) is the same kernel on another walk of its
// output units: the twin of an experiment script that varies the grid
// order and the M tile.
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
//   units (ops/lvc_head.py:head_gemm_plan computes the walk; the runs
//   differ by at most one unit: 11 or 12 at 864 frames). K3 and K7 walk
//   N-major: every M tile of an N tile, then the next N tile. A block
//   reloads its w_head tile (K x 128) and that tile's 128 f32 biases only
//   when its N tile changes, and requests the next tile a whole tile of
//   units early, so the stores of every SM run back to back for the whole
//   call instead of in 5.5 waves of short blocks. The walk is a launch
//   parameter (`stripe`, M tiles per stripe: stripes of M tiles in order,
//   each walked N tile by N tile; stripe = m_tiles is the N-major walk),
//   which K10 varies (ops/lvc_head.py:head_gemm_walk_plan).
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

#include "tma.cuh"

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

// A position on the walk of the output units. The M tiles go in stripes of
// `stripe` (the last one may be shorter), stripe after stripe; a stripe is
// walked N tile by N tile, all its `rows` M tiles under each. Unit (M tile
// k * stripe + mi, N tile nt). stripe = m_tiles is the N-major walk (unit
// u at nt = u / m_tiles, mt = u % m_tiles). Divides only at `start`: next()
// is a few adds, so the walk costs the loop nothing per unit.
struct Walk {
  int k, mi, nt, rows;
  __device__ __forceinline__ void start(int u, int m_tiles, int n_tiles,
                                        int stripe) {
    const int per = stripe * n_tiles;
    k = u / per;
    rows = min(stripe, m_tiles - k * stripe);
    const int r = u - k * per;
    nt = r / rows;
    mi = r - nt * rows;
  }
  __device__ __forceinline__ void next(int m_tiles, int n_tiles,
                                       int stripe) {
    if (++mi < rows) return;
    mi = 0;
    if (++nt < n_tiles) return;
    nt = 0;
    ++k;
    rows = min(stripe, m_tiles - k * stripe);
  }
};

template <int KC>
__global__ void __launch_bounds__(HEAD_THREADS, 1)
head_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out,
                 const float* __restrict__ bias, int M, int N, int stages,
                 int m_tiles, int units, int stripe) {
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

  // this block's run of units (head_gemm_plan's ranges); the i-th w_head
  // tile along it (i counts the changes of N tile) lives in slot i & 1
  const int q = units / gridDim.x, r = units % gridDim.x;
  const int bid = blockIdx.x;
  const int u_begin = bid * q + min(bid, r);
  const int u_end = u_begin + q + (bid < r ? 1 : 0);
  const int n_tiles = (N + HN - 1) / HN;

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
    // w_head tile i (K x 128, N tile nt) and its 128 biases into slot
    // i & 1. Tile i + 1 is requested as soon as tile i's first unit has its
    // tap chunks in flight (its slot frees when the consumers finish tile
    // i - 1), so it lands a whole tile of units before it is needed.
    auto load_b = [&](int i, int nt) {
      const int slot = i & 1;
      const int n0 = nt * HN;
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
    Walk w;
    w.start(u_begin, m_tiles, n_tiles, stripe);
    load_b(0, w.nt);
    for (int u = u_begin, c = 0, i = 0; u < u_end;
         ++u, w.next(m_tiles, n_tiles, stripe)) {
      const int mt = w.k * stripe + w.mi;
      const bool first = u == u_begin || w.mi == 0;  // of a w_head tile
      if (u > u_begin && first) ++i;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc, ++c) {
        const int s = c % stages;
        mbar_wait(empty_a + 8 * s, ((c / stages) & 1) ^ 1);
        mbar_expect_tx(full_a + 8 * s, A_CHUNK);
        tma_load(a_ring + s * A_CHUNK, &map_a, full_a + 8 * s, kc * HK,
                 mt * HM);
      }
      // the run's next w_head tile, if the run goes past this one's units
      if (first && u + w.rows - w.mi < u_end)
        load_b(i + 1, w.nt + 1 < n_tiles ? w.nt + 1 : 0);
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
  Walk w;
  w.start(u_begin, m_tiles, n_tiles, stripe);
  for (int u = u_begin, i = -1; u < u_end;
       ++u, w.next(m_tiles, n_tiles, stripe)) {
    const int t = u - u_begin;
    const int mt = w.k * stripe + w.mi, nt = w.nt;
    if (u == u_begin || w.mi == 0) {  // the first unit of a w_head tile
      ++i;
      mbar_wait(full_b + 8 * (i & 1), (i >> 1) & 1);
    }
    const int slot = i & 1;
    // the tile's last unit here: its w_head and bias slot frees after it
    const bool last_of_tile = u + 1 == u_end || w.mi + 1 == w.rows;
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
      if (last_of_tile) mbar_arrive(empty_b + 8 * slot);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

bool g_smem_set[64] = {};
std::mutex g_mutex;

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

// The checks and the launch of every entry: tap (M, K) bf16, w_head (K, N)
// bf16, b_head (N,) f32 -> out (M, N) bf16 on the walk of `stripe` M tiles
// per stripe. K and N must be multiples of 8, K at most 256, and every
// pointer 16-byte aligned (the Python wrapper checks all three). tile_m,
// tile_n, stages, units, grid, smem and stripe are ops/lvc_head.py's plan;
// a plan that differs from this kernel's geometry (or a stripe outside
// 1..m_tiles) returns cudaErrorInvalidValue. Launches on `stream`; returns
// cudaGetLastError().
int head_gemm_launch(const void* tap, const void* w_head, const void* b_head,
                     void* out, int M, int N, int K, int tile_m, int tile_n,
                     int stages, int units, int grid, int smem, int stripe,
                     void* stream) {
  if (M < 1 || K < 8 || K % 8 != 0 || N < 8 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k_chunks = (K + HK - 1) / HK;
  const int m_tiles = (M + HM - 1) / HM;
  const int n_tiles = (N + HN - 1) / HN;
  const int want_stages = head_stages(k_chunks);
  if (want_stages == 0 || tile_m != HM || tile_n != HN ||
      stages != want_stages || units != m_tiles * n_tiles || grid < 1 ||
      grid > units || stripe < 1 || stripe > m_tiles ||
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
          map_a, map_b, map_out, bias, M, N, stages, m_tiles, units, stripe);
      break;
    case 2:
      head_gemm_kernel<2><<<grid, HEAD_THREADS, smem, s>>>(
          map_a, map_b, map_out, bias, M, N, stages, m_tiles, units, stripe);
      break;
    case 3:
      head_gemm_kernel<3><<<grid, HEAD_THREADS, smem, s>>>(
          map_a, map_b, map_out, bias, M, N, stages, m_tiles, units, stripe);
      break;
    default:
      head_gemm_kernel<4><<<grid, HEAD_THREADS, smem, s>>>(
          map_a, map_b, map_out, bias, M, N, stages, m_tiles, units, stripe);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: tap (M, K) @ w_head (K, N) + b_head (N,) -> out (M, N) bf16 on the
// N-major walk of ops/lvc_head.py:head_gemm_plan (tile_m, tile_n, stages,
// units, grid, smem); as head_gemm_launch above.
extern "C" int taug_head_launch(const void* tap, const void* w_head,
                                const void* b_head, void* out, int M, int N,
                                int K, int tile_m, int tile_n, int stages,
                                int units, int grid, int smem, void* stream) {
  return head_gemm_launch(tap, w_head, b_head, out, M, N, K, tile_m, tile_n,
                          stages, units, grid, smem, (M + HM - 1) / HM,
                          stream);
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

// K10: the same GEMM on the walk of ops/lvc_head.py:head_gemm_walk_plan,
// the counterpart of scripts/exp_r4b.py:_taug_head_variant (experiment B:
// the head's grid order, m-outer or weight-resident, and its M tile). The
// plan's `stripe` (M tiles per stripe) is the 15th argument; "w_res" and an
// M tile of all rows are the N-major walk of K3, "m_outer" stripes of
// ceil(m_tile / 128) M tiles. As head_gemm_launch above.
extern "C" int taug_head_variant_launch(const void* tap, const void* w_head,
                                        const void* b_head, void* out, int M,
                                        int N, int K, int tile_m, int tile_n,
                                        int stages, int units, int grid,
                                        int smem, int stripe, void* stream) {
  return head_gemm_launch(tap, w_head, b_head, out, M, N, K, tile_m, tile_n,
                          stages, units, grid, smem, stripe, stream);
}

extern "C" const char* fastdiff_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
