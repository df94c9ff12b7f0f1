// Kernel A (K3) and K7: the LVC kernel-predictor head GEMM, emitted in the
// operand layout of the LVC block that reads it. One GEMM, two layouts: the
// output is row-major (M, N) for both, and the packed weights' column order
// makes it K1's kern_taug (2C, rows_p)-minor (K3, taug_head_launch) or K6's
// kern_aug (3C+1, 2C)-minor with no row padding (K7, aug_head_launch).
// K10 (taug_head_variant_launch, below) is the same GEMM with its grid order
// and M tile as launch parameters, the twin of an experiment script.
//
// Replaces fastdiff_tpu/ops/lvc_block_pallas.py:taug_head_matmul_5d (body
// _head_mm5d_body). It computes
//
//   out[m, n] = bf16( sum_k tap[m, k] * w_head[k, n] + b_head[n] )
//
// with tap (M, K) bf16, w_head (K, N) bf16, b_head (N,) f32, accumulation in
// f32. N = layers * 2C * rows_p, so out read as (B, F, layers, 2C, rows_p) is
// the kern_taug operand of Kernel B (lvc_block_ncl.cu) with no copy.
//
// What bounds it on an H100: at 10 s of audio (M = 864 frames, K = 192,
// N = 4 * 64 * 104 = 26,624) one call is 8.8 GFLOP against ~56 MB of
// traffic (46 MB of output written, 10 MB of weights read). At the card's
// published 989 TFLOP/s bf16 and 3.35 TB/s that is 9 us of math against
// 17 us of memory: the output write bounds it.
//
// Design: one thread block of 8 warps per 64 x 128 output tile. The K = 192
// contraction runs in steps of 32 through shared memory, on the tensor cores
// through the WMMA bf16 16x16x16 fragments (f32 accumulators); every output
// element is written exactly once, as bf16 pairs, after the f32 bias add.
// The 10 MB weight matrix is re-read once per 64-row stripe and stays in
// the 50 MB L2. TMA loads and wgmma are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int A_LD = BK + 8;    // padded shared-memory strides (elements)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr int THREADS = 256;    // 8 warps: 2 (rows) x 4 (cols), 32x32 each

__global__ void __launch_bounds__(THREADS)
taug_head_kernel(const bf16* __restrict__ tap, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 int M, int N, int K) {
  __shared__ __align__(128) bf16 a_s[BM * A_LD];
  __shared__ __align__(128) bf16 b_s[BK * B_LD];
  __shared__ __align__(128) float c_s[BM * C_LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // A tile: 64 rows x 4 vectors of 8 bf16
      const int row = tid / 4;
      const int kv = (tid % 4) * 8;
      const int m = m0 + row;
      const int k = k0 + kv;
      uint4 v = zero;
      if (m < M && k < K)
        v = *reinterpret_cast<const uint4*>(tap + (size_t)m * K + k);
      *reinterpret_cast<uint4*>(a_s + row * A_LD + kv) = v;
    }
#pragma unroll
    for (int rep = 0; rep < 2; ++rep) {  // B tile: 32 rows x 16 vectors
      const int idx = tid + rep * THREADS;
      const int row = idx / 16;
      const int nv = (idx % 16) * 8;
      const int k = k0 + row;
      const int n = n0 + nv;
      uint4 v = zero;
      if (k < K && n < N)
        v = *reinterpret_cast<const uint4*>(w + (size_t)k * N + n);
      *reinterpret_cast<uint4*>(b_s + row * B_LD + nv) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a_s + (wm * 32 + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b_s + kk * B_LD + wn * 32 + j * 16,
                               B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          c_s + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
          C_LD, wmma::mem_row_major);
  __syncthreads();

  // epilogue: f32 bias add, round to bf16, store pairs (N is even)
  for (int idx = tid; idx < BM * BN / 2; idx += THREADS) {
    const int row = idx / (BN / 2);
    const int col = (idx % (BN / 2)) * 2;
    const int m = m0 + row;
    const int n = n0 + col;
    if (m < M && n < N) {
      const float v0 = c_s[row * C_LD + col] + bias[n];
      const float v1 = c_s[row * C_LD + col + 1] + bias[n + 1];
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

}  // namespace

// tap (M, K) bf16, w_head (K, N) bf16, b_head (N,) f32 -> out (M, N) bf16.
// K and N must be multiples of 8 and every pointer 16-byte aligned (the
// Python wrapper checks both). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int taug_head_launch(const void* tap, const void* w_head,
                                const void* b_head, void* out, int M, int N,
                                int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  taug_head_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(tap), static_cast<const bf16*>(w_head),
      static_cast<const float*>(b_head), static_cast<bf16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// K7: the same GEMM for the NWC route's head (replaces fastdiff_tpu/ops/
// lvc_block_pallas.py:aug_head_matmul). tap (M, K) @ w_aug (K, N) + b_aug
// (N,) -> out (M, N) bf16, row-major with no row padding: N = layers *
// (3C+1) * 2C, so out read as (B, F, layers, 3C+1, 2C) is K6's kern_aug
// (24,832 columns at C = 32 against K3's 26,624). K must be a multiple of 8
// and N of 16; other shapes return cudaErrorInvalidValue (the Python wrapper
// raises first).
extern "C" int aug_head_launch(const void* tap, const void* w_aug,
                               const void* b_aug, void* out, int M, int N,
                               int K, void* stream) {
  if (K % 8 != 0 || N % 16 != 0 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return taug_head_launch(tap, w_aug, b_aug, out, M, N, K, stream);
}

// K10: Kernel A's GEMM with the grid order and the M tile as parameters, the
// counterpart of scripts/exp_r4b.py:_taug_head_variant (experiment B: the
// head's grid order, m-outer or weight-resident, and its M tile). Each block
// owns an (m_tile, 128) output region: it loads its (K, 128) column block of
// w_head into shared memory once and runs over the region in 64-row steps
// (WMMA bf16 16x16x16 as Kernel A, f32 accumulation, f32 bias, one
// rounding), so a larger m_tile reads the weights fewer times over fewer
// blocks. The linear block index walks the column blocks first (m_outer: a
// row stripe's blocks run together and share its tap rows) or the row
// stripes first (w_resident: a column block's stripes run together and
// share its weights in L2). Same row-major (M, N) output as Kernel A.
namespace {

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
