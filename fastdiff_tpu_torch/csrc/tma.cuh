// Hopper's asynchronous copies as the port's kernels use them: mbarriers,
// TMA tensor loads and stores (cp.async.bulk.tensor), non-tensor bulk
// copies (cp.async.bulk), and the host-side tensor maps they read, encoded
// with cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so
// the library links no libcuda) and cached by (pointer, dims, box).
// Included by taug_head.cu (K3, K7, K10), stage_micro.cu (K9),
// lvc_block_ncl_fh.cu (K5) and lvc_block_nwc_tc.cu (K6).

#pragma once

#include <cuda.h>  // CUtensorMap types; cuTensorMapEncodeTiled is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

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

// mbar_wait that gives up: after ~2^34 clocks (about 10 s) of waiting it
// traps, so a wait that can never complete ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
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

// Non-tensor bulk copy global -> shared, counted in bytes on `bar`; both
// addresses 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
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
std::mutex g_map_mutex;
MapEntry g_maps[MAP_CACHE];
int g_map_count = 0, g_map_next = 0;
EncodeTiledFn g_encode = nullptr;

EncodeTiledFn encode_fn() {  // under g_map_mutex
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
  std::lock_guard<std::mutex> lock(g_map_mutex);
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
  const cuuint64_t strides[1] = {inner * sizeof(__nv_bfloat16)};
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

}  // namespace
