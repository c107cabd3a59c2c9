// Hopper (sm_90a) building blocks shared by the int8 kernels
// (int8_conv.cu, int8_gemm.cu): mbarriers, TMA loads, wgmma descriptors
// and fences, the tie-guarded quantize of a bf16 activation, and libcuda's
// cuTensorMapEncodeTiled found with dlopen.  Each library includes it into
// its own translation unit; nothing here has external linkage.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

constexpr int kWG = 128;                // threads per warpgroup
constexpr int kSmemMax = 232448;        // shared memory one block may use
constexpr int kTensorMapError = 1000;   // + CUresult: a tensor map failed
constexpr int kSmemError = 2000;        // the tile needs more shared memory than a block has

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart; the tile base is
// 1024-byte aligned, so a K step of 32 bytes is a step of the start address.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |            // LBO (unused here)
         (static_cast<uint64_t>(1024 >> 4) << 32) |    // SBO
         (static_cast<uint64_t>(1) << 62);             // SWIZZLE_128B
}

// The same for 64-byte rows in the 64-byte swizzle (8-row groups 512 bytes
// apart): B tiles of 64 bytes of K.
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) | (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// clip(rint(v / s_x), -127, 127) without a branch: the reciprocal's
// product, clamped to [-127, 127] (which commutes with rounding) and rounded
// to nearest even by adding and subtracting 1.5 * 2^23: returns the sum's
// bits, whose low byte is the int8 value.  `near` is set where the product
// lies within 2^-14 of a tie between two integers, where the exact quotient
// must decide: |v * r - v / s_x| <= 2^-16 for |v / s_x| <= 128, so elsewhere
// both round alike.
__device__ __forceinline__ uint32_t quantize_fast(float v, float inv_s, bool& near) {
  const float p = fminf(fmaxf(__fmul_rn(v, inv_s), -127.0f), 127.0f);
  const float t = __fadd_rn(p, 12582912.0f);
  near = fabsf(__fsub_rn(p, __fsub_rn(t, 12582912.0f))) > 0.5f - 0x1p-14f;
  return __float_as_uint(t);
}

// The plain version's arithmetic, for the values near a tie: the int8 byte.
__device__ __forceinline__ uint32_t quantize_exact(float v, float s_x) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s_x)), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<int>(q)) & 0xFFu;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process already has
// loaded (PyTorch's), so the library links against the runtime only.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

}  // namespace
