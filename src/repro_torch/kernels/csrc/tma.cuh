// Shared by the port's CUDA sources: the mbarrier and 1-D bulk-copy (TMA)
// helpers, and the launch set-up cached once a device (the opt-in
// shared-memory limit and a kernel's dynamic shared-memory attribute).
// Included by each source before its own code; every source builds into a
// library of its own, so each keeps its own copy of the caches.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxDevices = 64;     // devices whose set-up is cached

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one contiguous run of `bytes` from global memory into shared memory,
// completing on `bar` (both addresses 16-byte aligned, bytes % 16 == 0)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// the device's opt-in shared-memory limit a block, read once a device
inline cudaError_t optin_of(int dev, int* optin) {
  static std::atomic<int> cache[kMaxDevices];
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached) {
    *optin = cache[dev].load(std::memory_order_relaxed);
    if (*optin > 0) return cudaSuccess;
  }
  cudaError_t err = cudaDeviceGetAttribute(
      optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && cached)
    cache[dev].store(*optin, std::memory_order_relaxed);
  return err;
}

// One kernel's dynamic shared-memory attribute, raised once a device to the
// largest size seen past the 48-KB default.
struct SmemAttribute {
  std::atomic<int> set[kMaxDevices];

  cudaError_t allow(const void* kernel, int dev, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    const bool cached = dev >= 0 && dev < kMaxDevices;
    if (cached && (int)smem <= set[dev].load()) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess || !cached) return err;
    int seen = set[dev].load();
    while ((int)smem > seen &&
           !set[dev].compare_exchange_weak(seen, (int)smem)) {
    }
    return cudaSuccess;
  }
};

}  // namespace
