// Launch helpers shared by the kernel sources of clrs_tpu_torch/csrc (each
// source is compiled on its own, so each keeps its own copies of the
// per-device caches below).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace clrs {

// dynamic shared memory a block may take on sm_90 (227 KB of the SM's 256)
constexpr size_t SMEM_MAX = 227 * 1024;

inline long ceil_div(long a, long b) { return (a + b - 1) / b; }

// SMs of device dev (read once per device).
inline int sm_count(int dev) {
  static int cache[64] = {0};
  if (dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = v > 0 ? v : 132;
  }
  return cache[dev];
}

// Lets `kernel` take up to SMEM_MAX of dynamic shared memory on device dev,
// once per kernel instantiation and device (`done` is its device bit set).
template <typename Kernel>
cudaError_t smem_opt_in(Kernel kernel, unsigned long long& done, int dev) {
  if (dev >= 0 && dev < 64 && (done >> dev & 1ull)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(SMEM_MAX));
  if (e == cudaSuccess && dev >= 0 && dev < 64) done |= 1ull << dev;
  return e;
}

}  // namespace clrs

// Runs `call` with the word count as the constant NWc (the f32 substrate's
// ladder, nw = 5..8); other word counts return cudaErrorInvalidValue.
#define CLRS_DISPATCH_NW(nw, call)               \
  switch (nw) {                                  \
    case 5: { constexpr int NWc = 5; call; } break; \
    case 6: { constexpr int NWc = 6; call; } break; \
    case 7: { constexpr int NWc = 7; call; } break; \
    case 8: { constexpr int NWc = 8; call; } break; \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
