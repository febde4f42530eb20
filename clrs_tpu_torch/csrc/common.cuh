// Launch and device helpers shared by the kernel sources of
// clrs_tpu_torch/csrc (each source is compiled on its own, so each keeps its
// own copies of the per-device caches below).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace clrs {

// dynamic shared memory a block may take on sm_90 (227 KB of the SM's 256)
constexpr size_t SMEM_MAX = 227 * 1024;

// The deepest k at which an int8 product of limbs in [-65, 65] stays exact
// in int32, also summed over the <= 31 limb pairs of one diagonal:
// 31 * 2^13 * 65^2 < 2^31.
constexpr int MAX_K_EXACT = 1 << 13;

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

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
}

// ---------------------------------------------------------------------------
// int8 tensor-core and staging helpers (int8_gemm, limb_gemm_fused)
// ---------------------------------------------------------------------------

// d += a b on the int8 tensor cores: a 16x32 A fragment (row-major) times a
// 32x8 B fragment (column-major), exact s32 accumulation. Fragment layout
// (g = lane / 4, t4 = lane % 4): a[0] = A[g][4 t4 .. +3], a[1] = A[g + 8][..],
// a[2] = A[g][16 + 4 t4 ..], a[3] = A[g + 8][16 + 4 t4 ..]; b0 = B[4 t4 ..
// +3][g], b1 = B[16 + 4 t4 ..][g]; d[0..1] = D[g][2 t4, 2 t4 + 1], d[2..3] =
// D[g + 8][2 t4, 2 t4 + 1].
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BYTES-byte (16 or 4) asynchronous copy global -> shared; zero fill where
// !valid (src is then not read).
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Closes the group of this thread's cp.asyncs issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four bytes p[0..3] of a row, each masked to 0 where its index is out of
// range (a ragged row). (Loading the aligned words around them and
// permuting the bytes did not pay on an H100.)
__device__ __forceinline__ unsigned load4_bytes(const int8_t* p, int valid) {
  unsigned v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < valid) v |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(p + c))) << (8 * c);
  return v;
}

// 4x4 byte transpose with byte permutes: rw[i] holds row i, columns 0..3;
// col[c] then holds column c, rows 0..3 (the column-major mma operand).
__device__ __forceinline__ void transpose_4x4_bytes(const unsigned (&rw)[4], unsigned (&col)[4]) {
  const unsigned lo01 = __byte_perm(rw[0], rw[1], 0x5140);
  const unsigned hi01 = __byte_perm(rw[0], rw[1], 0x7362);
  const unsigned lo23 = __byte_perm(rw[2], rw[3], 0x5140);
  const unsigned hi23 = __byte_perm(rw[2], rw[3], 0x7362);
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
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

// The same, with nw = 2 as well: the word count of the product V^T V of the
// certified step-length route (clrs_tpu/solver/step.py:1137), which reaches
// the limb GEMMs' cascade (cascade<2, true>, limb_gemm_fused<2>).
#define CLRS_DISPATCH_NW_PRODUCT(nw, call)       \
  switch (nw) {                                  \
    case 2: { constexpr int NWc = 2; call; } break; \
    case 5: { constexpr int NWc = 5; call; } break; \
    case 6: { constexpr int NWc = 6; call; } break; \
    case 7: { constexpr int NWc = 7; call; } break; \
    case 8: { constexpr int NWc = 8; call; } break; \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// The same over every operand word count, nw = 1..8: the extraction takes
// an operand of any word count (the certified route's eigenvectors are one
// word) to the limb count of its product.
#define CLRS_DISPATCH_NW_OPERAND(nw, call)       \
  switch (nw) {                                  \
    case 1: { constexpr int NWc = 1; call; } break; \
    case 2: { constexpr int NWc = 2; call; } break; \
    case 3: { constexpr int NWc = 3; call; } break; \
    case 4: { constexpr int NWc = 4; call; } break; \
    case 5: { constexpr int NWc = 5; call; } break; \
    case 6: { constexpr int NWc = 6; call; } break; \
    case 7: { constexpr int NWc = 7; call; } break; \
    case 8: { constexpr int NWc = 8; call; } break; \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
