// int8_gemm: the split GEMM route's exact int8 product on the int8 tensor
// cores (sm_90a), with a plain C interface (clrs_int8_gemm) loaded by
// clrs_tpu_torch/dd/build.py through ctypes.
//
// C[b] = A[b] B[b]: int8 A [B, M, K] row-major (M = L m, the 'a' GEMM
// layout of the limb extraction) times int8 B [B, K, N] row-major (N = L n,
// the 'b' layout) -> exact int32 C [B, M, N]. It stands for the XLA
// dot_general of clrs_tpu/dd/limb_gemm.py:307 (not a Pallas kernel there).
// Limbs lie in [-65, 65] and K <= 2^13, so |C| <= 34,611,200: the s32
// accumulators of the tensor cores are exact.
//
// What bounds it: at the main path's depths (K 11..37) the work is the
// store of C, 4 M N bytes, about 99% of the traffic; the products are a few
// tensor-core instructions per output tile. So the design spends its care
// on the stores and on having enough blocks in flight:
//  - products: mma.sync m16n8k32 .s8.s8.s32 (A row-major, B column-major
//    from shared memory), K padded to 32 with zeros in shared memory;
//  - staging: each k chunk of 32 goes to one of two shared stages, A in the
//    widest units its pitch allows (16- or 4-byte cp.async with zero fill
//    where K is a multiple of 16 or 4, else byte loads packed in
//    registers), B as 4x4 byte blocks (4-byte loads where N is a multiple
//    of 4, else bytes) transposed in registers with byte permutes, so that
//    each B row of the mma's column-major operand is one 32-bit word; the
//    next chunk's loads are in flight while the tensor cores work on this
//    one. Ragged pitches (K = 11 or 37, N = L n) are the main path's, and
//    their byte staging is what the kernel loses to aligned operands
//    (chip_smoke.py times it on both at 462x11x462: about 1 us);
//  - rows of 48 bytes (12 words) make every fragment load conflict-free;
//  - epilogue: the accumulators go through shared memory, and a warp then
//    stores 32 consecutive ints (one 128-byte line) per instruction, or 16
//    bytes a thread where N is a multiple of 4;
//  - the tile (64x64, 32x64, 32x32 or 16x32; 64x32 for N <= 32 instead
//    of the 64-wide ones) is the largest that still gives every SM three
//    blocks.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

using namespace clrs;

namespace {

constexpr int GK = 32;          // k depth of one mma step and one stage
constexpr int KP = 48;          // bytes per staged row of A or of B^T
constexpr int G_THREADS = 128;  // four warps

// A tile of BM x BN outputs: WM x WN warps, each MT x NT mma tiles of 16 x 8.
// avec (16, 4 or 1): bytes per A staging unit; bvec (4 or 1): bytes per B
// row load; cvec (4 or 1): ints per C store.
template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(G_THREADS)
    int8_gemm(const int8_t* __restrict__ A, const int8_t* __restrict__ Bm, int* __restrict__ C,
              int M, int K, int N, int avec, int bvec, int cvec) {
  static_assert(WM * WN * 32 == G_THREADS, "four warps");
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr int STAGE = (BM + BN) * KP;        // bytes of one k stage
  constexpr int CP = BN + 8;                   // ints per staged C row
  constexpr int SMEM = 2 * STAGE > BM * CP * 4 ? 2 * STAGE : BM * CP * 4;
  constexpr int AU = BM * 8;                   // A units: (row, k quad)
  constexpr int BU = BN * 2;                   // B units: (column quad, k quad)
  constexpr int A_PER = (AU + G_THREADS - 1) / G_THREADS;
  constexpr int B_PER = (BU + G_THREADS - 1) / G_THREADS;
  __shared__ __align__(16) unsigned char smem[SMEM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int8_t* Ab = A + static_cast<size_t>(b) * M * K;
  const int8_t* Bb = Bm + static_cast<size_t>(b) * K * N;

  unsigned areg[A_PER];     // the ragged path's A words of the next chunk
  unsigned breg[B_PER][4];  // B^T words of the next chunk

  // Starts the loads of the chunk at k0 into stage s: cp.async for A where
  // its pitch allows, registers otherwise and for B.
  auto fetch = [&](int s, int k0) {
    unsigned char* As = smem + s * STAGE;
    if (avec == 16) {
      for (int u = tid; u < BM * 2; u += G_THREADS) {
        const int r = u >> 1, h = u & 1, gi = i0 + r, k = k0 + 16 * h;
        const bool ok = gi < M && k < K;
        cp_async_zfill<16>(As + r * KP + 16 * h, ok ? Ab + static_cast<size_t>(gi) * K + k : Ab,
                           ok);
      }
    } else if (avec == 4) {
      for (int u = tid; u < AU; u += G_THREADS) {
        const int r = u >> 3, q = u & 7, gi = i0 + r, k = k0 + 4 * q;
        const bool ok = gi < M && k < K;
        cp_async_zfill<4>(As + r * KP + 4 * q, ok ? Ab + static_cast<size_t>(gi) * K + k : Ab,
                          ok);
      }
    } else {
#pragma unroll
      for (int e = 0; e < A_PER; ++e) {
        const int u = tid + e * G_THREADS;
        const int r = u >> 3, q = u & 7, gi = i0 + r, k = k0 + 4 * q;
        areg[e] = (u < AU && gi < M && k < K)
                      ? load4_bytes(Ab + static_cast<size_t>(gi) * K + k, K - k)
                      : 0u;
      }
    }
#pragma unroll
    for (int e = 0; e < B_PER; ++e) {
      const int u = tid + e * G_THREADS;
      const int q = u & 7, jq = u >> 3, j = j0 + 4 * jq;
      unsigned rw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + 4 * q + i;
        const int8_t* p = Bb + static_cast<size_t>(k) * N + j;
        if (u >= BU || k >= K || j >= N)
          rw[i] = 0u;
        else if (bvec == 4)
          rw[i] = __ldg(reinterpret_cast<const unsigned*>(p));
        else
          rw[i] = load4_bytes(p, N - j);
      }
      // breg[e][c] holds B[k0 + 4q + 0..3][j + c]
      transpose_4x4_bytes(rw, breg[e]);
    }
  };
  // Stores the register-held part of the chunk into stage s.
  auto commit = [&](int s) {
    unsigned char* As = smem + s * STAGE;
    unsigned char* Bs = As + BM * KP;
    if (avec == 1) {
#pragma unroll
      for (int e = 0; e < A_PER; ++e) {
        const int u = tid + e * G_THREADS;
        if (u < AU) *reinterpret_cast<unsigned*>(As + (u >> 3) * KP + 4 * (u & 7)) = areg[e];
      }
    }
#pragma unroll
    for (int e = 0; e < B_PER; ++e) {
      const int u = tid + e * G_THREADS;
      if (u < BU) {
        const int q = u & 7, jq = u >> 3;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          *reinterpret_cast<unsigned*>(Bs + (4 * jq + c) * KP + 4 * q) = breg[e][c];
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0;

  const int nk = (K + GK - 1) / GK;
  fetch(0, 0);
  commit(0);
  cp_async_wait_all();
  __syncthreads();
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    if (kc + 1 < nk) fetch(s ^ 1, (kc + 1) * GK);
    const unsigned char* As = smem + s * STAGE;
    const unsigned char* Bs = As + BM * KP;
    unsigned af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const unsigned char* ar = As + (wm * MT * 16 + mt * 16 + g) * KP + 4 * t4;
      af[mt][0] = *reinterpret_cast<const unsigned*>(ar);
      af[mt][1] = *reinterpret_cast<const unsigned*>(ar + 8 * KP);
      af[mt][2] = *reinterpret_cast<const unsigned*>(ar + 16);
      af[mt][3] = *reinterpret_cast<const unsigned*>(ar + 8 * KP + 16);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const unsigned char* br = Bs + (wn * NT * 8 + nt * 8 + g) * KP + 4 * t4;
      const unsigned b0 = *reinterpret_cast<const unsigned*>(br);
      const unsigned b1 = *reinterpret_cast<const unsigned*>(br + 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], af[mt], b0, b1);
    }
    if (kc + 1 < nk) commit(s ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: accumulators -> shared C tile -> whole lines of C
  int* Cs = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = wm * MT * 16 + mt * 16 + g, c = wn * NT * 8 + nt * 8 + 2 * t4;
      *reinterpret_cast<int2*>(Cs + r * CP + c) = make_int2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<int2*>(Cs + (r + 8) * CP + c) = make_int2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  int* Cb = C + static_cast<size_t>(b) * M * N;
  if (cvec == 4) {
    for (int u = tid; u < BM * BN / 4; u += G_THREADS) {
      const int r = u / (BN / 4), c = 4 * (u % (BN / 4));
      const int gi = i0 + r, gj = j0 + c;
      if (gi < M && gj < N)
        *reinterpret_cast<int4*>(Cb + static_cast<size_t>(gi) * N + gj) =
            *reinterpret_cast<const int4*>(Cs + r * CP + c);
    }
  } else {
    for (int u = tid; u < BM * BN; u += G_THREADS) {
      const int r = u / BN, c = u % BN;
      const int gi = i0 + r, gj = j0 + c;
      if (gi < M && gj < N) Cb[static_cast<size_t>(gi) * N + gj] = Cs[r * CP + c];
    }
  }
}

template <int WM, int WN, int MT, int NT>
int launch(const int8_t* a, const int8_t* b, int* c, int B, int M, int K, int N, int avec,
           int bvec, int cvec, cudaStream_t s) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  if (ceil_div(M, BM) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ceil_div(N, BN)), static_cast<unsigned>(ceil_div(M, BM)),
                  B);
  int8_gemm<WM, WN, MT, NT><<<grid, G_THREADS, 0, s>>>(a, b, c, M, K, N, avec, bvec, cvec);
  return 0;
}

}  // namespace

extern "C" {

int clrs_int8_gemm(const int8_t* a, const int8_t* b, int* c, int B, int M, int K, int N,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0 || K <= 0 || N <= 0 || B > 65535 || K > MAX_K_EXACT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int avec = (K % 16 == 0 && aligned(a, 16)) ? 16 : (K % 4 == 0 && aligned(a, 4)) ? 4 : 1;
  const int bvec = (N % 4 == 0 && aligned(b, 4)) ? 4 : 1;
  const int cvec = (N % 4 == 0 && aligned(c, 16)) ? 4 : 1;
  // the largest tile that still gives each SM three blocks (measured on
  // an H100 over the split route's shapes: fewer, larger tiles lose to the
  // latency of their loads and stores), else the smallest
  int dev = 0;
  cudaGetDevice(&dev);
  const long want = 3L * sm_count(dev);
  auto blocks = [&](int bm, int bn) { return B * ceil_div(M, bm) * ceil_div(N, bn); };
  int rc;
  if (N > 32 && blocks(64, 64) >= want)
    rc = launch<2, 2, 2, 4>(a, b, c, B, M, K, N, avec, bvec, cvec, s);
  else if (N > 32 && blocks(32, 64) >= want)
    rc = launch<2, 2, 1, 4>(a, b, c, B, M, K, N, avec, bvec, cvec, s);
  else if (N <= 32 && blocks(64, 32) >= want)
    rc = launch<4, 1, 1, 4>(a, b, c, B, M, K, N, avec, bvec, cvec, s);
  else if (blocks(32, 32) >= want)
    rc = launch<2, 2, 1, 2>(a, b, c, B, M, K, N, avec, bvec, cvec, s);
  else
    rc = launch<1, 4, 1, 1>(a, b, c, B, M, K, N, avec, bvec, cvec, s);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
