// limb_gemm_fused: the fused limb GEMM and its diagonal cascade on the int8
// tensor cores (sm_90a), with a plain C interface (clrs_limb_gemm) loaded by
// clrs_tpu_torch/dd/build.py through ctypes. It replaces
// clrs_tpu/dd/pallas_linalg.py _limb_gemm_fused_call / pl_limb_gemm_fused.
//
// Out[b] (NW f32 words [m, n]) from A3[b] int8 [L, m, k] and B3[b] int8
// [L, k, n] (limb-major, row-major) and eab[b] int32 [m, n]: per output
// element the int32 diagonal sums D[d] = sum_{ta + tb = d} A[ta] B[tb],
// d < ND (L = ND = 21 at nw 5: 231 limb pairs; L = ND = 31 at nw 8: 496),
// folded by the cascade (limbs.cuh) into NW words. NW = 5..8, and 2 (L =
// ND = 10: the certified step-length route's V^T V, clrs_tpu/solver/
// step.py:1137, which takes this route from n = 126 on). The sums are exact in
// any order (|D| <= 31 * 2^13 * 65^2 < 2^31), so the tensor cores give the
// plain version's bits.
//
// What bounds it: per output element the cascade's ~1,900 dependent scalar
// operations at nw 5 (the int8 products of the kept pairs need about half
// that time at the tensor cores' peak), and at the main path's small shapes
// (a few hundred 16x8 tiles) the latency of a few k chunks and of one
// element's cascade chain. So the design keeps the diagonal sums on chip
// from the products to the cascade, and spreads both over all four
// schedulers of the SMs:
//  - products: mma.sync m16n8k32 .s32.s8.s8.s32 on 16x8 output tiles, each
//    shared by P = 2 or 4 warps, warp p taking A's limbs ta = p mod P
//    (about 1/P of the pairs). A warp holds one accumulator fragment per
//    diagonal (4 int32 a thread, 4 ND in all: 84 registers at nw 5, 124 at
//    nw 8) and B's fragments of all L limbs (2 L registers; at nw 7-8 in two
//    halves, A's fragments then loaded twice, to stay within 255
//    registers). Per k chunk of 32 it issues one mma per pair (ta, tb) it
//    owns into fragment ta + tb; the loops unroll fully, so every fragment
//    index is a constant;
//  - cascade: the P warps merge their sums with shared-memory atomicAdd
//    (exact, order-free); in the m16n8 C layout a lane holds the same 4
//    elements of every diagonal's fragment, and each of the tile's P warps
//    folds 4 / P of them, interleaved (cascade_fold<NW, 4 / P>);
//  - staging: all L limbs of a 32-deep k chunk of the block's A rows and B
//    columns in shared memory, two chunks in flight by cp.async, zero
//    filled past ragged m, n and k (nothing is padded in memory). A goes
//    straight into the fragment layout by 16- or 4-byte units where k and
//    the pointer allow; otherwise (k = 191 on the main path) each row's
//    three aligned 16-byte granules are staged and the fragments are read
//    with a funnel shift (bytes past k meet B's zero rows). B is staged as
//    its rows lie (16- or 4-byte units, or bytes through registers where n
//    is ragged), then transposed in shared memory as 4x4 byte blocks with
//    byte permutes (the mma wants it column-major). Rows are 32 bytes with
//    their two 16-byte halves swapped on rows 4-7 of every 8, so fragment
//    loads are conflict-free;
//  - tile: four warps a block, on 16x16 outputs (P 2) where that still
//    gives every SM two blocks, else on 16x8 (P 4).

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "limbs.cuh"

using namespace clrs;

namespace {

constexpr int GK = 32;      // k depth of a chunk: one mma step
constexpr int NSTAGE = 2;   // chunks in flight (a third cost more in occupancy than it hid)

// Word w of a staged 32-byte row r lies at word w ^ swz(r).
__device__ __forceinline__ int swz(int r) { return r & 4; }

__device__ __forceinline__ unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// A rows whose pitch or start is not a multiple of 4 bytes are staged as the
// three aligned 16-byte granules around their 32 bytes of a chunk.
constexpr int A_RAGGED_PITCH = 48;

// Word t of a staged ragged row whose bytes start at byte o of the row.
__device__ __forceinline__ unsigned shifted_word(const unsigned char* row, int o, int t) {
  const int w = (o >> 2) + t;
  return __funnelshift_r(lds32(row + 4 * w), lds32(row + 4 * w + 4), 8 * (o & 3));
}

// Block of four warps on BM x BN = 16 WM x 8 WN outputs of batch member
// blockIdx.z: WM x WN tiles of 16x8, each shared by P warps, warp p of a
// tile taking the rows ta = p mod P of A's limbs. Shared memory: the tiles'
// merged diagonal sums [WM WN][ND][4][32] int32; NSTAGE stages of A
// [L][BM][AP] and of B's rows [L][GK][BN]; then B^T [L][BN][GK]. avec (16 or
// 4; 1 with RAGGED, the granules): bytes per A staging unit; bvec (16, 4 or
// 1) likewise for B.
template <int NW, int WM, int WN, int P, bool RAGGED>
__global__ void __launch_bounds__(32 * WM * WN * P)
    limb_gemm_fused(const int8_t* __restrict__ A3, const int8_t* __restrict__ B3,
                    const int* __restrict__ EAB, float* __restrict__ Out, int m, int k, int n,
                    int avec, int bvec) {
  constexpr int L = limb_count(NW), ND = ndiag_count(NW);
  constexpr int THREADS = 32 * WM * WN * P, BM = 16 * WM, BN = 8 * WN, E = 4 / P;
  constexpr int S_BYTES = WM * WN * ND * 4 * 32 * 4;
  constexpr int B_STAGE = L * GK * BN;
  static_assert(P == 2 || P == 4, "two or four warps a tile");
  constexpr int AP = RAGGED ? A_RAGGED_PITCH : GK;  // bytes per staged A row
  constexpr int A_STAGE = L * BM * AP;
  constexpr int NSPLIT = NW >= 7 ? 2 : 1;  // B's fragments held in NSPLIT parts
  constexpr int TBS = (L + NSPLIT - 1) / NSPLIT;
  extern __shared__ __align__(16) unsigned char smem_all[];
  int* S = reinterpret_cast<int*>(smem_all);
  unsigned char* smem = smem_all + S_BYTES;
  unsigned char* Bt = smem + NSTAGE * (A_STAGE + B_STAGE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = warp % P, sub = warp / P, wm = sub / WN, wn = sub % WN;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const size_t amk = static_cast<size_t>(m) * k, bkn = static_cast<size_t>(k) * n;
  const int8_t* Ab = A3 + static_cast<size_t>(b) * L * amk;
  const int8_t* Bb = B3 + static_cast<size_t>(b) * L * bkn;
  for (int q = tid; q < S_BYTES / 4; q += THREADS) S[q] = 0;

  // Starts the copies of the chunk at k0 into stage s: A rows into the
  // fragment layout, B rows as they lie.
  auto fetch = [&](int s, int k0) {
    unsigned char* As = smem + s * A_STAGE;
    unsigned char* Br = smem + NSTAGE * A_STAGE + s * B_STAGE;
    if constexpr (RAGGED) {  // the aligned granules around each row's 32 bytes
      for (int u = tid; u < L * BM * 3; u += THREADS) {
        const int h = u % 3, r = (u / 3) % BM, l = u / 3 / BM;
        const int gi = i0 + r;
        const int8_t* row = Ab + l * amk + static_cast<size_t>(gi) * k;
        const int8_t* g0 = reinterpret_cast<const int8_t*>(
            reinterpret_cast<uintptr_t>(row + k0) & ~static_cast<uintptr_t>(15));
        const bool ok = gi < m && g0 + 16 * h < row + (k < k0 + GK ? k : k0 + GK);
        cp_async_zfill<16>(As + (l * BM + r) * AP + 16 * h, ok ? g0 + 16 * h : Ab, ok);
      }
    } else if (avec == 16) {
      for (int u = tid; u < L * BM * 2; u += THREADS) {
        const int h = u & 1, r = (u >> 1) % BM, l = (u >> 1) / BM;
        const int gi = i0 + r, kk = k0 + 16 * h;
        const bool ok = gi < m && kk < k;
        cp_async_zfill<16>(As + (l * BM + r) * GK + 4 * ((4 * h) ^ swz(r)),
                           ok ? Ab + l * amk + static_cast<size_t>(gi) * k + kk : Ab, ok);
      }
    } else {
      for (int u = tid; u < L * BM * 8; u += THREADS) {
        const int q = u & 7, r = (u >> 3) % BM, l = (u >> 3) / BM;
        const int gi = i0 + r, kk = k0 + 4 * q;
        const bool ok = gi < m && kk < k;
        cp_async_zfill<4>(As + (l * BM + r) * GK + 4 * (q ^ swz(r)),
                          ok ? Ab + l * amk + static_cast<size_t>(gi) * k + kk : Ab, ok);
      }
    }
    constexpr int BU = BN / 16 > 0 ? BN / 16 : 1;  // 16-byte units per B row
    if (bvec == 16) {
      for (int u = tid; u < L * GK * BU; u += THREADS) {
        const int h = u % BU, kk = (u / BU) % GK, l = u / BU / GK;
        const int gk = k0 + kk, gj = j0 + 16 * h;
        const bool ok = gk < k && gj < n;
        cp_async_zfill<16>(Br + (l * GK + kk) * BN + 16 * h,
                           ok ? Bb + l * bkn + static_cast<size_t>(gk) * n + gj : Bb, ok);
      }
    } else {
      for (int u = tid; u < L * GK * (BN / 4); u += THREADS) {
        const int c = u % (BN / 4), kk = (u / (BN / 4)) % GK, l = u / (BN / 4) / GK;
        const int gk = k0 + kk, gj = j0 + 4 * c;
        const bool ok = gk < k && gj < n;
        unsigned char* dst = Br + (l * GK + kk) * BN + 4 * c;
        const int8_t* src = ok ? Bb + l * bkn + static_cast<size_t>(gk) * n + gj : Bb;
        if (bvec == 4)
          cp_async_zfill<4>(dst, src, ok);
        else
          *reinterpret_cast<unsigned*>(dst) = ok ? load4_bytes(src, n - gj) : 0u;
      }
    }
  };
  // B^T of stage s into Bt, 4x4 byte blocks (4 k rows x 4 columns) at a time.
  auto transpose = [&](int s) {
    const unsigned char* Br = smem + NSTAGE * A_STAGE + s * B_STAGE;
    for (int u = tid; u < L * (BN / 4) * (GK / 4); u += THREADS) {
      const int c4 = u % (BN / 4), q = (u / (BN / 4)) % (GK / 4), l = u / (BN / 4) / (GK / 4);
      unsigned rw[4], col[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) rw[i] = lds32(Br + (l * GK + 4 * q + i) * BN + 4 * c4);
      transpose_4x4_bytes(rw, col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = 4 * c4 + c;
        *reinterpret_cast<unsigned*>(Bt + (l * BN + r) * GK + 4 * (q ^ swz(r))) = col[c];
      }
    }
  };

  int dsum[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dsum[d][c] = 0;

  const int ra = wm * 16 + g;  // A rows ra, ra + 8 (the same swizzle)
  const int cb = wn * 8 + g;   // B^T row (output column) of this lane's fragments
  const bool active = i0 + wm * 16 < m && j0 + wn * 8 < n;
  const int nk = (k + GK - 1) / GK;
  uintptr_t a_row = 0;  // address of row ra's bytes of the current chunk (ragged A)
#pragma unroll
  for (int c = 0; c < NSTAGE - 1; ++c) {
    if (c < nk) fetch(c, c * GK);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc % NSTAGE, ahead = kc + NSTAGE - 1;
    if (ahead < nk) fetch(ahead % NSTAGE, ahead * GK);
    cp_async_commit();
    cp_async_wait_group<NSTAGE - 1>();  // chunk kc has landed
    __syncthreads();
    transpose(s);
    __syncthreads();
    if (active) {
      const unsigned char* As = smem + s * A_STAGE;
      a_row = reinterpret_cast<uintptr_t>(Ab + static_cast<size_t>(i0 + ra) * k + kc * GK);
#pragma unroll
      for (int part = 0; part < NSPLIT; ++part) {
        unsigned bf[TBS][2];
#pragma unroll
        for (int t = 0; t < TBS; ++t) {
          const int tb = part * TBS + t;
          if (tb < L) {
            const unsigned char* p = Bt + (tb * BN + cb) * GK;
            bf[t][0] = lds32(p + 4 * (t4 ^ swz(cb)));
            bf[t][1] = lds32(p + 4 * ((t4 + 4) ^ swz(cb)));
          }
        }
#pragma unroll
        for (int ta = 0; ta < L; ++ta) {
          if (ta + part * TBS >= ND || ta % P != p) continue;
          const unsigned char* pa = As + (ta * BM + ra) * AP;
          unsigned af[4];
          if constexpr (RAGGED) {  // rows ra, ra + 8 start at byte o0, o1 of their granules
            const uintptr_t at = a_row + ta * amk;
            const int o0 = static_cast<int>(at & 15), o1 = static_cast<int>((at + 8 * k) & 15);
            af[0] = shifted_word(pa, o0, t4);
            af[1] = shifted_word(pa + 8 * AP, o1, t4);
            af[2] = shifted_word(pa, o0, t4 + 4);
            af[3] = shifted_word(pa + 8 * AP, o1, t4 + 4);
          } else {
            af[0] = lds32(pa + 4 * (t4 ^ swz(ra)));
            af[1] = lds32(pa + 8 * GK + 4 * (t4 ^ swz(ra)));
            af[2] = lds32(pa + 4 * ((t4 + 4) ^ swz(ra)));
            af[3] = lds32(pa + 8 * GK + 4 * ((t4 + 4) ^ swz(ra)));
          }
#pragma unroll
          for (int t = 0; t < TBS; ++t) {
            const int tb = part * TBS + t;
            if (tb < L && ta + tb < ND) mma_s8(dsum[ta + tb], af, bf[t][0], bf[t][1]);
          }
        }
      }
    }
    __syncthreads();  // stage s and Bt are refilled next
  }
  if (active)  // merge the P warps' partial sums (exact int32 adds)
#pragma unroll
    for (int d = 0; d < ND; ++d)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        atomicAdd(&S[((sub * ND + d) * 4 + c) * 32 + lane], dsum[d][c]);
  __syncthreads();
  if (!active) return;

  // this warp's elements: c = p E + e of the lane's four in the m16n8 C
  // layout, rows ra (c < 2) and ra + 8, columns 2 t4 + c % 2
  const size_t plane = static_cast<size_t>(m) * n;
  int eab[E];
  size_t off[E];
  bool ok[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int c = p * E + e;
    const int i = i0 + ra + 8 * (c >> 1), j = j0 + wn * 8 + 2 * t4 + (c & 1);
    ok[e] = i < m && j < n;
    off[e] = static_cast<size_t>(i) * n + j;
    eab[e] = ok[e] ? EAB[static_cast<size_t>(b) * plane + off[e]] : 0;
  }
  float res[E][NW];
  cascade_fold<NW, E>(
      [&](int d, int e) { return S[((sub * ND + d) * 4 + p * E + e) * 32 + lane]; }, eab, res);
  float* ob = Out + static_cast<size_t>(b) * NW * plane;
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (ok[e])
#pragma unroll
      for (int w = 0; w < NW; ++w) ob[w * plane + off[e]] = res[e][w];
}

template <int NW, int WM, int WN, int P, bool RAGGED>
int launch_tile(const int8_t* a3, const int8_t* b3, const int* eab, float* out, int B, int m,
                int k, int n, int dev, cudaStream_t s) {
  static unsigned long long opted = 0;
  constexpr int L = limb_count(NW), ND = ndiag_count(NW), BM = 16 * WM, BN = 8 * WN;
  constexpr int AP = RAGGED ? A_RAGGED_PITCH : GK;
  constexpr size_t bytes = static_cast<size_t>(L) * (NSTAGE * (BM * AP + GK * BN) + BN * GK) +
                           static_cast<size_t>(WM) * WN * ND * 4 * 32 * 4;
  static_assert(bytes <= SMEM_MAX, "stages exceed shared memory");
  if (ceil_div(m, BM) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int avec = RAGGED ? 1 : (k % 16 == 0 && aligned(a3, 16)) ? 16 : 4;
  const int bvec = (BN % 16 == 0 && n % 16 == 0 && aligned(b3, 16)) ? 16
                   : (n % 4 == 0 && aligned(b3, 4))                  ? 4
                                                                      : 1;
  const cudaError_t e = smem_opt_in(limb_gemm_fused<NW, WM, WN, P, RAGGED>, opted, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(ceil_div(n, BN)), static_cast<unsigned>(ceil_div(m, BM)),
                  B);
  limb_gemm_fused<NW, WM, WN, P, RAGGED>
      <<<grid, 32 * WM * WN * P, bytes, s>>>(a3, b3, eab, out, m, k, n, avec, bvec);
  return 0;
}

// Four warps a block: on 16x16 outputs (two warps a 16x8 tile, each
// folding two elements a lane) where that still gives every SM two blocks,
// else on 16x8 (four warps a tile, one element each). At the main path's
// shapes on an H100 the 16x8 tile is the faster one below that count, and
// 16x16 above it; one warp a 32x16 block's tile was slower at all of them.
// A whose rows are not 4-byte aligned (k = 191 on the main path) takes the
// granule staging (RAGGED), its own instance, so that the aligned path
// keeps its registers.
template <int NW>
int launch_gemm(const int8_t* a3, const int8_t* b3, const int* eab, float* out, int B, int m,
                int k, int n, cudaStream_t s) {
  int dev = 0;
  cudaGetDevice(&dev);
  const bool wide = B * ceil_div(m, 16) * ceil_div(n, 16) >= 2L * sm_count(dev);
  if (!(k % 4 == 0 && aligned(a3, 4)))
    return wide ? launch_tile<NW, 1, 2, 2, true>(a3, b3, eab, out, B, m, k, n, dev, s)
                : launch_tile<NW, 1, 1, 4, true>(a3, b3, eab, out, B, m, k, n, dev, s);
  return wide ? launch_tile<NW, 1, 2, 2, false>(a3, b3, eab, out, B, m, k, n, dev, s)
              : launch_tile<NW, 1, 1, 4, false>(a3, b3, eab, out, B, m, k, n, dev, s);
}

}  // namespace

extern "C" {

int clrs_limb_gemm(const int8_t* a3, const int8_t* b3, const int* eab, float* out, int B, int m,
                   int k, int n, int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || m <= 0 || k <= 0 || n <= 0 || B > 65535 || k > MAX_K_EXACT)
    return static_cast<int>(cudaErrorInvalidValue);
  CLRS_DISPATCH_NW_PRODUCT(nw, {
    const int rc = launch_gemm<NWc>(a3, b3, eab, out, B, m, k, n, s);
    if (rc != 0) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
