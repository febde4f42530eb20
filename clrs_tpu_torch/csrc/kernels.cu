// The CUDA kernels of the f32-expansion IPM (sm_90a), with a plain C
// interface loaded by clrs_tpu_torch/dd/build.py through ctypes.
//
// Each C entry (here and in the other sources of csrc/, each compiled on
// its own) launches on the caller's stream, synchronises nothing,
// allocates nothing and returns cudaGetLastError(). Word counts NW = 5..8
// are instantiated (the f32 substrate's ladder), and besides them the
// extraction's operands of 1..4 words (to a limb count the caller gives)
// and the cascade's NW = 2 (the certified step-length route's V^T V,
// clrs_tpu/solver/step.py:1137); other values return
// cudaErrorInvalidValue. Word tensors are stacked word-major, [B, NW, rows,
// cols], except where a kernel reads each word where it lies (the
// extraction, the pl_map chains).
//
// limb_extract              replaces clrs_tpu/dd/pallas_linalg.py
//   _extract_call / pl_extract (all four layouts: 'a3'/'b3'/'a' limb-major,
//   'b' as the [d0, L d1] GEMM operand), an operand of NW = 1..8 words cut
//   into the L limbs of its product, which the caller gives, as
//   pl_extract(a, L, ...) takes it (L 10 for an nw-2 product, 21 for nw
//   5, 31 for nw 8; the certified route extracts its one-word
//   eigenvectors to each). At the main path's sizes (a few
//   thousand elements) bound by latency: the per-row (side a) or
//   per-column (side b) exponent, a reduction over the whole row or column
//   of word 0, then each element's chain of L rounds of an NW-word vec_sum
//   (about 10 dependent operations a round). One launch per call, reading
//   each word where it lies through its strides (no stacked copy): each
//   block reduces the exponents its tile needs in parallel (coalesced
//   loads, atomicMax on the sign-cleared bit patterns in shared memory,
//   which reproduces amax exactly, NaN included), then extracts its tile,
//   one element a thread.
// limb_gemm_fused           replaces _limb_gemm_fused_call / pl_limb_gemm_fused:
//   csrc/limb_gemm.cu (int8 tensor cores, the cascade in registers).
// int8_gemm                 the split route's int8 product: csrc/int8_gemm.cu.
// cascade<FROM_C>           replaces _cascade_tiles_call / pl_cascade_tiles
//   and _cascade_tiles_grid_call / pl_cascade_tiles_grid: the diagonal sums
//   of C and the cascade. At the main path's sizes bound by latency: each
//   element's ND diagonal sums need up to L loads each from different row
//   blocks of C, then a fold of ND dependent rounds. A block owns a tile of
//   output elements (sized so that the blocks cover the SMs); its threads
//   issue all the tile's limb-pair loads at once and sum each diagonal in
//   int32 into shared memory, then one thread an element folds them
//   (csrc/limbs.cuh cascade_fold). Any m, n; no padding.
// cascade<FROM_DIAGS>       replaces _cascade_call / pl_cascade (no caller in
//   either package): the same fold from precomputed diagonal sums, each
//   thread's ND loads issued before it.
// plmap<NW, FN>             replaces pl_map at its three call sites in
//   clrs_tpu/solver/step.py (FN: the corrector sum, the state update, the
//   residual with and without the corrector term). Bound by latency at
//   these sizes: the launch, one load round trip and one element's chain.
//   A (column tile, row tile, l) grid of 64-thread blocks, one element a
//   thread, 32-bit offsets within a plane and no division; each operand is
//   read as the wrapper classified it (a plane with unit column stride and
//   one offset for all its words; an [L, 1, 1] scalar read at one address;
//   or any strided view).
// chol_batched              replaces _chol_call / pl_cholesky_b: csrc/chol.cu.
// tri_solve_batched<TRANS>  replaces _tril_call (forward, L X = B) and
//   _tril_t_call (transposed, L^T X = B) (pl_solve_tril_b /
//   pl_solve_tril_t_b). Bound by the n dependent rows: each is a chain of
//   expansion ops with block-wide barriers. Columns of X are independent, so
//   the grid is (batch, column tile) and a tile of TC columns is chosen to
//   spread B m columns over the SMs. Each block stages L's lower triangle
//   (packed by column), its tile of B and the tree schedule in shared memory
//   with cp.async, computes dinv = 1/diag once, solves, and writes its tile
//   of X once. Forward: right-looking, one step per row, all trailing
//   (row, column) updates in parallel, and the next row's x scaled by the
//   thread that finished its update. Transposed: per row, all leaf products
//   in parallel, then the halving tree of _exp_sum_axis0 reduced level by
//   level from the schedule the wrapper passes (dd/kernels.py
//   _tree_schedule, the one the plain version runs): about log2(n) + 3
//   dependent ops per row instead of about 2n.

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "expansion.cuh"
#include "limbs.cuh"

using namespace clrs;

namespace {

// ---------------------------------------------------------------------------
// limb extraction
// ---------------------------------------------------------------------------

constexpr int MAX_NW = 8;
constexpr int EX_THREADS = 128;
constexpr int EX_MAX_SPLIT = 16;  // tiles sharing one row (side a) or column (side b)

// The NW word tensors of an operand, each [B, d0, d1] where it lies, with
// its own element strides (any view: transposed, sliced or broadcast).
struct WordPtrs {
  const float* w[MAX_NW];
  long long s[MAX_NW][3];
};

// e with |word0| * 2^-e <= 1/2 from the sign-cleared bits of max|word0| of a
// row or column (1 where it is 0). The maximum of the sign-cleared bit
// patterns is amax's, NaN included: a NaN's bits exceed every number's and
// infinity's, and its exponent field, 255, gives e = 130, as in
// limb_extract_plain and clrs_tpu's _row_exp_f32.
__device__ __forceinline__ int exp_of_maxbits(unsigned bits) {
  if (bits == 0u) bits = __float_as_uint(1.0f);
  return static_cast<int>((bits >> 23) & 0xFFu) - 125;
}

__device__ __forceinline__ unsigned abs_bits(float x) { return __float_as_uint(x) & 0x7FFFFFFFu; }

__device__ __forceinline__ unsigned max_u(unsigned a, unsigned b) { return a > b ? a : b; }

// One launch per call. Block (x, y) of batch member z covers the tile of
// rows [y TR, y TR + TR) and columns [x TC, x TC + TC) of the [d0, d1]
// plane, TR = RT rpt and TC = CQ cpt with RT CQ = EX_THREADS: thread
// t = rr CQ + cq owns the elements at tile row rr + RT a and tile column
// cq + CQ c, a < rpt, c < cpt. The words of its first element are loaded
// first, so that their latency overlaps pass 1's. Pass 1: the exponents of
// the tile's rows (side a, rpt = 1: each thread takes every CQ-th element
// of its row) or columns (side b, cpt = 1: every RT-th row of its column),
// each over the whole row or column of word 0 with coalesced loads,
// reduced into shared memory by atomicMax on the bit patterns (exact and
// order-free). Tiles that split a row (column) each read all of it again,
// mostly from L2; the launcher keeps that to EX_MAX_SPLIT tiles. Pass 2:
// each element scaled by its exponent, then L rounds of x128, vec_sum,
// round half to even and subtract (L, the limb count of the product, apart
// from the operand's NW). Limbs go limb-major [L, d0, d1] (the
// 'a3'/'b3' layouts, and 'a' [L d0, d1], which is the same memory) or,
// with b_gemm, as the 'b' GEMM operand [d0, L d1] (limb t of element
// (i, j) at column t d1 + j); a warp's stores of one limb are consecutive
// bytes. One element a thread: at the main path's shapes the kernel waits
// on its chain's latency, not on issue, so on an H100 more threads with one
// chain each beat fewer threads that interleave two or four.
template <int NW>
__global__ void __launch_bounds__(EX_THREADS)
    limb_extract(WordPtrs W, int8_t* __restrict__ limbs, int* __restrict__ E, int d0, int d1,
                 int side_a, int b_gemm, int cq_n, int rpt, int cpt, int L) {
  __shared__ unsigned mx[EX_THREADS];  // exponent bits of the tile's TR (side a) or TC groups
  const int CQ = cq_n, RT = EX_THREADS / cq_n;
  const int TR = RT * rpt, TC = CQ * cpt;
  const int tid = threadIdx.x, cq = tid % CQ, rr = tid / CQ;
  const int b = blockIdx.z, r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const size_t plane = static_cast<size_t>(d0) * d1;
  const int ngroups = side_a ? TR : TC;
  for (int q = tid; q < ngroups; q += EX_THREADS) mx[q] = 0u;

  auto at = [&](int w, int i, int j) {
    return __ldg(W.w[w] + b * W.s[w][0] + i * W.s[w][1] + j * W.s[w][2]);
  };
  float raw[NW];
  auto load_words = [&](int i, int j) {
#pragma unroll
    for (int w = 0; w < NW; ++w) raw[w] = at(w, i, j);
  };
  if (r0 + rr < d0 && c0 + cq < d1) load_words(r0 + rr, c0 + cq);
  __syncthreads();

  if (side_a) {
    const int i = r0 + rr;
    if (i < d0) {
      unsigned m = 0u;
#pragma unroll 4
      for (int j = cq; j < d1; j += CQ) m = max_u(m, abs_bits(at(0, i, j)));
      atomicMax(&mx[rr], m);
    }
  } else {
    const int j = c0 + cq;
    if (j < d1) {
      unsigned m = 0u;
#pragma unroll 4
      for (int i = rr; i < d0; i += RT) m = max_u(m, abs_bits(at(0, i, j)));
      atomicMax(&mx[cq], m);
    }
  }
  __syncthreads();
  if (side_a ? blockIdx.x == 0 : blockIdx.y == 0) {  // one tile writes each exponent
    const int g0 = side_a ? r0 : c0, groups = side_a ? d0 : d1;
    for (int q = tid; q < ngroups && g0 + q < groups; q += EX_THREADS)
      E[static_cast<size_t>(b) * groups + g0 + q] = exp_of_maxbits(mx[q]);
  }

  const size_t rs = b_gemm ? static_cast<size_t>(L) * d1 : d1;  // limbs' row stride
  const size_t ls = b_gemm ? d1 : plane;                         // limbs' limb stride
  int8_t* Lb = limbs + static_cast<size_t>(b) * L * plane;
#pragma unroll 1
  for (int a = 0; a < rpt; ++a) {
#pragma unroll 1
    for (int c = 0; c < cpt; ++c) {
      const int tr = rr + RT * a, tc = cq + CQ * c;
      const int i = r0 + tr, j = c0 + tc;
      if (i >= d0 || j >= d1) continue;
      if (a | c) load_words(i, j);
      const int e = exp_of_maxbits(mx[side_a ? tr : tc]);
      float ws[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) ws[w] = mul_pow2_word<4>(raw[w], -e);
      int8_t* out = Lb + static_cast<size_t>(i) * rs + j;
#pragma unroll 1
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int w = 0; w < NW; ++w) ws[w] = fmul(ws[w], 128.0f);
        vec_sum<NW>(ws);
        const float d = rintf(ws[0]);  // round half to even
        ws[0] = fsub(ws[0], d);
        out[static_cast<size_t>(l) * ls] = static_cast<int8_t>(static_cast<int>(d));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the cascade from a finished int8 product C, or from precomputed diagonals
// ---------------------------------------------------------------------------

constexpr int CASCADE_TILE_MAX = 32;  // output elements a block

// Threads an element takes in a FROM_C block's phase 1: each sums diagonals
// s and ND - 1 - s, whose limb pairs number at most ND + 1 together.
__host__ __device__ constexpr int cascade_slices(int nw) { return (ndiag_count(nw) + 1) / 2; }

// Dynamic shared memory of a FROM_C block, in ints: the diagonal sums
// D[ND][tile] and the staged loads, stage[ND + 1][tile slices].
__host__ __device__ constexpr int cascade_smem_ints(int nw, int tile) {
  return ndiag_count(nw) * tile + (ndiag_count(nw) + 1) * tile * cascade_slices(nw);
}

// Block (x, b) owns the `tile` output elements x tile .. x tile + tile - 1 of
// batch member b, flattened row-major over [m, n] (tile a power of two,
// 8..CASCADE_TILE_MAX, chosen by dd/kernels.py cascade_tile so that the
// blocks cover the SMs). eab [B, m, n]; out [B, NW, m, n].
//
// FROM_C (pl_cascade_tiles and pl_cascade_tiles_grid, which differ only in
// how the TPU stages C through VMEM): C [B, L m, L n] int32 with limb-major
// row and column blocks; diagonal d sums C[ta m + i, (d - ta) n + j] over
// its limb pairs. Phase 1: thread (s, e), e fastest, so that a warp reads
// consecutive elements of one limb-pair tile, copies the limb pairs of
// diagonals s and ND - 1 - s of element e (at most ND + 1) into its own
// slots of shared memory with cp.async, all in flight at once (one round
// trip to memory; loads into registers were consumed, and waited on, one
// by one as ptxas scheduled them), then sums each diagonal in int32 (exact
// in any order) into D[d][e]. Phase 2: thread e folds element e from D
// through cascade_fold (csrc/limbs.cuh, the fold limb_gemm_fused runs).
// FROM_DIAGS (pl_cascade): diags [B, ND, m, n]; thread e issues its ND
// coalesced loads, then folds them (through shared memory they took
// longer).
//
// One element a thread in phase 2: at these sizes the fold is a latency
// chain, and two chains interleaved in one thread take as long as one.
template <int NW, bool FROM_C>
__global__ void __launch_bounds__(CASCADE_TILE_MAX * cascade_slices(NW))
    cascade(const int* __restrict__ src, const int* __restrict__ EAB, float* __restrict__ Out,
            int m, int n, int tile) {
  constexpr int L = limb_count(NW);
  constexpr int ND = ndiag_count(NW);
  extern __shared__ int cascade_smem[];
  int* D = cascade_smem;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int mn = m * n;  // < 2^31 (clrs_cascade checks)
  const int e = tid & (tile - 1);
  const int ij = blockIdx.x * tile + e;
  const bool valid = ij < mn;
  const size_t plane = static_cast<size_t>(mn);
  int eab = 0;
  if (tid < tile && valid) eab = __ldg(EAB + b * plane + ij);
  float res[1][NW];
  if constexpr (FROM_C) {
    const int nt = tile * cascade_slices(NW);
    int* stage = D + ND * tile;
    const int d0 = tid / tile, d1 = ND - 1 - d0;
    // diagonal d: pairs ta = lo .. lo + count - 1
    auto lo = [](int d) { return d > L - 1 ? d - (L - 1) : 0; };
    auto count = [&](int d) { return (d < L - 1 ? d : L - 1) - lo(d) + 1; };
    const int c0 = count(d0), c1 = d1 > d0 ? count(d1) : 0;
    if (valid) {
      // 32-bit offsets within member b of C (clrs_cascade checks that they
      // fit): limb pair (ta, tb) of element (i, j) at ta m ldc + tb n + i ldc + j
      const int i = ij / n, j = ij - i * n;
      const int ldc = L * n, step = m * ldc - n;  // (ta, tb) -> (ta + 1, tb - 1)
      const int* Cb = src + b * (static_cast<size_t>(L) * m * ldc);
      auto first = [&](int d) { return lo(d) * m * ldc + (d - lo(d)) * n + i * ldc + j; };
      const int o0 = first(d0), jump = first(d1) - o0 - c0 * step;
#pragma unroll
      for (int k = 0; k < ND + 1; ++k) {  // slots past the pairs are zero-filled
        const bool pair = k < c0 + c1;
        cp_async_zfill<4>(stage + k * nt + tid,
                          Cb + (pair ? o0 + k * step + (k < c0 ? 0 : jump) : o0), pair);
      }
    }
    cp_async_wait_all();
    if (valid) {
      int t0 = 0, t1 = 0;
#pragma unroll
      for (int k = 0; k < ND + 1; ++k) {
        const int x = stage[k * nt + tid];
        if (k < c0) t0 += x; else t1 += x;
      }
      D[d0 * tile + e] = t0;
      if (d1 > d0) D[d1 * tile + e] = t1;
    }
    __syncthreads();
    if (tid >= tile || !valid) return;
    cascade_fold<NW, 1>([&](int d, int) { return D[d * tile + tid]; }, &eab, res);
  } else {
    if (!valid) return;
    const int* Dp = src + b * (ND * plane) + ij;
    int dv[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) dv[d] = __ldg(Dp + d * plane);
    cascade_fold<NW, 1>([&](int d, int) { return dv[d]; }, &eab, res);
  }
  float* ob = Out + b * (NW * plane) + ij;
#pragma unroll
  for (int w = 0; w < NW; ++w) ob[w * plane] = res[0][w];
}

// ---------------------------------------------------------------------------
// the three pl_map chains of the IPM step
// ---------------------------------------------------------------------------

constexpr int PLMAP_THREADS = 64;

// How an operand's words are read over the broadcast [L, D1, D2] shape
// (dd/kernels.py plmap_operand classifies them):
//   OP_GENERAL  each word through its own strides (s0, s1, s2);
//   OP_PLANE    every word with the strides (s0, s1, 1) of word 0: one
//               offset i s1 + j for all words;
//   OP_SCALAR   every word with the strides (s0, 0, 0) of word 0: one value
//               per l (the [L, 1, 1] mu and alpha), one address for the
//               whole block.
// Per-l offsets are 64-bit, offsets within a plane 32-bit (the wrapper
// checks that they fit).
enum : int { OP_GENERAL = 0, OP_PLANE = 1, OP_SCALAR = 2 };

struct Operand {
  const float* w[MAX_NW];
  long long s0[MAX_NW];
  int s1[MAX_NW], s2[MAX_NW];
  int kind;
};

// Words k < N of element (l, i, j) into v.
template <int N>
__device__ __forceinline__ void load_op(const Operand& op, int l, int i, int j, float* v) {
  if (op.kind == OP_GENERAL) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      v[k] = __ldg(op.w[k] + l * op.s0[k] + (i * op.s1[k] + j * op.s2[k]));
  } else {
    const long long o = l * op.s0[0];
    const int off = op.kind == OP_PLANE ? i * op.s1[0] + j : 0;
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = __ldg(op.w[k] + o + off);
  }
}

// One chain over [L, D1, D2] (out [NW, L, D1, D2], contiguous), one element
// a thread. Block (x, y, l) of blockDim (TX, PLMAP_THREADS / TX) covers
// columns x TX .. x TX + TX - 1 and rows y TY .. y TY + TY - 1 of plane l
// (TX from dd/kernels.py plmap_block). All operand loads are issued before
// the chain, whose op sequence is the plain version's:
//   FN 0  X + dX (the corrector sum, step.py:1556-1568), ops (x, d);
//   FN 1  X + alpha dX with alpha as three words padded by alpha0 * 0
//         (step.py:1244-1260), ops (x, d, alpha);
//   FN 2  R = mask (mu I - XY), mu I formed word by word as mu * eye
//         (step.py:1387-1407), ops (mu, mask, xy);
//   FN 3  FN 2 less dX dY, ops (mu, mask, xy, dxdy).
// Two columns a thread, with 8-byte vector loads and stores where aligned,
// measured slower on an H100 (fewer warps, each with two chains).
template <int NW, int FN>
__global__ void __launch_bounds__(PLMAP_THREADS)
    plmap(Operand o0, Operand o1, Operand o2, Operand o3, float* __restrict__ out, int D1,
          int D2) {
  const int l = blockIdx.z;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D1 || j >= D2) return;
  float r[NW];
  if constexpr (FN == 0) {
    float xv[NW], dv[NW];
    load_op<NW>(o0, l, i, j, xv);
    load_op<NW>(o1, l, i, j, dv);
    exp_add<NW>(xv, dv, r);
  } else if constexpr (FN == 1) {
    float xv[NW], dv[NW], av[NW], p[NW];
    load_op<NW>(o0, l, i, j, xv);
    load_op<NW>(o1, l, i, j, dv);
    load_op<3>(o2, l, i, j, av);
    const float z = fmul(av[0], 0.0f);
#pragma unroll
    for (int k = 3; k < NW; ++k) av[k] = z;
    exp_mul<NW>(dv, av, p);
    exp_add<NW>(xv, p, r);
  } else {
    float mv[NW], mk, xv[NW], dv[NW];
    load_op<NW>(o0, l, i, j, mv);
    load_op<1>(o1, l, i, j, &mk);
    load_op<NW>(o2, l, i, j, xv);
    if constexpr (FN == 3) load_op<NW>(o3, l, i, j, dv);
    const float eye = i == j ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < NW; ++k) mv[k] = fmul(mv[k], eye);
    exp_sub<NW>(mv, xv, r);
    if constexpr (FN == 3) {
      float r2[NW];
      exp_sub<NW>(r, dv, r2);
#pragma unroll
      for (int k = 0; k < NW; ++k) r[k] = r2[k];
    }
#pragma unroll
    for (int k = 0; k < NW; ++k) r[k] = fmul(r[k], mk);
  }
  const size_t ws = static_cast<size_t>(gridDim.z) * D1 * D2;  // word stride of out
  float* ob = out + static_cast<size_t>(l) * D1 * D2 + (i * D2 + j);
#pragma unroll
  for (int k = 0; k < NW; ++k) ob[k * ws] = r[k];
}

// ---------------------------------------------------------------------------
// batched triangular solves with the lower factor
// ---------------------------------------------------------------------------

constexpr int TRI_THREADS = 256;
constexpr int TRI_MAX_TC = 4;  // columns of X per block at most

// 4-byte asynchronous copy from global to shared memory (cp.async): the
// loads of a staging loop are all in flight at once and pass no register.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Start of column i in the column-packed lower triangle: L[r, i] for
// r = i..n-1 is at packed_col(n, i) + r - i.
__host__ __device__ __forceinline__ int packed_col(int n, int i) { return i * n - i * (i - 1) / 2; }

// Shared memory of one block, in 4-byte units: dinv [NW][n]; the column
// tile [NW][n][tc] (W, then X, in the forward form; X in the transposed
// one); transposed only: B's tile [NW][n][tc], the tree [NW][2n-1][tc] and
// the schedule (nsched ints); L packed [NW][n(n+1)/2] when l_smem.
struct TriLayout {
  size_t tile, btile, tree, sched, lpack, bytes;
};

__host__ __device__ inline TriLayout tri_layout(int nw, int n, int tc, bool trans, bool l_smem,
                                                int nsched) {
  TriLayout t;
  const size_t col = static_cast<size_t>(nw) * n * tc;
  t.tile = static_cast<size_t>(nw) * n;
  t.btile = t.tile + col;
  t.tree = t.btile + (trans ? col : 0);
  t.sched = t.tree + (trans ? static_cast<size_t>(nw) * (2 * n - 1) * tc : 0);
  t.lpack = t.sched + (trans ? nsched : 0);
  const size_t end = t.lpack + (l_smem ? static_cast<size_t>(nw) * n * (n + 1) / 2 : 0);
  t.bytes = end * sizeof(float);
  return t;
}

// Block (b, y) solves columns [y tc, y tc + tcols) of batch member b.
// L[b] [NW][n][n], B[b] and X[b] [NW][n][m]. sched: the transposed form's
// tree, H + 1 node offsets per height, then (left, right, out) per node, in
// the schedule's order; the last node is the root. With l_smem = 0 L is
// read from global memory (its triangle does not fit beside the tile).
template <int NW, bool TRANS>
__global__ void __launch_bounds__(TRI_THREADS)
    tri_solve_batched(const float* __restrict__ Lm, const float* __restrict__ Bm,
                      float* __restrict__ X, const int* __restrict__ sched, int n, int m, int tc,
                      int H, int l_smem) {
  extern __shared__ float smem[];
  const int nsched = TRANS ? H + 1 + 3 * (n - 1) : 0;
  const TriLayout lay = tri_layout(NW, n, tc, TRANS, l_smem, nsched);
  const size_t nn = static_cast<size_t>(n) * n, nm = static_cast<size_t>(n) * m;
  const int P = n * (n + 1) / 2;
  const int nodes = 2 * n - 1;
  const int b = blockIdx.x, c0 = blockIdx.y * tc;
  const int tcols = min(tc, m - c0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nt / 32;
  const float* Lb = Lm + static_cast<size_t>(b) * NW * nn;
  const float* Bb = Bm + static_cast<size_t>(b) * NW * nm + c0;
  float* Xb = X + static_cast<size_t>(b) * NW * nm + c0;
  float* dinv = smem;
  float* T = smem + lay.tile;
  float* Bt = smem + lay.btile;
  float* tree = smem + lay.tree;
  int* sch = reinterpret_cast<int*>(smem + lay.sched);
  float* Lp = smem + lay.lpack;

  // staging, all in flight at once: one warp per row of L (its lower part,
  // coalesced), one thread per row of the B tile, the schedule; the
  // transposed form's X and tree start at +0 (leaves of rows r <= i are +0
  // in the source's masked product, and no row writes them before it is
  // solved). Meanwhile dinv from the diagonal, read from global memory.
  if (l_smem) {
    for (int q = warp; q < NW * n; q += nwarps) {
      const int w = q / n, r = q - w * n;
      for (int c = lane; c <= r; c += 32)
        cp_async4(Lp + w * P + packed_col(n, c) + r - c, Lb + w * nn + static_cast<size_t>(r) * n + c);
    }
  }
  float* bdst = TRANS ? Bt : T;
  for (int q = tid; q < NW * n; q += nt) {
    const int w = q / n, r = q - w * n;
    for (int j = 0; j < tcols; ++j)
      cp_async4(bdst + static_cast<size_t>(q) * tc + j, Bb + w * nm + static_cast<size_t>(r) * m + j);
  }
  if constexpr (TRANS) {
    for (int q = tid; q < nsched; q += nt) cp_async4(sch + q, sched + q);
    for (size_t q = tid; q < static_cast<size_t>(NW) * n * tc; q += nt) T[q] = 0.0f;
    for (size_t q = tid; q < static_cast<size_t>(NW) * nodes * tc; q += nt) tree[q] = 0.0f;
  }
  for (int r = tid; r < n; r += nt) {
    float one[NW], dg[NW], dv[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      one[w] = w == 0 ? 1.0f : 0.0f;
      dg[w] = Lb[w * nn + static_cast<size_t>(r) * n + r];
    }
    exp_div<NW>(one, dg, dv);
#pragma unroll
    for (int w = 0; w < NW; ++w) dinv[w * n + r] = dv[w];
  }
  cp_async_wait_all();
  __syncthreads();

  // L[r, i], word w, is col[w * lw + r * ls] with col the start of column i
  const size_t lw = l_smem ? P : nn;
  const int ls = l_smem ? 1 : n;
  auto column = [&](int i) -> const float* {
    return l_smem ? Lp + packed_col(n, i) - i : Lb + i;
  };
  // t / tcols without a division: exact for t < 2^13, and t < n tc <=
  // TRI_THREADS whenever tc > 1
  const unsigned magic = 65536u / tcols + 1u;
  auto div_tc = [&](int t) { return tcols == 1 ? t : static_cast<int>((t * magic) >> 16); };

  // word w of row r, column j of a [NW][rows][tc] tile
  auto at = [&](float* base, int rows, int w, int r, int j) -> float& {
    return base[(static_cast<size_t>(w) * rows + r) * tc + j];
  };

  if constexpr (!TRANS) {
    // T holds W, the right-hand sides updated in place; row i becomes x_i
    if (tid < tcols) {
      float rhs[NW], di[NW], xi[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        rhs[w] = at(T, n, w, 0, tid);
        di[w] = dinv[w * n];
      }
      exp_mul<NW>(rhs, di, xi);
#pragma unroll
      for (int w = 0; w < NW; ++w) at(T, n, w, 0, tid) = xi[w];
    }
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i + 1 < n; ++i) {
      const float* col = column(i);
      for (int t = tid; t < (n - 1 - i) * tcols; t += nt) {
        const int q = div_tc(t), r = i + 1 + q, j = t - q * tcols;
        float lv[NW], xi[NW], a[NW], u[NW], o[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          lv[w] = col[w * lw + static_cast<size_t>(r) * ls];
          xi[w] = at(T, n, w, i, j);
          a[w] = at(T, n, w, r, j);
        }
        exp_mul<NW>(lv, xi, u);
        exp_sub<NW>(a, u, o);
        if (r == i + 1) {  // row i + 1 is final: x_{i+1} = W_{i+1} dinv_{i+1}
          float di[NW];
#pragma unroll
          for (int w = 0; w < NW; ++w) di[w] = dinv[w * n + r];
          exp_mul<NW>(o, di, u);
#pragma unroll
          for (int w = 0; w < NW; ++w) o[w] = u[w];
        }
#pragma unroll
        for (int w = 0; w < NW; ++w) at(T, n, w, r, j) = o[w];
      }
      __syncthreads();
    }
  } else {
    const int* off = sch;
    const int* lro = sch + H + 1;
    const int root = H > 0 ? lro[3 * (n - 2) + 2] : 0;
#pragma unroll 1
    for (int i = n - 1; i >= 0; --i) {
      const float* col = column(i);
      for (int t = tid; t < (n - 1 - i) * tcols; t += nt) {  // leaves r > i
        const int q = div_tc(t), r = i + 1 + q, j = t - q * tcols;
        float lv[NW], xv[NW], p[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          lv[w] = col[w * lw + static_cast<size_t>(r) * ls];
          xv[w] = at(T, n, w, r, j);
        }
        exp_mul<NW>(lv, xv, p);
#pragma unroll
        for (int w = 0; w < NW; ++w) at(tree, nodes, w, r, j) = p[w];
      }
      __syncthreads();
#pragma unroll 1
      for (int h = 0; h < H; ++h) {  // one height of the tree per barrier
        const int k0 = off[h];
        for (int t = tid; t < (off[h + 1] - k0) * tcols; t += nt) {
          const int q = div_tc(t), k = k0 + q, j = t - q * tcols;
          const int ka = lro[3 * k], kb = lro[3 * k + 1], ko = lro[3 * k + 2];
          float x[NW], y[NW], s[NW];
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            x[w] = at(tree, nodes, w, ka, j);
            y[w] = at(tree, nodes, w, kb, j);
          }
          exp_add<NW>(x, y, s);
#pragma unroll
          for (int w = 0; w < NW; ++w) at(tree, nodes, w, ko, j) = s[w];
        }
        __syncthreads();
      }
      if (tid < tcols) {
        float bi[NW], s[NW], rhs[NW], di[NW], xi[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          bi[w] = at(Bt, n, w, i, tid);
          s[w] = at(tree, nodes, w, root, tid);
          di[w] = dinv[w * n + i];
        }
        exp_sub<NW>(bi, s, rhs);
        exp_mul<NW>(rhs, di, xi);
#pragma unroll
        for (int w = 0; w < NW; ++w) at(T, n, w, i, tid) = xi[w];
      }
      __syncthreads();
    }
  }

  for (int q = tid; q < NW * n; q += nt) {
    const int w = q / n, r = q - w * n;
    for (int j = 0; j < tcols; ++j)
      Xb[w * nm + static_cast<size_t>(r) * m + j] = T[static_cast<size_t>(q) * tc + j];
  }
}

// The extraction's tile: CQ columns across (at least 8, a sector of a word
// row, where the rows are that long; no more than the row has; on side a
// wider until at most EX_MAX_SPLIT tiles share a row), RT = EX_THREADS /
// CQ rows; then repeats along the reduction axis, so that at most
// EX_MAX_SPLIT tiles read one row (side a) or column (side b).
inline int pow2_at_least(long v, int cap) {
  int p = 1;
  while (p < v && p < cap) p *= 2;
  return p;
}

template <int NW>
int launch_extract(const WordPtrs& w, int8_t* limbs, int* exps, int B, int d0, int d1,
                   int side_a, int b_gemm, int L, cudaStream_t s) {
  const int cq_max = pow2_at_least(d1, EX_THREADS);
  const int cq_min = EX_THREADS / pow2_at_least(d0, EX_THREADS);
  const int cq_lo = cq_min > 8 ? cq_min : 8;
  int cq = cq_min > cq_max ? cq_max : (cq_lo < cq_max ? cq_lo : cq_max);
  while (side_a && cq < cq_max && ceil_div(d1, cq) > EX_MAX_SPLIT) cq *= 2;
  long rtiles = ceil_div(d0, EX_THREADS / cq), ctiles = ceil_div(d1, cq);
  int rpt = 1, cpt = 1;
  if (side_a) {
    cpt = static_cast<int>(ceil_div(ctiles, EX_MAX_SPLIT));
    ctiles = ceil_div(ctiles, cpt);
  } else {
    rpt = static_cast<int>(ceil_div(rtiles, EX_MAX_SPLIT));
    rtiles = ceil_div(rtiles, rpt);
  }
  if (rtiles > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ctiles), static_cast<unsigned>(rtiles), B);
  limb_extract<NW><<<grid, EX_THREADS, 0, s>>>(w, limbs, exps, d0, d1, side_a, b_gemm, cq, rpt,
                                                cpt, L);
  return 0;
}

// tile: output elements a block (dd/kernels.py cascade_tile), a power of
// two in 8..CASCADE_TILE_MAX.
template <int NW>
int launch_cascade(const int* src, const int* eab, float* out, int B, int m, int n, int from_c,
                   int tile, cudaStream_t s) {
  static unsigned long long opted = 0;
  const dim3 grid(static_cast<unsigned>(ceil_div(static_cast<long>(m) * n, tile)), B);
  if (!from_c) {
    cascade<NW, false><<<grid, tile, 0, s>>>(src, eab, out, m, n, tile);
    return 0;
  }
  int dev = 0;
  cudaGetDevice(&dev);
  const cudaError_t e = smem_opt_in(cascade<NW, true>, opted, dev);
  if (e == cudaSuccess)
    cascade<NW, true><<<grid, tile * cascade_slices(NW), sizeof(int) * cascade_smem_ints(NW, tile),
                        s>>>(src, eab, out, m, n, tile);
  return static_cast<int>(e);
}

// fn: 0 add (x, d), 1 axpy (x, d, a), 2 residual (mu, mask, xy),
// 3 residual with the corrector term (mu, mask, xy, dxdy); tx: threads of a
// block along j (dd/kernels.py plmap_block).
template <int NW>
int launch_plmap(int fn, const Operand* ops, float* out, int L, int D1, int D2, int tx,
                 cudaStream_t s) {
  const int ty = PLMAP_THREADS / tx;
  const long gy = ceil_div(D1, ty);
  if (gy > 65535 || L > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(ceil_div(D2, tx)), static_cast<unsigned>(gy), L);
  const dim3 block(tx, ty);
  switch (fn) {
    case 0:
      plmap<NW, 0><<<grid, block, 0, s>>>(ops[0], ops[1], ops[2], ops[3], out, D1, D2);
      break;
    case 1:
      plmap<NW, 1><<<grid, block, 0, s>>>(ops[0], ops[1], ops[2], ops[3], out, D1, D2);
      break;
    case 2:
      plmap<NW, 2><<<grid, block, 0, s>>>(ops[0], ops[1], ops[2], ops[3], out, D1, D2);
      break;
    case 3:
      plmap<NW, 3><<<grid, block, 0, s>>>(ops[0], ops[1], ops[2], ops[3], out, D1, D2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Column tile: enough (batch, tile) blocks to cover the SMs, at most
// TRI_MAX_TC columns and one thread per (row, column); it shrinks
// while L's packed triangle does not fit beside it, and L stays in global
// memory only where even one column does not leave room for it.
template <int NW>
int launch_tri(const float* l, const float* b, float* x, const int* sched, int H, int B, int n,
               int m, int trans, cudaStream_t s) {
  static unsigned long long opted[2] = {0, 0};
  int dev = 0;
  cudaGetDevice(&dev);
  const int nsched = trans ? H + 1 + 3 * (n - 1) : 0;
  long tc = ceil_div(static_cast<long>(B) * m, sm_count(dev));
  tc = tc < 1 ? 1 : tc;
  const long cap = TRI_THREADS / n < 1 ? 1 : TRI_THREADS / n;
  tc = tc > TRI_MAX_TC ? TRI_MAX_TC : tc;
  tc = tc > cap ? cap : tc;
  tc = tc > m ? m : tc;
  while (tc > 1 && tri_layout(NW, n, tc, trans, true, nsched).bytes > SMEM_MAX) --tc;
  const bool l_smem = tri_layout(NW, n, tc, trans, true, nsched).bytes <= SMEM_MAX;
  const size_t bytes = tri_layout(NW, n, tc, trans, l_smem, nsched).bytes;
  if (bytes > SMEM_MAX || ceil_div(m, tc) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = TRI_THREADS;  // the staging and dinv use them all
  const dim3 grid(B, static_cast<unsigned>(ceil_div(m, tc)));
  cudaError_t e;
  if (trans) {
    e = smem_opt_in(tri_solve_batched<NW, true>, opted[1], dev);
    if (e == cudaSuccess)
      tri_solve_batched<NW, true><<<grid, threads, bytes, s>>>(l, b, x, sched, n, m, tc, H,
                                                                l_smem);
  } else {
    e = smem_opt_in(tri_solve_batched<NW, false>, opted[0], dev);
    if (e == cudaSuccess)
      tri_solve_batched<NW, false><<<grid, threads, bytes, s>>>(l, b, x, sched, n, m, tc, H,
                                                                 l_smem);
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

const char* clrs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// words: nw (1..8) pointers to the word tensors [B, d0, d1] and strides:
// their [nw][3] element strides (host arrays); L: the limbs of each element
// (1..48: the int32 diagonal sums of a product stay exact to 48).
int clrs_limb_extract(const void* const* words, const long long* strides, int8_t* limbs,
                      int* exps, int B, int nw, int L, int d0, int d1, int side_a, int b_gemm,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || d0 <= 0 || d1 <= 0 || nw > MAX_NW || L < 1 || L > 48 || (b_gemm && side_a))
    return static_cast<int>(cudaErrorInvalidValue);
  WordPtrs w{};
  for (int k = 0; k < nw; ++k) {
    w.w[k] = static_cast<const float*>(words[k]);
    for (int a = 0; a < 3; ++a) w.s[k][a] = strides[3 * k + a];
  }
  CLRS_DISPATCH_NW_OPERAND(nw, {
    const int rc = launch_extract<NWc>(w, limbs, exps, B, d0, d1, side_a, b_gemm, L, s);
    if (rc != 0) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}

// tile: output elements a block (dd/kernels.py cascade_tile); nw 2 or 5..8.
// Offsets within a member of C are 32-bit: (L + 1) L m n < 2^31.
int clrs_cascade(const int* src, const int* eab, float* out, int B, int m, int n, int nw,
                 int from_c, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long limbs = limb_count(nw);
  if (B <= 0 || m <= 0 || n <= 0 || B > 65535 || nw < 2 || nw > MAX_NW ||
      (limbs + 1) * limbs * m * n >= (1L << 31) || tile < 8 || tile > CASCADE_TILE_MAX ||
      (tile & (tile - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CLRS_DISPATCH_NW_PRODUCT(nw, launch_cascade<NWc>(src, eab, out, B, m, n, from_c, tile, s));
  return static_cast<int>(cudaGetLastError());
}

// ptrs: [4][MAX_NW] word pointers, strides: [4][MAX_NW][3] element strides
// and kinds: [4] OP_* of the operands in launch_plmap's order (host arrays;
// dd/kernels.py plmap_operand). tx: 8, 16 or 32.
int clrs_plmap(int fn, const void* const* ptrs, const long long* strides, const int* kinds,
               float* out, int L, int D1, int D2, int nw, int tx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fn < 0 || fn > 3 || L <= 0 || D1 <= 0 || D2 <= 0 || (tx != 8 && tx != 16 && tx != 32) ||
      static_cast<long>(D1) * D2 >= (1L << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Operand ops[4];
  for (int k = 0; k < 4; ++k) {
    if (kinds[k] < OP_GENERAL || kinds[k] > OP_SCALAR) return static_cast<int>(cudaErrorInvalidValue);
    ops[k].kind = kinds[k];
    for (int w = 0; w < MAX_NW; ++w) {
      const long long* st = strides + (k * MAX_NW + w) * 3;
      // offsets within a plane must fit in 32 bits
      if (st[1] < 0 || st[2] < 0 || (D1 - 1) * st[1] + (D2 - 1) * st[2] >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
      ops[k].w[w] = static_cast<const float*>(ptrs[k * MAX_NW + w]);
      ops[k].s0[w] = st[0];
      ops[k].s1[w] = static_cast<int>(st[1]);
      ops[k].s2[w] = static_cast<int>(st[2]);
    }
  }
  CLRS_DISPATCH_NW(nw, launch_plmap<NWc>(fn, ops, out, L, D1, D2, tx, s));
  return static_cast<int>(cudaGetLastError());
}

// sched, H: the transposed form's tree schedule (see tri_solve_batched);
// unused by the forward form.
int clrs_tri_solve(const float* l, const float* b, float* x, const int* sched, int H, int B,
                   int n, int m, int nw, int trans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n <= 0 || m <= 0 || (trans && (sched == nullptr || H < 0 || H >= n)))
    return static_cast<int>(cudaErrorInvalidValue);
  CLRS_DISPATCH_NW(nw, {
    const int rc = launch_tri<NWc>(l, b, x, sched, H, B, n, m, trans, s);
    if (rc != 0) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
