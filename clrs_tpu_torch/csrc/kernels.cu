// The CUDA kernels of the f32-expansion IPM (sm_90a), with a plain C
// interface loaded by clrs_tpu_torch/dd/build.py through ctypes.
//
// Each C entry launches on the caller's stream, synchronises nothing,
// allocates nothing and returns cudaGetLastError(). Word counts NW = 5..8
// are instantiated (the f32 substrate's ladder); other values return
// cudaErrorInvalidValue. Tensors are stacked word-major: [B, NW, rows, cols].
//
// limb_extract_{exp,limbs}  replaces clrs_tpu/dd/pallas_linalg.py
//   _extract_call / pl_extract (all four layouts: 'a3'/'b3'/'a' limb-major,
//   'b' as the [d0, L d1] GEMM operand). Bound by its elementwise
//   work: L rounds of an (NW)-word vec_sum per element. One thread per
//   element keeps the words in registers; the per-row/column exponent is a
//   separate small reduction kernel.
// limb_gemm_fused           replaces _limb_gemm_fused_call / pl_limb_gemm_fused.
//   Bound by the int8 products (sum over kept diagonals of pairs x m n k)
//   and then the per-element cascade. 16x16 output tiles per block; all L
//   limbs of a 32-deep k chunk of A rows and B columns staged in shared
//   memory; every diagonal's int32 sum accumulates exactly in registers with
//   __dp4a; the cascade runs per output element in registers. Ragged m/n/k
//   edges are masked, not padded.
// int8_gemm                 the split route's int8 product C = A B, the XLA
//   dot_general of clrs_tpu/dd/limb_gemm.py:307 (not a Pallas kernel there).
//   Bound by its int8 operations at these sizes; __dp4a on 64x64 tiles, a
//   simple first version (no tensor cores).
// cascade<FROM_C>           replaces _cascade_tiles_call / pl_cascade_tiles
//   and _cascade_tiles_grid_call / pl_cascade_tiles_grid: the diagonal sums
//   of C and the cascade. Bound by reading the kept limb-pair tiles of C.
//   One thread per output element on a 2-D grid with bounds checks: any
//   m, n, no padding, no VMEM staging to carry over.
// cascade<FROM_DIAGS>       replaces _cascade_call / pl_cascade (no caller in
//   either package); same fold from precomputed diagonal sums.
// plmap_{add,axpy,residual} replace pl_map at its three call sites in
//   clrs_tpu/solver/step.py: one thread per element, all words in registers,
//   broadcast operands read through per-word strides. Bound by the bytes of
//   the words they read and write.
// chol_batched              replaces _chol_call / pl_cholesky_b.
//   Bound by the column-sequential recurrence: n dependent pivots, each an
//   exp_rsqrt on one thread, then an (n-j)^2 update. One block per batch
//   matrix with the matrix words in dynamic shared memory when they fit
//   (the global output buffer otherwise); the update reads column j AND
//   row j of the trailing matrix, as the source does.
// tri_solve_batched<TRANS>  replaces _tril_call and _tril_t_call
//   (pl_solve_tril_b / pl_solve_tril_t_b). Bound by the n dependent rows.
//   One block per batch matrix; dinv = 1/diag once by n threads. The forward
//   form is right-looking, parallel over the trailing (row, column) pairs;
//   the transposed form rebuilds each row per column with the same
//   recursive halving tree as _exp_sum_axis0, evaluated with an explicit
//   stack (no device recursion).

#include <cuda_runtime.h>

#include <cstdint>

#include "expansion.cuh"

using namespace clrs;

namespace {

constexpr int LIMB_BITS = 7;

__host__ __device__ constexpr int limb_count(int nw) {
  return (24 * nw + 21 + LIMB_BITS - 1) / LIMB_BITS;
}
__host__ __device__ constexpr int ndiag_count(int nw) {
  return (2 * limb_count(nw) - 1) < ((24 * nw + 21) / LIMB_BITS + 1)
             ? (2 * limb_count(nw) - 1)
             : ((24 * nw + 21) / LIMB_BITS + 1);
}

// ---------------------------------------------------------------------------
// limb extraction
// ---------------------------------------------------------------------------

// Per row (side a) or per column (side b) of word 0: e with
// |word0| * 2^-e <= 1/2, from the bits of max|word0| (1 where it is 0).
__global__ void limb_extract_exp(const float* __restrict__ W, int* __restrict__ E,
                                 int B, int nw, int d0, int d1, int side_a) {
  const int rows = side_a ? d0 : d1;
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long>(B) * rows) return;
  const int b = static_cast<int>(t / rows);
  const int r = static_cast<int>(t % rows);
  const float* w0 = W + static_cast<size_t>(b) * nw * d0 * d1;
  float mag = 0.0f;
  if (side_a) {
    for (int j = 0; j < d1; ++j) mag = fmaxf(mag, fabsf(w0[static_cast<size_t>(r) * d1 + j]));
  } else {
    for (int i = 0; i < d0; ++i) mag = fmaxf(mag, fabsf(w0[static_cast<size_t>(i) * d1 + r]));
  }
  if (mag == 0.0f) mag = 1.0f;
  E[t] = static_cast<int>((__float_as_uint(mag) >> 23) & 0xFFu) - 125;
}

// Limbs of batch b go limb-major, [L, d0, d1] (the 'a3'/'b3' layouts, and
// 'a' [L d0, d1], which is the same memory), or with b_gemm as the 'b' GEMM
// operand [d0, L d1] (limb t of element (i, j) at column t d1 + j).
template <int NW>
__global__ void limb_extract_limbs(const float* __restrict__ W, const int* __restrict__ E,
                                   int8_t* __restrict__ limbs, int B, int d0, int d1,
                                   int side_a, int b_gemm) {
  constexpr int L = limb_count(NW);
  const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long per = static_cast<long>(d0) * d1;
  if (t >= B * per) return;
  const int b = static_cast<int>(t / per);
  const long ij = t % per;
  const int i = static_cast<int>(ij / d1);
  const int j = static_cast<int>(ij % d1);
  const int e = side_a ? E[static_cast<long>(b) * d0 + i] : E[static_cast<long>(b) * d1 + j];
  float ws[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w)
    ws[w] = mul_pow2_word<4>(W[(static_cast<long>(b) * NW + w) * per + ij], -e);
  int8_t* out = limbs + static_cast<long>(b) * L * per +
                (b_gemm ? static_cast<long>(i) * L * d1 + j : ij);
  const long lstride = b_gemm ? d1 : per;
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int w = 0; w < NW; ++w) ws[w] = fmul(ws[w], 128.0f);
    vec_sum<NW>(ws);
    const float d = rintf(ws[0]);  // round half to even
    ws[0] = fsub(ws[0], d);
    out[static_cast<long>(l) * lstride] = static_cast<int8_t>(static_cast<int>(d));
  }
}

// ---------------------------------------------------------------------------
// the diagonal cascade (pallas_linalg.py _cascade_fold / _cascade_out)
// ---------------------------------------------------------------------------

// Folds the int32 diagonal sums diag(d), d = 0..ND-1, most significant
// first, into an (NW+2)-word carry: each sum is split into two exactly-f32
// halves, scaled by 2^(eab - 7(d+2)) and swept in with one vec_sum. Then two
// sweeps and the sequential tail fold give NW words. Shared by every kernel
// that ends in the cascade, so they agree bit for bit by construction.
template <int NW, typename Diag>
__device__ __forceinline__ void cascade_fold(Diag diag, int eab, float* out) {
  constexpr int ND = ndiag_count(NW);
  float acc[NW + 2];
#pragma unroll
  for (int w = 0; w < NW + 2; ++w) acc[w] = 0.0f;
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    const int tile = diag(d);
    const int hi_i = tile >> 15;  // floor shift
    const int lo_i = tile - (hi_i << 15);
    const int sc = eab - LIMB_BITS * (d + 2);
    float cs[NW + 4];
#pragma unroll
    for (int w = 0; w < NW + 2; ++w) cs[w] = acc[w];
    cs[NW + 2] = mul_pow2_word<4>(fmul(__int2float_rn(hi_i), 32768.0f), sc);
    cs[NW + 3] = mul_pow2_word<4>(__int2float_rn(lo_i), sc);
    vec_sum<NW + 4>(cs);
    const float low = fadd(cs[NW + 2], cs[NW + 3]);
#pragma unroll
    for (int w = 0; w < NW + 2; ++w) acc[w] = cs[w];
    acc[NW + 1] = fadd(acc[NW + 1], low);
  }
  vec_sum<NW + 2>(acc);
  vec_sum<NW + 2>(acc);
#pragma unroll
  for (int w = 0; w < NW - 1; ++w) out[w] = acc[w];
  const float last = fadd(acc[NW - 1], acc[NW]);
  out[NW - 1] = fadd(last, acc[NW + 1]);
}

// ---------------------------------------------------------------------------
// fused limb GEMM + diagonal cascade
// ---------------------------------------------------------------------------

constexpr int TM = 16, TN = 16, TK = 32;

template <int NW>
__global__ void __launch_bounds__(TM * TN)
    limb_gemm_fused(const int8_t* __restrict__ A3, const int8_t* __restrict__ B3,
                    const int* __restrict__ EAB, float* __restrict__ Out, int m, int k,
                    int n) {
  constexpr int L = limb_count(NW);
  constexpr int ND = ndiag_count(NW);
  constexpr int KQ = TK / 4;
  __shared__ int As[L * TM * KQ];  // [L][TM][TK] int8, packed 4 per int
  __shared__ int Bs[L * TN * KQ];  // [L][TN][TK] int8 (B transposed)
  int8_t* As8 = reinterpret_cast<int8_t*>(As);
  int8_t* Bs8 = reinterpret_cast<int8_t*>(Bs);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TN + tx;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TM, j0 = blockIdx.x * TN;
  const int8_t* Ab = A3 + static_cast<size_t>(b) * L * m * k;
  const int8_t* Bb = B3 + static_cast<size_t>(b) * L * k * n;

  int D[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) D[d] = 0;

  for (int k0 = 0; k0 < k; k0 += TK) {
    for (int idx = tid; idx < L * TM * TK; idx += TM * TN) {
      const int kk = idx % TK;
      const int r = (idx / TK) % TM;
      const int l = idx / (TK * TM);
      const int gi = i0 + r, gk = k0 + kk;
      As8[idx] = (gi < m && gk < k) ? Ab[(static_cast<size_t>(l) * m + gi) * k + gk] : 0;
    }
    for (int idx = tid; idx < L * TK * TN; idx += TM * TN) {
      const int c = idx % TN;
      const int kk = (idx / TN) % TK;
      const int l = idx / (TN * TK);
      const int gj = j0 + c, gk = k0 + kk;
      Bs8[(l * TN + c) * TK + kk] =
          (gj < n && gk < k) ? Bb[(static_cast<size_t>(l) * k + gk) * n + gj] : 0;
    }
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < KQ; ++q) {
      int a[L], bv[L];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        a[l] = As[(l * TM + ty) * KQ + q];
        bv[l] = Bs[(l * TN + tx) * KQ + q];
      }
#pragma unroll
      for (int ta = 0; ta < L; ++ta) {
#pragma unroll
        for (int tb = 0; tb < L; ++tb) {
          if (ta + tb < ND) D[ta + tb] = __dp4a(a[ta], bv[tb], D[ta + tb]);
        }
      }
    }
    __syncthreads();
  }

  const int i = i0 + ty, j = j0 + tx;
  if (i >= m || j >= n) return;
  const size_t off = (static_cast<size_t>(b) * m + i) * n + j;
  float res[NW];
  cascade_fold<NW>([&](int d) { return D[d]; }, EAB[off], res);
  const size_t plane = static_cast<size_t>(m) * n;
  float* ob = Out + static_cast<size_t>(b) * NW * plane + static_cast<size_t>(i) * n + j;
#pragma unroll
  for (int w = 0; w < NW; ++w) ob[w * plane] = res[w];
}

// ---------------------------------------------------------------------------
// batched int8 GEMM (the split route's product C)
// ---------------------------------------------------------------------------

constexpr int GT = 64, GK = 32, GKQ = GK / 4;

// C[b] = A[b] B[b], int8 [M, K] x [K, N] -> int32 [M, N], exact (limb
// products <= 2^13, K <= 2^13). 64x64 output tiles, 256 threads of 4x4
// outputs each, 32-deep k chunks staged in shared memory packed four int8
// to an int (B transposed), __dp4a on the packed words. Ragged M/N/K edges
// are masked with zeros.
__global__ void __launch_bounds__(256)
    int8_gemm(const int8_t* __restrict__ A, const int8_t* __restrict__ Bm, int* __restrict__ C,
              int M, int K, int N) {
  constexpr int ROW = GKQ + 1;  // ints per shared row (+1 against bank conflicts)
  __shared__ int As[GT * ROW];
  __shared__ int Bs[GT * ROW];
  int8_t* As8 = reinterpret_cast<int8_t*>(As);
  int8_t* Bs8 = reinterpret_cast<int8_t*>(Bs);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.z, i0 = blockIdx.y * GT, j0 = blockIdx.x * GT;
  const int8_t* Ab = A + static_cast<size_t>(b) * M * K;
  const int8_t* Bb = Bm + static_cast<size_t>(b) * K * N;
  int acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

  for (int k0 = 0; k0 < K; k0 += GK) {
    for (int idx = tid; idx < GT * GK; idx += 256) {
      const int r = idx / GK, kk = idx % GK;
      const int gi = i0 + r, gk = k0 + kk;
      As8[r * ROW * 4 + kk] = (gi < M && gk < K) ? Ab[static_cast<size_t>(gi) * K + gk] : 0;
    }
    for (int idx = tid; idx < GT * GK; idx += 256) {
      const int c = idx % GT, kk = idx / GT;
      const int gj = j0 + c, gk = k0 + kk;
      Bs8[c * ROW * 4 + kk] = (gj < N && gk < K) ? Bb[static_cast<size_t>(gk) * N + gj] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < GKQ; ++q) {
      int a[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[(ty + 16 * r) * ROW + q];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * ROW + q];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(a[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }
  int* Cb = C + static_cast<size_t>(b) * M * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (i < M && j < N) Cb[static_cast<size_t>(i) * N + j] = acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// the cascade from a finished int8 product C, or from precomputed diagonals
// ---------------------------------------------------------------------------

constexpr int CX = 32, CY = 8;

// One thread per output element (i, j) of batch b, the NW + 2 carry words in
// registers. FROM_C: C [B, L m, L n] int32 with limb-major row and column
// blocks; diagonal d sums C[ta m + i, (d - ta) n + j] over the limb pairs of
// d (pl_cascade_tiles and pl_cascade_tiles_grid, which differ only in how
// the TPU stages C through VMEM). FROM_DIAGS: diags [B, ND, m, n]
// (pl_cascade). eab [B, m, n]; out [B, NW, m, n].
template <int NW, bool FROM_C>
__global__ void __launch_bounds__(CX * CY)
    cascade(const int* __restrict__ src, const int* __restrict__ EAB, float* __restrict__ Out,
            int m, int n) {
  constexpr int L = limb_count(NW);
  constexpr int ND = ndiag_count(NW);
  const int b = blockIdx.z;
  const int i = blockIdx.y * CY + threadIdx.y, j = blockIdx.x * CX + threadIdx.x;
  if (i >= m || j >= n) return;
  const size_t plane = static_cast<size_t>(m) * n;
  const size_t ij = static_cast<size_t>(i) * n + j;
  const int eab = EAB[static_cast<size_t>(b) * plane + ij];
  float res[NW];
  if constexpr (FROM_C) {
    const size_t ldc = static_cast<size_t>(L) * n;
    const int* Cb = src + static_cast<size_t>(b) * L * m * ldc + static_cast<size_t>(i) * ldc + j;
    cascade_fold<NW>(
        [&](int d) {
          int t = 0;
#pragma unroll
          for (int ta = (d > L - 1 ? d - (L - 1) : 0); ta <= (d < L - 1 ? d : L - 1); ++ta)
            t += Cb[static_cast<size_t>(ta) * m * ldc + static_cast<size_t>(d - ta) * n];
          return t;
        },
        eab, res);
  } else {
    const int* Db = src + static_cast<size_t>(b) * ND * plane + ij;
    cascade_fold<NW>([&](int d) { return Db[d * plane]; }, eab, res);
  }
  float* ob = Out + static_cast<size_t>(b) * NW * plane + ij;
#pragma unroll
  for (int w = 0; w < NW; ++w) ob[w * plane] = res[w];
}

// ---------------------------------------------------------------------------
// the three pl_map chains of the IPM step
// ---------------------------------------------------------------------------

constexpr int MAX_NW = 8;

// One operand of a chain: a word pointer per word, each with its own element
// strides over the broadcast [L, D1, D2] shape (0 on a broadcast axis), so a
// [L, 1, 1] scalar or a batch-broadcast matrix is read by index, never
// materialized.
struct Words {
  const float* w[MAX_NW];
  long long s[MAX_NW][3];
};

template <int N>
__device__ __forceinline__ void load_words(const Words& op, long long l, long long i,
                                           long long j, float* v) {
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = op.w[k][l * op.s[k][0] + i * op.s[k][1] + j * op.s[k][2]];
}

struct Elem {
  long long t, l, i, j;
};

__device__ __forceinline__ bool elem_of(long long total, int D1, int D2, Elem& e) {
  e.t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e.t >= total) return false;
  const long long per = static_cast<long long>(D1) * D2;
  e.l = e.t / per;
  const long long ij = e.t % per;
  e.i = ij / D2;
  e.j = ij % D2;
  return true;
}

// X + dX (the corrector sum, step.py:1556-1568).
template <int NW>
__global__ void plmap_add(Words x, Words d, float* __restrict__ out, int L, int D1, int D2) {
  const long long total = static_cast<long long>(L) * D1 * D2;
  Elem e;
  if (!elem_of(total, D1, D2, e)) return;
  float xv[NW], dv[NW], r[NW];
  load_words<NW>(x, e.l, e.i, e.j, xv);
  load_words<NW>(d, e.l, e.i, e.j, dv);
  exp_add<NW>(xv, dv, r);
#pragma unroll
  for (int k = 0; k < NW; ++k) out[k * total + e.t] = r[k];
}

// X + alpha dX with alpha as three words padded by alpha0 * 0
// (step.py:1244-1260).
template <int NW>
__global__ void plmap_axpy(Words x, Words d, Words a, float* __restrict__ out, int L, int D1,
                           int D2) {
  const long long total = static_cast<long long>(L) * D1 * D2;
  Elem e;
  if (!elem_of(total, D1, D2, e)) return;
  float xv[NW], dv[NW], av[NW], p[NW], r[NW];
  load_words<NW>(x, e.l, e.i, e.j, xv);
  load_words<NW>(d, e.l, e.i, e.j, dv);
  load_words<3>(a, e.l, e.i, e.j, av);
  const float z = fmul(av[0], 0.0f);
#pragma unroll
  for (int k = 3; k < NW; ++k) av[k] = z;
  exp_mul<NW>(dv, av, p);
  exp_add<NW>(xv, p, r);
#pragma unroll
  for (int k = 0; k < NW; ++k) out[k * total + e.t] = r[k];
}

// R = mask (mu I - XY [- dX dY]), mu I formed word by word as mu * eye
// (step.py:1387-1407); eye is read from the index, mask is one word.
template <int NW, bool CORR>
__global__ void plmap_residual(Words mu, Words mask, Words xy, Words dxdy,
                               float* __restrict__ out, int L, int D1, int D2) {
  const long long total = static_cast<long long>(L) * D1 * D2;
  Elem e;
  if (!elem_of(total, D1, D2, e)) return;
  float mv[NW], xv[NW], r[NW], mk;
  load_words<NW>(mu, e.l, e.i, e.j, mv);
  load_words<NW>(xy, e.l, e.i, e.j, xv);
  load_words<1>(mask, e.l, e.i, e.j, &mk);
  const float eye = e.i == e.j ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < NW; ++k) mv[k] = fmul(mv[k], eye);
  exp_sub<NW>(mv, xv, r);
  if constexpr (CORR) {
    float dv[NW], r2[NW];
    load_words<NW>(dxdy, e.l, e.i, e.j, dv);
    exp_sub<NW>(r, dv, r2);
#pragma unroll
    for (int k = 0; k < NW; ++k) r[k] = r2[k];
  }
#pragma unroll
  for (int k = 0; k < NW; ++k) out[k * total + e.t] = fmul(r[k], mk);
}

// ---------------------------------------------------------------------------
// batched Cholesky
// ---------------------------------------------------------------------------

template <int NW>
__global__ void chol_batched(const float* __restrict__ A, float* __restrict__ Out,
                             int* __restrict__ ok_out, int n, int use_smem) {
  extern __shared__ float smem[];
  const size_t nn = static_cast<size_t>(n) * n;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* Ab = A + static_cast<size_t>(b) * NW * nn;
  float* Ob = Out + static_cast<size_t>(b) * NW * nn;
  float* W = use_smem ? smem : Ob;                    // [NW][n][n]
  float* coll = use_smem ? smem + NW * nn : smem;     // [NW][n]
  float* rowl = coll + NW * n;                        // [NW][n]
  float* piv = rowl + NW * n;                         // rs[NW], rt[NW]
  __shared__ int ok;

  for (size_t t = tid; t < NW * nn; t += nt) W[t] = Ab[t];
  if (tid == 0) ok = 1;
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    if (tid == 0) {
      float d[NW], rs[NW], rt[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) d[w] = W[w * nn + static_cast<size_t>(j) * n + j];
      const bool pos = d[0] > 0.0f;
      if (!pos) ok = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) d[w] = pos ? d[w] : (w == 0 ? 1.0f : 0.0f);
      exp_rsqrt<NW>(d, rs);
      exp_mul<NW>(d, rs, rt);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        piv[w] = rs[w];
        piv[NW + w] = rt[w];
      }
    }
    __syncthreads();
    for (int i = j + 1 + tid; i < n; i += nt) {
      float rs[NW], cw[NW], rw[NW], o[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        rs[w] = piv[w];
        cw[w] = W[w * nn + static_cast<size_t>(i) * n + j];
        rw[w] = W[w * nn + static_cast<size_t>(j) * n + i];
      }
      exp_mul<NW>(cw, rs, o);
#pragma unroll
      for (int w = 0; w < NW; ++w) coll[w * n + i] = o[w];
      exp_mul<NW>(rw, rs, o);
#pragma unroll
      for (int w = 0; w < NW; ++w) rowl[w * n + i] = o[w];
    }
    __syncthreads();
    const int nt2 = n - j - 1;
    for (int idx = tid; idx < nt2 * nt2; idx += nt) {
      const int i = j + 1 + idx / nt2;
      const int c = j + 1 + idx % nt2;
      float x[NW], y[NW], u[NW], a[NW], r[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        x[w] = coll[w * n + i];
        y[w] = rowl[w * n + c];
        a[w] = W[w * nn + static_cast<size_t>(i) * n + c];
      }
      exp_mul<NW>(x, y, u);
      exp_sub<NW>(a, u, r);
#pragma unroll
      for (int w = 0; w < NW; ++w) W[w * nn + static_cast<size_t>(i) * n + c] = r[w];
    }
    for (int i = j + 1 + tid; i < n; i += nt) {
#pragma unroll
      for (int w = 0; w < NW; ++w) W[w * nn + static_cast<size_t>(i) * n + j] = coll[w * n + i];
    }
    if (tid == 0) {
#pragma unroll
      for (int w = 0; w < NW; ++w) W[w * nn + static_cast<size_t>(j) * n + j] = piv[NW + w];
    }
    __syncthreads();
  }
  for (size_t t = tid; t < NW * nn; t += nt) {
    const size_t ij = t % nn;
    const int i = static_cast<int>(ij / n), c = static_cast<int>(ij % n);
    Ob[t] = i >= c ? W[t] : 0.0f;
  }
  if (tid == 0) ok_out[b] = ok;
}

// ---------------------------------------------------------------------------
// batched triangular solves with the lower factor
// ---------------------------------------------------------------------------

constexpr int MAX_TREE_DEPTH = 24;

// Row i of L^T X = B for column c: sum_r [r > i] L[r,i] X[r,c] with the
// recursive halving order of _exp_sum_axis0 (left half first), evaluated
// iteratively. Rows r <= i contribute exp_mul(0, 0) = +0 words.
template <int NW>
__device__ void tree_row_sum(const float* Lb, const float* Xb, size_t nn, size_t nm, int n,
                             int m, int i, int c, float* out) {
  int lo_s[MAX_TREE_DEPTH], hi_s[MAX_TREE_DEPTH], stage[MAX_TREE_DEPTH];
  float vals[MAX_TREE_DEPTH + 1][NW];
  int sp = 0, vp = 0;
  lo_s[0] = 0;
  hi_s[0] = n;
  stage[0] = 0;
  sp = 1;
  while (sp > 0) {
    const int f = sp - 1;
    const int lo = lo_s[f], hi = hi_s[f];
    if (hi - lo == 1) {
      const int r = lo;
      if (r > i) {
        float lv[NW], xv[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          lv[w] = Lb[w * nn + static_cast<size_t>(r) * n + i];
          xv[w] = Xb[w * nm + static_cast<size_t>(r) * m + c];
        }
        exp_mul<NW>(lv, xv, vals[vp]);
      } else {
#pragma unroll
        for (int w = 0; w < NW; ++w) vals[vp][w] = 0.0f;
      }
      ++vp;
      --sp;
      continue;
    }
    const int mid = lo + (hi - lo) / 2;
    if (stage[f] == 0) {
      stage[f] = 1;
      lo_s[sp] = lo;
      hi_s[sp] = mid;
      stage[sp] = 0;
      ++sp;
    } else if (stage[f] == 1) {
      stage[f] = 2;
      lo_s[sp] = mid;
      hi_s[sp] = hi;
      stage[sp] = 0;
      ++sp;
    } else {
      float s[NW];
      exp_add<NW>(vals[vp - 2], vals[vp - 1], s);
      vp -= 2;
#pragma unroll
      for (int w = 0; w < NW; ++w) vals[vp][w] = s[w];
      ++vp;
      --sp;
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) out[w] = vals[0][w];
}

template <int NW, bool TRANS>
__global__ void tri_solve_batched(const float* __restrict__ Lm, const float* __restrict__ Bm,
                                  float* __restrict__ X, float* __restrict__ Work, int n,
                                  int m) {
  extern __shared__ float dinv[];  // [NW][n]
  const size_t nn = static_cast<size_t>(n) * n, nm = static_cast<size_t>(n) * m;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* Lb = Lm + static_cast<size_t>(b) * NW * nn;
  const float* Bb = Bm + static_cast<size_t>(b) * NW * nm;
  float* Xb = X + static_cast<size_t>(b) * NW * nm;
  float* Wb = Work + static_cast<size_t>(b) * NW * nm;

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
  __syncthreads();

  if constexpr (!TRANS) {
    // Wb holds a copy of B: the right-hand sides updated in place
    for (int i = 0; i < n; ++i) {
      for (int c = tid; c < m; c += nt) {
        float rhs[NW], di[NW], xi[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          rhs[w] = Wb[w * nm + static_cast<size_t>(i) * m + c];
          di[w] = dinv[w * n + i];
        }
        exp_mul<NW>(rhs, di, xi);
#pragma unroll
        for (int w = 0; w < NW; ++w) Xb[w * nm + static_cast<size_t>(i) * m + c] = xi[w];
      }
      __syncthreads();
      const int rows = n - i - 1;
      for (int idx = tid; idx < rows * m; idx += nt) {
        const int r = i + 1 + idx / m;
        const int c = idx % m;
        float lv[NW], xi[NW], u[NW], a[NW], o[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          lv[w] = Lb[w * nn + static_cast<size_t>(r) * n + i];
          xi[w] = Xb[w * nm + static_cast<size_t>(i) * m + c];
          a[w] = Wb[w * nm + static_cast<size_t>(r) * m + c];
        }
        exp_mul<NW>(lv, xi, u);
        exp_sub<NW>(a, u, o);
#pragma unroll
        for (int w = 0; w < NW; ++w) Wb[w * nm + static_cast<size_t>(r) * m + c] = o[w];
      }
      __syncthreads();
    }
  } else {
    // each thread owns whole columns: it reads only rows it solved itself
    for (int c = tid; c < m; c += nt) {
      for (int i = n - 1; i >= 0; --i) {
        float s[NW], bi[NW], rhs[NW], di[NW], xi[NW];
        tree_row_sum<NW>(Lb, Xb, nn, nm, n, m, i, c, s);
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          bi[w] = Bb[w * nm + static_cast<size_t>(i) * m + c];
          di[w] = dinv[w * n + i];
        }
        exp_sub<NW>(bi, s, rhs);
        exp_mul<NW>(rhs, di, xi);
#pragma unroll
        for (int w = 0; w < NW; ++w) Xb[w * nm + static_cast<size_t>(i) * m + c] = xi[w];
      }
    }
  }
}

constexpr int THREADS = 256;
constexpr size_t SMEM_MAX = 227 * 1024;

long ceil_div(long a, long b) { return (a + b - 1) / b; }

template <int NW>
int launch_extract(const float* w, int8_t* limbs, const int* exps, int B, int d0, int d1,
                   int side_a, int b_gemm, cudaStream_t s) {
  const long total = static_cast<long>(B) * d0 * d1;
  limb_extract_limbs<NW><<<ceil_div(total, THREADS), THREADS, 0, s>>>(w, exps, limbs, B, d0,
                                                                      d1, side_a, b_gemm);
  return 0;
}

template <int NW>
int launch_cascade(const int* src, const int* eab, float* out, int B, int m, int n, int from_c,
                   cudaStream_t s) {
  dim3 grid(ceil_div(n, CX), ceil_div(m, CY), B);
  dim3 block(CX, CY);
  if (from_c)
    cascade<NW, true><<<grid, block, 0, s>>>(src, eab, out, m, n);
  else
    cascade<NW, false><<<grid, block, 0, s>>>(src, eab, out, m, n);
  return 0;
}

// fn: 0 add (x, d), 1 axpy (x, d, a), 2 residual (mu, mask, xy),
// 3 residual with the corrector term (mu, mask, xy, dxdy)
template <int NW>
int launch_plmap(int fn, const Words* ops, float* out, int L, int D1, int D2, cudaStream_t s) {
  const long total = static_cast<long>(L) * D1 * D2;
  const long blocks = ceil_div(total, THREADS);
  switch (fn) {
    case 0:
      plmap_add<NW><<<blocks, THREADS, 0, s>>>(ops[0], ops[1], out, L, D1, D2);
      break;
    case 1:
      plmap_axpy<NW><<<blocks, THREADS, 0, s>>>(ops[0], ops[1], ops[2], out, L, D1, D2);
      break;
    case 2:
      plmap_residual<NW, false><<<blocks, THREADS, 0, s>>>(ops[0], ops[1], ops[2], ops[3], out,
                                                           L, D1, D2);
      break;
    case 3:
      plmap_residual<NW, true><<<blocks, THREADS, 0, s>>>(ops[0], ops[1], ops[2], ops[3], out,
                                                          L, D1, D2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <int NW>
int launch_gemm(const int8_t* a3, const int8_t* b3, const int* eab, float* out, int B, int m,
                int k, int n, cudaStream_t s) {
  dim3 grid(ceil_div(n, TN), ceil_div(m, TM), B);
  dim3 block(TN, TM);
  limb_gemm_fused<NW><<<grid, block, 0, s>>>(a3, b3, eab, out, m, k, n);
  return 0;
}

template <int NW>
int launch_chol(const float* a, float* out, int* ok, int B, int n, cudaStream_t s) {
  const size_t whole = (static_cast<size_t>(NW) * n * n + 2 * NW * n + 2 * NW) * sizeof(float);
  const int use_smem = whole <= SMEM_MAX;
  const size_t bytes =
      use_smem ? whole : (static_cast<size_t>(2) * NW * n + 2 * NW) * sizeof(float);
  cudaFuncSetAttribute(chol_batched<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(bytes));
  chol_batched<NW><<<B, THREADS, bytes, s>>>(a, out, ok, n, use_smem);
  return 0;
}

template <int NW>
int launch_tri(const float* l, const float* b, float* x, float* work, int B, int n, int m,
               int trans, cudaStream_t s) {
  const size_t bytes = static_cast<size_t>(NW) * n * sizeof(float);
  if (trans) {
    cudaFuncSetAttribute(tri_solve_batched<NW, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    tri_solve_batched<NW, true><<<B, THREADS, bytes, s>>>(l, b, x, work, n, m);
  } else {
    cudaFuncSetAttribute(tri_solve_batched<NW, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    tri_solve_batched<NW, false><<<B, THREADS, bytes, s>>>(l, b, x, work, n, m);
  }
  return 0;
}

}  // namespace

#define CLRS_DISPATCH_NW(nw, call)               \
  switch (nw) {                                  \
    case 5: { constexpr int NWc = 5; call; } break; \
    case 6: { constexpr int NWc = 6; call; } break; \
    case 7: { constexpr int NWc = 7; call; } break; \
    case 8: { constexpr int NWc = 8; call; } break; \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

extern "C" {

const char* clrs_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

int clrs_limb_extract(const float* w, int8_t* limbs, int* exps, int B, int nw, int d0, int d1,
                      int side_a, int b_gemm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || d0 <= 0 || d1 <= 0 || (b_gemm && side_a))
    return static_cast<int>(cudaErrorInvalidValue);
  const long rows = static_cast<long>(B) * (side_a ? d0 : d1);
  limb_extract_exp<<<ceil_div(rows, THREADS), THREADS, 0, s>>>(w, exps, B, nw, d0, d1, side_a);
  CLRS_DISPATCH_NW(nw, launch_extract<NWc>(w, limbs, exps, B, d0, d1, side_a, b_gemm, s));
  return static_cast<int>(cudaGetLastError());
}

int clrs_int8_gemm(const int8_t* a, const int8_t* b, int* c, int B, int M, int K, int N,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0 || K <= 0 || N <= 0 || B > 65535 || ceil_div(M, GT) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(ceil_div(N, GT), ceil_div(M, GT), B);
  int8_gemm<<<grid, 256, 0, s>>>(a, b, c, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

int clrs_cascade(const int* src, const int* eab, float* out, int B, int m, int n, int nw,
                 int from_c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || m <= 0 || n <= 0 || B > 65535 || ceil_div(m, CY) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CLRS_DISPATCH_NW(nw, launch_cascade<NWc>(src, eab, out, B, m, n, from_c, s));
  return static_cast<int>(cudaGetLastError());
}

// ptrs: [4][MAX_NW] word pointers and strides: [4][MAX_NW][3] element
// strides of the operands in launch_plmap's order (host arrays).
int clrs_plmap(int fn, const void* const* ptrs, const long long* strides, float* out, int L,
               int D1, int D2, int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fn < 0 || fn > 3 || L <= 0 || D1 <= 0 || D2 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Words ops[4];
  for (int k = 0; k < 4; ++k)
    for (int w = 0; w < MAX_NW; ++w) {
      ops[k].w[w] = static_cast<const float*>(ptrs[k * MAX_NW + w]);
      for (int a = 0; a < 3; ++a) ops[k].s[w][a] = strides[(k * MAX_NW + w) * 3 + a];
    }
  CLRS_DISPATCH_NW(nw, launch_plmap<NWc>(fn, ops, out, L, D1, D2, s));
  return static_cast<int>(cudaGetLastError());
}

int clrs_limb_gemm(const int8_t* a3, const int8_t* b3, const int* eab, float* out, int B, int m,
                   int k, int n, int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || m <= 0 || k <= 0 || n <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CLRS_DISPATCH_NW(nw, launch_gemm<NWc>(a3, b3, eab, out, B, m, k, n, s));
  return static_cast<int>(cudaGetLastError());
}

int clrs_chol(const float* a, float* out, int* ok, int B, int n, int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CLRS_DISPATCH_NW(nw, launch_chol<NWc>(a, out, ok, B, n, s));
  return static_cast<int>(cudaGetLastError());
}

int clrs_tri_solve(const float* l, const float* b, float* x, float* work, int B, int n, int m,
                   int nw, int trans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n <= 0 || m <= 0 || n >= (1 << (MAX_TREE_DEPTH - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  CLRS_DISPATCH_NW(nw, launch_tri<NWc>(l, b, x, work, B, n, m, trans, s));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
