// chol_batched: the batched nw-word expansion Cholesky (sm_90a), with a
// plain C interface (clrs_chol) loaded by clrs_tpu_torch/dd/build.py
// through ctypes. Replaces clrs_tpu/dd/pallas_linalg.py _chol_call /
// pl_cholesky_b.
//
// Per pivot j (the plain version, dd/kernels.py chol_plain): d = W[j][j],
// a pivot <= 0 is replaced by 1 (d_safe) and clears the member's ok flag,
// rs = rsqrt(d_safe), rt = d_safe rs; coll[i] = W[i][j] rs and rowl[i] =
// W[j][i] rs for i > j (both triangles: expansion products are not
// symmetric bit for bit); then W[i][c] -= coll[i] rowl[c] for i, c > j.
//
// What bounds it: the chain of dependent pivots. Per pivot the critical
// path is rs_j -> coll_j[j+1], rowl_j[j+1] (two exp_muls) -> their product
// -> the subtraction from W[j+1][j+1] -> exp_rsqrt (about 3,300 operations
// on one thread at nw 5) -> rs_{j+1}. Nothing can shorten it without
// changing the op sequence, so the design keeps everything else off it:
//  - look-ahead: warp 0 owns the chain. While the other warps (the
//    workers) scale column and row j and apply pivot j's update to the
//    trailing matrix, warp 0 already forms d_{j+1} (its two lanes compute
//    coll_j[j+1] and rowl_j[j+1], the same exp_muls the workers compute)
//    and runs pivot j+1's rsqrt. Pivot j+1 needs from pivot j's update only
//    its diagonal element, which the chain computes itself: the rest of
//    row and column j+1 is read by the workers' next scale, after the
//    barrier;
//  - one block barrier per pivot (named barrier 1: the chain has
//    published rs_{j+1} and the workers have finished update j), and a
//    workers-only barrier (named barrier 2) between their scale and their
//    update; the chain never waits for the update of the pivot it is
//    ahead of;
//  - 512 threads, so that the trailing update of a pivot, (n-j-1)^2
//    exp_mul + exp_sub, is spread over 480 worker threads;
//  - the words of W in shared memory with an odd row pitch, so the column
//    reads of the scale hit 32 different banks (n = 64 gave one bank);
//    where W does not fit (nw 8, n 95: 289 KB) it stays in the output
//    buffer in global memory, and only coll, rowl and the pivots are
//    shared;
//  - rt_j and the final column j of L are written by the workers one step
//    later, when the chain no longer reads W[j+1][j].
// Every element still receives a - coll_i rowl_c for each pivot in pivot
// order; look-ahead changes when an update happens, not which one, so the
// factor and the ok flags are bit-identical to the plain version's.

#include <cuda_runtime.h>

#include "common.cuh"
#include "expansion.cuh"

using namespace clrs;

namespace {

constexpr int CHOL_THREADS = 512;
constexpr int CHAIN = 32;  // warp 0

// Named barrier `id` of `count` threads. barrier.sync, not bar.sync (its
// .aligned form): the chain warp's lanes arrive from divergent paths.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Shared memory of one block, in 4-byte units: W [NW][n][pitch] when
// w_smem, then coll [2][NW][n], rowl [2][NW][n] (double-buffered by pivot
// parity), the pivots [2][2 NW] (rs, then d_safe) and the ok flag (all of
// it dynamic: a static __shared__ variable would take from the opt-in).
struct CholLayout {
  size_t coll, rowl, piv, ok, bytes;
};

__host__ __device__ inline CholLayout chol_layout(int nw, int n, int pitch, bool w_smem) {
  CholLayout t;
  t.coll = w_smem ? static_cast<size_t>(nw) * n * pitch : 0;
  t.rowl = t.coll + static_cast<size_t>(2) * nw * n;
  t.piv = t.rowl + static_cast<size_t>(2) * nw * n;
  t.ok = t.piv + 4 * static_cast<size_t>(nw);
  t.bytes = (t.ok + 1) * sizeof(float);
  return t;
}

// The chain's pivot step: d -> d_safe (in place) and rs, into out[0..NW)
// (rs) and out[NW..2NW) (d_safe); a pivot <= 0 clears ok.
template <int NW>
__device__ __forceinline__ void pivot(float* d, float* out, int* ok) {
  const bool pos = d[0] > 0.0f;
  if (!pos) *ok = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) d[w] = pos ? d[w] : (w == 0 ? 1.0f : 0.0f);
  float rs[NW];
  exp_rsqrt<NW>(d, rs);
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    out[w] = rs[w];
    out[NW + w] = d[w];
  }
}

// Block b factors A[b] [NW][n][n] into Out[b] (lower triangle, zeros
// above) and ok_out[b]. W is row-major with row pitch `pitch` in shared
// memory (w_smem), else Out[b] itself (pitch n).
template <int NW>
__global__ void __launch_bounds__(CHOL_THREADS)
    chol_batched(const float* __restrict__ A, float* __restrict__ Out, int* __restrict__ ok_out,
                 int n, int pitch, int w_smem) {
  extern __shared__ float smem[];
  const CholLayout lay = chol_layout(NW, n, pitch, w_smem);
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t plane = static_cast<size_t>(n) * pitch;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31;
  const int nwork = nt - CHAIN, wt = tid - CHAIN;  // worker count and index
  const float* Ab = A + static_cast<size_t>(b) * NW * nn;
  float* Ob = Out + static_cast<size_t>(b) * NW * nn;
  float* W = w_smem ? smem : Ob;
  float* coll = smem + lay.coll;
  float* rowl = smem + lay.rowl;
  float* piv = smem + lay.piv;
  int& ok = *reinterpret_cast<int*>(smem + lay.ok);
  auto at = [&](int w, int i, int c) -> float& {
    return W[w * plane + static_cast<size_t>(i) * pitch + c];
  };

  for (size_t t = tid; t < NW * nn; t += nt) {
    const size_t w = t / nn, ij = t % nn;
    W[w * plane + (ij / n) * pitch + ij % n] = Ab[t];
  }
  if (tid == 0) ok = 1;
  __syncthreads();
  if (tid == 0) {  // pivot 0
    float d[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) d[w] = at(w, 0, 0);
    pivot<NW>(d, piv, &ok);
  }
  bar_sync(1, nt);

#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const float* pj = piv + (j & 1) * 2 * NW;  // rs_j, d_safe_j
    if (tid < CHAIN) {
      // pivot j + 1, ahead of the workers' update j
      if (j + 1 < n && lane < 2) {
        float x[NW], rs[NW], v[NW], r[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          x[w] = lane == 0 ? at(w, j + 1, j) : at(w, j, j + 1);
          rs[w] = pj[w];
        }
        exp_mul<NW>(x, rs, v);  // lane 0: coll_j[j+1]; lane 1: rowl_j[j+1]
#pragma unroll
        for (int w = 0; w < NW; ++w) r[w] = __shfl_sync(0x3u, v[w], 1);
        if (lane == 0) {
          float u[NW], a[NW], d[NW];
          exp_mul<NW>(v, r, u);
#pragma unroll
          for (int w = 0; w < NW; ++w) a[w] = at(w, j + 1, j + 1);
          exp_sub<NW>(a, u, d);
          pivot<NW>(d, piv + ((j + 1) & 1) * 2 * NW, &ok);
        }
      }
    } else {
      float* cl = coll + (j & 1) * NW * n;
      float* rl = rowl + (j & 1) * NW * n;
      if (wt == 0) {  // rt_j = d_safe_j rs_j, the diagonal of L
        float rt[NW];
        exp_mul<NW>(pj + NW, pj, rt);
#pragma unroll
        for (int w = 0; w < NW; ++w) at(w, j, j) = rt[w];
      }
      if (j > 0) {  // column j - 1 of L, held back while the chain read it
        const float* cp = coll + ((j - 1) & 1) * NW * n;
        for (int i = j + wt; i < n; i += nwork)
#pragma unroll
          for (int w = 0; w < NW; ++w) at(w, i, j - 1) = cp[w * n + i];
      }
      for (int i = j + 1 + wt; i < n; i += nwork) {  // scale column and row j
        float rs[NW], cw[NW], rw[NW], o[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          rs[w] = pj[w];
          cw[w] = at(w, i, j);
          rw[w] = at(w, j, i);
        }
        exp_mul<NW>(cw, rs, o);
#pragma unroll
        for (int w = 0; w < NW; ++w) cl[w * n + i] = o[w];
        exp_mul<NW>(rw, rs, o);
#pragma unroll
        for (int w = 0; w < NW; ++w) rl[w * n + i] = o[w];
      }
      bar_sync(2, nwork);
      // update j of the trailing matrix, (j+1+di, j+1+dc) for the flat
      // index di r + dc = wt + 1, wt + 1 + nwork, ... (index 0, W[j+1][j+1],
      // is the chain's), stepped without a division per element
      const int r = n - j - 1;
      const int si = nwork / max(r, 1), sc = nwork - si * max(r, 1);
      int di = (wt + 1) / max(r, 1), dc = (wt + 1) - di * max(r, 1);
      for (; di < r; di += si) {
        const int i = j + 1 + di, c = j + 1 + dc;
        float x[NW], y[NW], u[NW], a[NW], o[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          x[w] = cl[w * n + i];
          y[w] = rl[w * n + c];
          a[w] = at(w, i, c);
        }
        exp_mul<NW>(x, y, u);
        exp_sub<NW>(a, u, o);
#pragma unroll
        for (int w = 0; w < NW; ++w) at(w, i, c) = o[w];
        dc += sc;
        if (dc >= r) {
          dc -= r;
          ++di;
        }
      }
    }
    bar_sync(1, nt);
  }

  for (size_t t = tid; t < NW * nn; t += nt) {
    const size_t w = t / nn, ij = t % nn;
    const size_t i = ij / n, c = ij % n;
    Ob[t] = i >= c ? W[w * plane + i * pitch + c] : 0.0f;
  }
  if (tid == 0) ok_out[b] = ok;
}

template <int NW>
int launch_chol(const float* a, float* out, int* ok, int B, int n, cudaStream_t s) {
  static unsigned long long opted = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const int padded = n | 1;  // odd pitch: a column's words lie in distinct banks
  const bool w_smem = chol_layout(NW, n, padded, true).bytes <= SMEM_MAX;
  const int pitch = w_smem ? padded : n;
  const size_t bytes = chol_layout(NW, n, pitch, w_smem).bytes;
  if (bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = smem_opt_in(chol_batched<NW>, opted, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  chol_batched<NW><<<B, CHOL_THREADS, bytes, s>>>(a, out, ok, n, pitch, w_smem);
  return 0;
}

}  // namespace

extern "C" {

int clrs_chol(const float* a, float* out, int* ok, int B, int n, int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CLRS_DISPATCH_NW(nw, {
    const int rc = launch_chol<NWc>(a, out, ok, B, n, s);
    if (rc != 0) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
