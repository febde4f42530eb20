// The f32-expansion arithmetic of the IPM step as kernels (sm_90a), with a
// plain C interface loaded by clrs_tpu_torch/dd/build.py through ctypes.
//
// On the TPU the JAX package's whole step is one jitted program
// (clrs_tpu/solver/step.py:1621), and every f32 expansion add, subtract,
// multiply and divide routes to the barrier-free forms of
// clrs_tpu/dd/expops.py (clrs_tpu/dd/core.py:448-499), which XLA fuses into
// device kernels; its tree sums are clrs_tpu/dd/linalg.py:110-127 inside the
// same program. These kernels replace those fusions: each expansion op, and
// each tree sum, is one launch instead of one PyTorch launch per f32 word
// operation (dozens to thousands an op).
//
// expmap<NW, OP>   one expansion op over a broadcast shape of up to six
//   dims, one output element a thread: OP_ADD, OP_SUB, OP_MUL, OP_DIV
//   (csrc/expansion.cuh exp_add/exp_sub/exp_mul/exp_div), OP_NEG, and
//   OP_SYM, exp_add(x, y) then 0.5 * each word (dd/linalg.py dd_symmetrize,
//   y = x^T read through swapped strides). Each word of each operand is
//   read where it lies, through its own pointer and strides (0 on a
//   broadcast axis); the output is [NW, numel], contiguous. At the step's
//   sizes (1 to ~10^5 elements) bound by latency: the launch, one load
//   round trip and one element's chain (~200 dependent operations for an
//   add at nw 5, ~3,000 for a division).
// tree_sum<NW>     dd_sum along one axis in the exact pairing order of
//   clrs_tpu/dd/linalg.py:110-127: at each level of n entries, entry i of
//   the first n / 2 becomes exp_add(entry i, entry ceil(n/2) + i), and the
//   odd middle entry is carried. Shared route (level == 0): a block loads
//   C columns' entries into shared memory and runs every level there,
//   __syncthreads between levels; the levels' adds are independent, so its
//   threads share them out. Level route (level == 1), where one column's
//   n NW 4 bytes exceed the shared-memory budget: one launch a level, each
//   thread one (column, entry) of it, in a scratch buffer the wrapper
//   allocates (in place: entry i is read and written only by its own
//   thread, every other read is of an entry >= ceil(n/2)).
//
// Every op is the plain version's op sequence (clrs_tpu_torch/dd/ops.py)
// under -fmad=false and explicit round-to-nearest intrinsics, so each
// kernel equals its plain version bit for bit. Word counts NW = 5..8 are
// instantiated (the f32 substrate's ladder); other values return
// cudaErrorInvalidValue. Each C entry launches on the caller's stream,
// synchronises nothing, allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "common.cuh"
#include "expansion.cuh"

namespace {

using namespace clrs;

constexpr int MAXW = 8;   // words of an operand
constexpr int MAXD = 6;   // dims of the (coalesced) broadcast shape
constexpr int EXPMAP_THREADS = 128;
constexpr int TREE_THREADS = 256;

enum : int { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_DIV = 3, OP_NEG = 4, OP_SYM = 5 };

// An operand's words over the shape: word k at w[k] + sum_d i_d st[k][d]
// (+ e ax[k] for entry e of a tree sum's column). `shared`: every word
// has word 0's strides, so one offset serves all words.
struct View {
  const float* w[MAXW];
  long long st[MAXW][MAXD];
  long long ax[MAXW];
  int shared;
};

// The shape, right-aligned: dims first..MAXD-1 are n[first..], the rest 1.
struct Dims {
  int n[MAXD];
  int first;
};

// Where a tree sum writes entry e of column c, word k:
// p + k ws + c cs + e es.
struct Dst {
  float* p;
  long long ws, cs, es;
};

__device__ __forceinline__ void unravel(unsigned idx, const Dims& dm, int* ix) {
#pragma unroll
  for (int d = MAXD - 1; d >= 0; --d) {
    if (d >= dm.first) {
      const unsigned nd = static_cast<unsigned>(dm.n[d]);
      ix[d] = static_cast<int>(idx % nd);
      idx /= nd;
    } else {
      ix[d] = 0;
    }
  }
}

// Words k < N of the element at index ix (entry e along the tree axis).
template <int N>
__device__ __forceinline__ void load_view(const View& v, const int* ix, long long e, float* out) {
  if (v.shared) {
    long long o = e * v.ax[0];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) o += ix[d] * v.st[0][d];
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = __ldg(v.w[k] + o);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      long long o = e * v.ax[k];
#pragma unroll
      for (int d = 0; d < MAXD; ++d) o += ix[d] * v.st[k][d];
      out[k] = __ldg(v.w[k] + o);
    }
  }
}

template <int NW, int OP>
__global__ void __launch_bounds__(EXPMAP_THREADS)
    expmap(View a, View b, Dims dm, float* __restrict__ out, unsigned numel) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= numel) return;
  int ix[MAXD];
  unravel(idx, dm, ix);
  float x[NW], r[NW];
  load_view<NW>(a, ix, 0, x);
  if constexpr (OP == OP_NEG) {
#pragma unroll
    for (int k = 0; k < NW; ++k) r[k] = -x[k];
  } else {
    float y[NW];
    load_view<NW>(b, ix, 0, y);
    if constexpr (OP == OP_ADD) {
      exp_add<NW>(x, y, r);
    } else if constexpr (OP == OP_SUB) {
      exp_sub<NW>(x, y, r);
    } else if constexpr (OP == OP_MUL) {
      exp_mul<NW>(x, y, r);
    } else if constexpr (OP == OP_DIV) {
      exp_div<NW>(x, y, r);
    } else {
      float s[NW];
      exp_add<NW>(x, y, s);
#pragma unroll
      for (int k = 0; k < NW; ++k) r[k] = fmul(s[k], 0.5f);  // exact scaling
    }
  }
#pragma unroll
  for (int k = 0; k < NW; ++k) out[static_cast<size_t>(k) * numel + idx] = r[k];
}

template <int NW>
__device__ __forceinline__ void store_dst(const Dst& d, long long c, long long e, const float* r) {
#pragma unroll
  for (int k = 0; k < NW; ++k) d.p[k * d.ws + c * d.cs + e * d.es] = r[k];
}

// cols: the column dims (the summed axis taken out); n entries a column.
// Shared route: C columns a block, dynamic shared memory [NW][C][n].
// Level route: one level of n entries into dst.
template <int NW>
__global__ void __launch_bounds__(TREE_THREADS)
    tree_sum(View src, Dims cols, Dst dst, int M, int n, int C, int level) {
  int ix[MAXD];
  if (level == 0) {
    extern __shared__ float sm[];
    const int c0 = blockIdx.x * C;
    const int cn = min(C, M - c0);
    const int plane = C * n;  // word stride in sm
    for (int t = threadIdx.x; t < cn * n; t += blockDim.x) {
      const int c = t / n, e = t - c * n;
      float v[NW];
      unravel(static_cast<unsigned>(c0 + c), cols, ix);
      load_view<NW>(src, ix, e, v);
#pragma unroll
      for (int k = 0; k < NW; ++k) sm[k * plane + c * n + e] = v[k];
    }
    __syncthreads();
    for (int m = n; m > 1; m = (m + 1) / 2) {
      const int h = m / 2, half = (m + 1) / 2;
      for (int t = threadIdx.x; t < cn * h; t += blockDim.x) {
        const int c = t / h, i = t - c * h;
        float x[NW], y[NW], r[NW];
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          x[k] = sm[k * plane + c * n + i];
          y[k] = sm[k * plane + c * n + half + i];
        }
        exp_add<NW>(x, y, r);
#pragma unroll
        for (int k = 0; k < NW; ++k) sm[k * plane + c * n + i] = r[k];
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < cn; c += blockDim.x) {
      float r[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) r[k] = n > 0 ? sm[k * plane + c * n] : 0.0f;
      store_dst<NW>(dst, c0 + c, 0, r);
    }
  } else {
    const int h = n / 2, half = (n + 1) / 2;
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= static_cast<long long>(M) * half) return;
    const int c = static_cast<int>(t / half);
    const int i = static_cast<int>(t - static_cast<long long>(c) * half);
    unravel(static_cast<unsigned>(c), cols, ix);
    float x[NW], r[NW];
    load_view<NW>(src, ix, i, x);
    if (i < h) {
      float y[NW];
      load_view<NW>(src, ix, half + i, y);
      exp_add<NW>(x, y, r);
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k) r[k] = x[k];  // the carried middle entry
    }
    store_dst<NW>(dst, c, i, r);
  }
}

// One View from host arrays: ptrs [MAXW], strides [MAXW][MAXD], ax [MAXW]
// (may be null: 0).
View make_view(const void* const* ptrs, const long long* strides, const long long* ax,
               int shared) {
  View v{};
  for (int k = 0; k < MAXW; ++k) {
    v.w[k] = static_cast<const float*>(ptrs[k]);
    for (int d = 0; d < MAXD; ++d) v.st[k][d] = strides[k * MAXD + d];
    v.ax[k] = ax ? ax[k] : 0;
  }
  v.shared = shared;
  return v;
}

bool make_dims(const int* dims, int nd, Dims& dm) {
  if (nd < 0 || nd > MAXD) return false;
  dm.first = MAXD - nd;
  for (int d = 0; d < MAXD; ++d) {
    dm.n[d] = d >= dm.first ? dims[d - dm.first] : 1;
    if (dm.n[d] <= 0) return false;
  }
  return true;
}

template <int NW>
int launch_expmap(int op, const View& a, const View& b, const Dims& dm, float* out, unsigned numel,
                  cudaStream_t s) {
  const dim3 grid((numel + EXPMAP_THREADS - 1) / EXPMAP_THREADS);
  switch (op) {
    case OP_ADD: expmap<NW, OP_ADD><<<grid, EXPMAP_THREADS, 0, s>>>(a, b, dm, out, numel); break;
    case OP_SUB: expmap<NW, OP_SUB><<<grid, EXPMAP_THREADS, 0, s>>>(a, b, dm, out, numel); break;
    case OP_MUL: expmap<NW, OP_MUL><<<grid, EXPMAP_THREADS, 0, s>>>(a, b, dm, out, numel); break;
    case OP_DIV: expmap<NW, OP_DIV><<<grid, EXPMAP_THREADS, 0, s>>>(a, b, dm, out, numel); break;
    case OP_NEG: expmap<NW, OP_NEG><<<grid, EXPMAP_THREADS, 0, s>>>(a, b, dm, out, numel); break;
    case OP_SYM: expmap<NW, OP_SYM><<<grid, EXPMAP_THREADS, 0, s>>>(a, b, dm, out, numel); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <int NW>
int launch_tree(const View& src, const Dims& cols, const Dst& dst, int M, int n, int C, int level,
                cudaStream_t s) {
  if (level == 0) {
    const size_t smem = sizeof(float) * NW * static_cast<size_t>(C) * n;
    if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      static unsigned long long done = 0;
      int dev = 0;
      cudaGetDevice(&dev);
      const cudaError_t e = smem_opt_in(tree_sum<NW>, done, dev);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(static_cast<unsigned>((M + C - 1) / C));
    tree_sum<NW><<<grid, TREE_THREADS, smem, s>>>(src, cols, dst, M, n, C, 0);
  } else {
    const long long items = static_cast<long long>(M) * ((n + 1) / 2);
    const dim3 grid(static_cast<unsigned>((items + TREE_THREADS - 1) / TREE_THREADS));
    tree_sum<NW><<<grid, TREE_THREADS, 0, s>>>(src, cols, dst, M, n, C, 1);
  }
  return 0;
}

}  // namespace

extern "C" {

// ptrs [2][8] word pointers, strides [2][8][6] element strides over the
// right-aligned shape dims [nd] (the wrapper coalesces it to nd <= 6),
// shared [2]; out [nw, numel] contiguous; numel in 1 .. 2^31 - 1.
int clrs_expmap(int op, const void* const* ptrs, const long long* strides, const int* shared,
                const int* dims, int nd, float* out, long long numel, int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Dims dm;
  if (op < OP_ADD || op > OP_SYM || numel <= 0 || numel >= (1LL << 31) || !make_dims(dims, nd, dm))
    return static_cast<int>(cudaErrorInvalidValue);
  long long prod = 1;
  for (int d = 0; d < nd; ++d) prod *= dims[d];
  if (prod != numel) return static_cast<int>(cudaErrorInvalidValue);
  const View a = make_view(ptrs, strides, nullptr, shared[0]);
  const View b = make_view(ptrs + MAXW, strides + MAXW * MAXD, nullptr, shared[1]);
  CLRS_DISPATCH_NW(nw, {
    const int rc = launch_expmap<NWc>(op, a, b, dm, out, static_cast<unsigned>(numel), s);
    if (rc != 0) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}

// ptrs [8], strides [8][6] over the column dims [nd], ax [8] the summed
// axis's strides; dst: p + k ws + c cs + e es. level 0: the shared route,
// C columns a block; level 1: one level of n >= 2 entries.
int clrs_tree_sum(const void* const* ptrs, const long long* strides, const long long* ax,
                  int shared, const int* dims, int nd, float* dst, long long ws, long long cs,
                  long long es, int M, int n, int C, int level, int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Dims dm;
  if (M <= 0 || n < 0 || C <= 0 || (level != 0 && level != 1) || (level == 1 && n < 2) ||
      static_cast<long long>(M) * ((n + 1) / 2) >= (1LL << 31) || !make_dims(dims, nd, dm))
    return static_cast<int>(cudaErrorInvalidValue);
  long long prod = 1;
  for (int d = 0; d < nd; ++d) prod *= dims[d];
  if (prod != M) return static_cast<int>(cudaErrorInvalidValue);
  const View v = make_view(ptrs, strides, ax, shared);
  const Dst d{dst, ws, cs, es};
  CLRS_DISPATCH_NW(nw, {
    const int rc = launch_tree<NWc>(v, dm, d, M, n, C, level, s);
    if (rc != 0) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
