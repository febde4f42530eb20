// The step's one reduction kernel (sm_90a): a tree sum of f32 expansions in
// dd_sum's pairing order, with an optional product on load and an optional
// accumulate on store, so that acc +- dd_sum(dd_mul(x s, y), axes) is one
// launch. Plain C interface, loaded by clrs_tpu_torch/dd/build.py through
// ctypes.
//
// Replaces: dd_sum's tree (clrs_tpu/dd/linalg.py:110-127) over the expops
// forms (clrs_tpu/dd/core.py:448-499) and the products and adds around it,
// which XLA fuses inside the jitted TPU step (clrs_tpu/solver/step.py:1621).
// The port's plain version is the composition of dd/kernels.py's plain
// ew_mul, tree_sum and ew_add/ew_sub (tree_sum_fused_plain).
//
// tree_sum<NW, PRO>: M columns of n entries each. An entry is x (PRO_NONE)
// or exp_mul(x, y) (PRO_MUL), with x's words or the product's optionally
// times an exact {0,1} or power-of-two word (the step's _dd_scale); the
// entries of a column are the row-major order of the entry dims
// [split, MAXD) of the broadcast shape (csrc/expview.cuh). The pairing is
// dd_sum's: at each level of m entries, entry i < m / 2 becomes
// exp_add(entry i, entry ceil(m/2) + i) and the odd middle entry is
// carried. The column's sum then goes through the epilogue: none,
// exp_add(acc, sum) or exp_sub(acc, sum), acc read through its own view.
//
// What bounds it: at the step's sizes, latency. Each level is a dependent
// exp_add chain (~200 operations at nw 5) behind a barrier, and a tree sum
// alone also pays a launch for each product and add around it, with their
// nw words written to device memory and read back. The design:
// - the first level is computed on load: entry i of level 1 is
//   exp_add(P(i), P(ceil(n/2) + i)) of two entries P read (and multiplied)
//   from device memory, so shared memory holds ceil(n/2) entries and the
//   product and its first add never leave registers;
// - block route (G == 1): C columns a block (at most one level-1 entry a
//   thread), every further level in shared memory behind __syncthreads,
//   the last levels (at most 32 adds) in warp 0 behind __syncwarp;
// - cluster route (G = 2..8): one column over a thread-block cluster of G
//   blocks (cudaLaunchKernelEx, cudaLaunchAttributeClusterDimension), block
//   r holding level-1 entries [r S, (r + 1) S); a level's partner entry is
//   read from its owner's shared memory through
//   cooperative_groups::this_cluster().map_shared_rank, cluster.sync()
//   between levels, and once a level fits block 0 the other blocks leave
//   and block 0 ends alone. A cluster spreads a column that a block cannot
//   hold (up to 8 x 227 KB), and a long column that one block's threads
//   would walk alone (dd_dot over 18,432 entries at (3,95)), over 512
//   threads a block;
// - level route (level == 1), only beyond a full cluster's capacity: one
//   launch a level in a scratch buffer, PRO on the first, the epilogue on
//   the last.
// The in-place levels have no hazard on any route: entry i is written only
// by the thread that owns it, and every other read is of an entry >=
// ceil(m/2), which no thread writes in that level.
//
// Every op is the plain version's sequence (csrc/expansion.cuh under
// -fmad=false, explicit round-to-nearest), so the kernel equals its plain
// version bit for bit. NW = 5..8. The C entry launches on the caller's
// stream, synchronises nothing, allocates nothing and returns the launch's
// error.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "expansion.cuh"
#include "expview.cuh"

namespace {

using namespace clrs;
namespace cg = cooperative_groups;

constexpr int TREE_THREADS = 256;          // block and level routes
constexpr int CLUSTER_THREADS = 512;       // cluster route: a long column
constexpr int MAX_CLUSTER = 8;             // the portable cluster size

enum : int { PRO_NONE = 0, PRO_MUL = 1 };
enum : int { EPI_NONE = 0, EPI_ADD = 1, EPI_SUB = 2 };
enum : int { SCALE_NONE = 0, SCALE_X = 1, SCALE_PRODUCT = 2 };

// Where a column's entry goes: p + k ws + c cs + e es.
struct Dst {
  float* p;
  long long ws, cs, es;
};

struct TreeArgs {
  View x, y, acc;  // y read for PRO_MUL only, acc for an epilogue only
  Word1 sc;        // the exact scale, applied as scale_on says
  Dims dm;         // column dims [first, split), entry dims [split, MAXD)
  Dst dst;
  int M, n, C, G, S;  // columns, entries, columns a block, cluster size,
                      // level-1 entries a block holds (cluster route)
  int scale_on, epi;
};

// Entry e of the column whose column indices ix already holds.
template <int NW, int PRO>
__device__ __forceinline__ void entry(const TreeArgs& a, int* ix, unsigned e, float* out) {
  unravel_range(e, a.dm, a.dm.split, MAXD, ix);
  float x[NW];
  load_view<NW>(a.x, ix, x);
  if (a.scale_on == SCALE_X) scale_words<NW>(x, load_word1(a.sc, ix));
  if constexpr (PRO == PRO_MUL) {
    float y[NW];
    load_view<NW>(a.y, ix, y);
    exp_mul<NW>(x, y, out);
    if (a.scale_on == SCALE_PRODUCT) scale_words<NW>(out, load_word1(a.sc, ix));
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) out[k] = x[k];
  }
}

// Entry i of level 1 over n entries: exp_add(P(i), P(ceil(n/2) + i)), or
// the carried middle entry P(n / 2) of an odd n. The one or two entries go
// through one copy of entry()'s code in a loop that is not unrolled: at the
// step's sizes a launch runs its straight-line code once, so its length
// costs time, and the carried entry's thread takes the same path as the
// others.
template <int NW, int PRO>
__device__ __forceinline__ void level1(const TreeArgs& a, int* ix, int n, int i, float* r) {
  const int cnt = i < n / 2 ? 2 : 1;
#pragma unroll 1
  for (int t = 0; t < cnt; ++t) {
    float p[NW];
    entry<NW, PRO>(a, ix, static_cast<unsigned>(t == 0 ? i : (n + 1) / 2 + i), p);
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < NW; ++k) r[k] = p[k];
    } else {
      float q[NW];
      exp_add<NW>(r, p, q);
#pragma unroll
      for (int k = 0; k < NW; ++k) r[k] = q[k];
    }
  }
}

// The epilogue and the store of column c's sum r (entry 0 of dst).
template <int NW>
__device__ __forceinline__ void finish(const TreeArgs& a, int* ix, long long c, long long e,
                                       float* r) {
  float o[NW];
  if (a.epi != EPI_NONE) {
#pragma unroll
    for (int d = 0; d < MAXD; ++d)
      if (d >= a.dm.split) ix[d] = 0;
    float acc[NW];
    load_view<NW>(a.acc, ix, acc);
    if (a.epi == EPI_ADD) {
      exp_add<NW>(acc, r, o);
    } else {
      exp_sub<NW>(acc, r, o);
    }
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) o[k] = r[k];
  }
#pragma unroll
  for (int k = 0; k < NW; ++k) a.dst.p[k * a.dst.ws + c * a.dst.cs + e * a.dst.es] = o[k];
}

// One level of m entries over cn columns of stride `col` (word plane
// `plane`) in shared memory, by the threads t0, t0 + step, ...
template <int NW>
__device__ __forceinline__ void smem_level(float* sm, int plane, int col, int cn, int m, int t0,
                                           int step) {
  const int h = m / 2, half = (m + 1) / 2;
  for (int t = t0; t < cn * h; t += step) {
    const int c = t / h, i = t - c * h;
    float x[NW], y[NW], r[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      x[k] = sm[k * plane + c * col + i];
      y[k] = sm[k * plane + c * col + half + i];
    }
    exp_add<NW>(x, y, r);
#pragma unroll
    for (int k = 0; k < NW; ++k) sm[k * plane + c * col + i] = r[k];
  }
}

// Levels from m entries down to one, block-local: all threads while a
// level has more than 32 adds, then warp 0 alone.
template <int NW>
__device__ __forceinline__ void smem_levels(float* sm, int plane, int col, int cn, int m) {
  while (m > 1 && cn * (m / 2) > 32) {
    smem_level<NW>(sm, plane, col, cn, m, threadIdx.x, blockDim.x);
    __syncthreads();
    m = (m + 1) / 2;
  }
  if (threadIdx.x < 32) {
    while (m > 1) {
      smem_level<NW>(sm, plane, col, cn, m, threadIdx.x, 32);
      __syncwarp();
      m = (m + 1) / 2;
    }
  }
  __syncthreads();
}

template <int NW, int PRO>
__global__ void __launch_bounds__(CLUSTER_THREADS) tree_sum(TreeArgs a, int level) {
  int ix[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) ix[d] = 0;
  const int n = a.n, h1 = (n + 1) / 2;
  if (level == 1) {
    // one level of n entries into dst: each thread one (column, entry)
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= static_cast<long long>(a.M) * h1) return;
    const int c = static_cast<int>(t / h1);
    const int i = static_cast<int>(t - static_cast<long long>(c) * h1);
    unravel_range(static_cast<unsigned>(c), a.dm, a.dm.first, a.dm.split, ix);
    float r[NW];
    level1<NW, PRO>(a, ix, n, i, r);
    if (n == 2) {
      finish<NW>(a, ix, c, 0, r);  // the last level: the epilogue
    } else {
#pragma unroll
      for (int k = 0; k < NW; ++k) a.dst.p[k * a.dst.ws + c * a.dst.cs + i * a.dst.es] = r[k];
    }
    return;
  }
  extern __shared__ float sm[];
  if (a.G == 1) {
    // block route: C columns, [NW][C][h1] in shared memory
    const int c0 = blockIdx.x * a.C;
    const int cn = min(a.C, a.M - c0);
    const int plane = a.C * h1;
    for (int t = threadIdx.x; t < cn * h1; t += blockDim.x) {
      const int c = t / h1, i = t - c * h1;
      unravel_range(static_cast<unsigned>(c0 + c), a.dm, a.dm.first, a.dm.split, ix);
      float r[NW];
      level1<NW, PRO>(a, ix, n, i, r);
#pragma unroll
      for (int k = 0; k < NW; ++k) sm[k * plane + c * h1 + i] = r[k];
    }
    __syncthreads();
    smem_levels<NW>(sm, plane, h1, cn, h1);
    for (int c = threadIdx.x; c < cn; c += blockDim.x) {
      float r[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) r[k] = h1 > 0 ? sm[k * plane + c * h1] : 0.0f;
      unravel_range(static_cast<unsigned>(c0 + c), a.dm, a.dm.first, a.dm.split, ix);
      finish<NW>(a, ix, c0 + c, 0, r);
    }
    return;
  }
  // cluster route: one column over G blocks, [NW][S] in each block
  cg::cluster_group cluster = cg::this_cluster();
  const int G = a.G, S = a.S;
  const int r = static_cast<int>(cluster.block_rank());
  const int col = blockIdx.x / G;
  const int lo = r * S, hi = min(lo + S, h1);
  unravel_range(static_cast<unsigned>(col), a.dm, a.dm.first, a.dm.split, ix);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    float v[NW];
    level1<NW, PRO>(a, ix, n, i, v);
#pragma unroll
    for (int k = 0; k < NW; ++k) sm[k * S + i - lo] = v[k];
  }
  cluster.sync();
  int m = h1;
  while (m > S) {
    const int h = m / 2, half = (m + 1) / 2;
    for (int i = lo + threadIdx.x; i < min(hi, h); i += blockDim.x) {
      const int j = half + i, owner = j / S;
      const float* rs = cluster.map_shared_rank(sm, owner);
      float x[NW], y[NW], v[NW];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        x[k] = sm[k * S + i - lo];
        y[k] = rs[k * S + j - owner * S];
      }
      exp_add<NW>(x, y, v);
#pragma unroll
      for (int k = 0; k < NW; ++k) sm[k * S + i - lo] = v[k];
    }
    cluster.sync();
    m = half;
  }
  if (r != 0) return;  // no block reads another's shared memory past here
  smem_levels<NW>(sm, S, S, 1, m);
  if (threadIdx.x == 0) {
    float v[NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) v[k] = sm[k * S];
    finish<NW>(a, ix, col, 0, v);
  }
}

template <int NW, int PRO>
int launch_tree(const TreeArgs& a, int level, cudaStream_t s) {
  auto kernel = tree_sum<NW, PRO>;
  if (level == 1) {
    const long long items = static_cast<long long>(a.M) * ((a.n + 1) / 2);
    const dim3 grid(static_cast<unsigned>((items + TREE_THREADS - 1) / TREE_THREADS));
    kernel<<<grid, TREE_THREADS, 0, s>>>(a, 1);
    return 0;
  }
  const int per_block = a.G == 1 ? a.C * ((a.n + 1) / 2) : a.S;
  const size_t smem = sizeof(float) * NW * static_cast<size_t>(per_block);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    static unsigned long long done = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    const cudaError_t e = smem_opt_in(kernel, done, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.G == 1) {
    const dim3 grid(static_cast<unsigned>((a.M + a.C - 1) / a.C));
    kernel<<<grid, TREE_THREADS, smem, s>>>(a, 0);
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.M) * static_cast<unsigned>(a.G));
  cfg.blockDim = dim3(CLUSTER_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.G);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a, 0));
}

template <int NW>
int launch_tree_pro(const TreeArgs& a, int pro, int level, cudaStream_t s) {
  return pro == PRO_MUL ? launch_tree<NW, PRO_MUL>(a, level, s)
                        : launch_tree<NW, PRO_NONE>(a, level, s);
}

}  // namespace

extern "C" {

// ptrs [3][8] and strides [3][8][6] of x, y and acc over the shape dims
// [nd] (right-aligned; the last ne are the entry dims, the rest the column
// dims, M columns in all), shared [3]; scale: a word over the same dims
// (scale_st [6]) or, null, the constant scale_c, applied as scale_on says
// (0 none, 1 x, 2 the product); dst: p + k ws + c cs + e es. level 0: the
// block (G == 1, C columns a block) or cluster (G = 2..8, S level-1
// entries a block) route; level 1: one level of n >= 2 entries.
// pro: 0 none, 1 product; epi: 0 none, 1 add, 2 subtract.
int clrs_tree_sum(const void* const* ptrs, const long long* strides, const int* shared,
                  const float* scale, const long long* scale_st, float scale_c, int scale_on,
                  const int* dims, int nd, int ne, float* dst, long long ws, long long cs,
                  long long es, int M, int n, int C, int G, int S, int level, int pro, int epi,
                  int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  TreeArgs a{};
  if (M <= 0 || n < 0 || C <= 0 || G < 1 || G > MAX_CLUSTER || (level != 0 && level != 1) ||
      (level == 1 && n < 2) || (G > 1 && (C != 1 || S <= 0 || static_cast<long long>(G) * S < (n + 1) / 2)) ||
      pro < PRO_NONE || pro > PRO_MUL || epi < EPI_NONE || epi > EPI_SUB || scale_on < 0 ||
      scale_on > SCALE_PRODUCT || (scale_on == SCALE_PRODUCT && pro != PRO_MUL) ||
      static_cast<long long>(M) * ((n + 1) / 2) >= (1LL << 31) || !make_dims(dims, nd, ne, a.dm))
    return static_cast<int>(cudaErrorInvalidValue);
  long long cols = 1, ents = 1;
  for (int d = 0; d < nd; ++d) (d < nd - ne ? cols : ents) *= dims[d];
  if (cols != M || (ne > 0 ? ents != n : n > 1)) return static_cast<int>(cudaErrorInvalidValue);
  a.x = make_view(ptrs, strides, shared[0]);
  a.y = make_view(ptrs + MAXW, strides + MAXW * MAXD, shared[1]);
  a.acc = make_view(ptrs + 2 * MAXW, strides + 2 * MAXW * MAXD, shared[2]);
  a.sc = make_word1(scale, scale_st, scale_c);
  a.dst = Dst{dst, ws, cs, es};
  a.M = M;
  a.n = n;
  a.C = C;
  a.G = G;
  a.S = S;
  a.scale_on = scale_on;
  a.epi = epi;
  CLRS_DISPATCH_NW(nw, {
    const int rc = launch_tree_pro<NWc>(a, pro, level, s);
    if (rc != 0) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
