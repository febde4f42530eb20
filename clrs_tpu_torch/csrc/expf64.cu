// The f64 boundary of the step's expansion arithmetic (sm_90a): every
// conversion between an nw-word f32 expansion and an f64 value as one
// launch. Plain C interface, loaded by clrs_tpu_torch/dd/build.py through
// ctypes.
//
// Replaces: the XLA fusions of the jitted TPU step over the JAX package's
// _f64sum and _scalar_split (clrs_tpu/solver/step.py:104-140) and
// dd_max_abs (clrs_tpu/dd/linalg.py:136-144), which PyTorch runs as one
// kernel a word and an op (2 nw - 1 for a sum: the casts, then the adds).
//
// expf64<NW, FORM>:
//   SUM     x -> f64, elementwise over a broadcast shape of up to six
//           dims, one element a thread: f64(w0) + f64(w1) + ... left to
//           right in IEEE f64 (the casts are exact), written contiguous.
//   MAXABS  max |SUM(x)| over every element, [maximum(acc, .)], 0-d f64:
//           one cluster of G = 1..8 blocks (G from numel); each thread
//           walks its elements, the blocks reduce in shared memory and
//           block 0 reads the others' partials through distributed shared
//           memory. |v| >= +0 or a NaN with its sign cleared, and such
//           doubles order as their bit patterns with every NaN above +Inf,
//           so the reduction is an integer max: exact, in any order, and
//           NaN wins, as Tensor.max propagates it. An empty input gives
//           +0. The accumulator is combined as torch.maximum does:
//           acc if acc is NaN, else the max if it is NaN, else the larger.
//   SPLIT   f64 v -> NW f32 words by successive rounding, w = f32(r),
//           r = r - f64(w), for words 0..2; words 3.. are +0
//           (solver/step.py _scalar_split on f32 words). Output [NW, numel],
//           contiguous.
// Every op is the plain version's under -fmad=false and explicit
// round-to-nearest intrinsics, so each form equals its plain version bit for
// bit. Bound by latency at the step's sizes (the launch and one load round
// trip); MAXABS at the largest residual blocks by the bytes of its words.
// Word counts NW = 1..8 are instantiated; others return
// cudaErrorInvalidValue. The C entry launches on the caller's stream,
// synchronises nothing, allocates nothing and returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "expview.cuh"

namespace {

using namespace clrs;
namespace cg = cooperative_groups;

constexpr int F64_THREADS = 128;      // SUM and SPLIT: one element a thread
constexpr int MAXABS_THREADS = 512;   // MAXABS: a block of the cluster
constexpr int MAX_CLUSTER = 8;        // the portable cluster size

enum : int { F_SUM = 0, F_MAXABS = 1, F_SPLIT = 2 };

struct F64Args {
  View x;                   // SUM, MAXABS: the expansion's words
  const double* src;        // SPLIT: the f64 values, through src_st
  long long src_st[MAXD];
  const double* acc;        // MAXABS: the accumulator (null: none)
  void* out;                // SUM [numel] f64, MAXABS [] f64, SPLIT [NW, numel] f32
  Dims dm;
  unsigned numel;
};

template <int NW>
__device__ __forceinline__ double word_sum(const View& x, const int* ix) {
  float w[NW];
  load_view<NW>(x, ix, w);
  double s = static_cast<double>(w[0]);
#pragma unroll
  for (int k = 1; k < NW; ++k) s = __dadd_rn(s, static_cast<double>(w[k]));
  return s;
}

__device__ __forceinline__ unsigned long long abs_bits(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(fabs(v)));
}

template <int NW>
__device__ void max_abs(const F64Args& a) {
  __shared__ unsigned long long part[MAXABS_THREADS / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned G = cluster.num_blocks();
  const unsigned r = cluster.block_rank();
  const unsigned stride = G * MAXABS_THREADS;
  unsigned long long m = 0;  // +0
#pragma unroll 4
  for (unsigned i = r * MAXABS_THREADS + threadIdx.x; i < a.numel; i += stride) {
    int ix[MAXD];
    unravel(i, a.dm, ix);
    m = max(m, abs_bits(word_sum<NW>(a.x, ix)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < MAXABS_THREADS / 32; ++w) m = max(m, part[w]);
    part[0] = m;
  }
  cluster.sync();
  if (r == 0 && threadIdx.x == 0) {
    for (unsigned b = 1; b < G; ++b) m = max(m, *cluster.map_shared_rank(&part[0], b));
  }
  cluster.sync();  // no block leaves while block 0 may read its partial
  if (r != 0 || threadIdx.x != 0) return;
  double v = __longlong_as_double(static_cast<long long>(m));
  if (a.acc) {
    const double c = *a.acc;
    v = isnan(c) ? c : (isnan(v) ? v : fmax(c, v));
  }
  *static_cast<double*>(a.out) = v;
}

template <int NW, int FORM>
__global__ void __launch_bounds__(FORM == F_MAXABS ? MAXABS_THREADS : F64_THREADS)
    expf64(const F64Args a) {
  if constexpr (FORM == F_MAXABS) {
    max_abs<NW>(a);
  } else {
    const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= a.numel) return;
    int ix[MAXD];
    unravel(idx, a.dm, ix);
    if constexpr (FORM == F_SUM) {
      static_cast<double*>(a.out)[idx] = word_sum<NW>(a.x, ix);
    } else {
      float* out = static_cast<float*>(a.out);
      double rem = a.src[offset(a.src_st, ix)];
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        float w = 0.0f;
        if (k < 3) {
          w = __double2float_rn(rem);
          rem = __dsub_rn(rem, static_cast<double>(w));
        }
        out[static_cast<size_t>(k) * a.numel + idx] = w;
      }
    }
  }
}

// G: MAXABS's cluster size, 1..MAX_CLUSTER.
template <int NW>
int launch_expf64(int form, const F64Args& a, int G, cudaStream_t s) {
  if (form == F_MAXABS) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(G));
    cfg.blockDim = dim3(MAXABS_THREADS);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(G);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&cfg, expf64<NW, F_MAXABS>, a));
  }
  const dim3 grid((a.numel + F64_THREADS - 1) / F64_THREADS);
  if (form == F_SUM) {
    expf64<NW, F_SUM><<<grid, F64_THREADS, 0, s>>>(a);
  } else {
    expf64<NW, F_SPLIT><<<grid, F64_THREADS, 0, s>>>(a);
  }
  return 0;
}

}  // namespace

extern "C" {

// form: 0 SUM, 1 MAXABS, 2 SPLIT. SUM, MAXABS: ptrs [8] word pointers and
// strides [8][6] element strides over the right-aligned dims [nd] (the
// wrapper coalesces the shape to nd <= 6), shared; MAXABS: acc (null or one
// f64), G the cluster size (1..8). SPLIT: src and src_st [6], the f64 values
// over the same dims. out: SUM [numel] f64, MAXABS one f64, SPLIT
// [nw, numel] f32, contiguous. numel in 1 .. 2^31 - 1 (MAXABS: 0 too).
int clrs_expf64(int form, const void* const* ptrs, const long long* strides, int shared,
                const double* src, const long long* src_st, const double* acc, const int* dims,
                int nd, void* out, long long numel, int nw, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  F64Args a{};
  if (form < F_SUM || form > F_SPLIT || numel < (form == F_MAXABS ? 0 : 1) ||
      numel >= (1LL << 31) || !make_dims(dims, nd, 0, a.dm) || !out ||
      (form == F_MAXABS && (G < 1 || G > MAX_CLUSTER)) || (form == F_SPLIT && !src))
    return static_cast<int>(cudaErrorInvalidValue);
  long long prod = 1;
  for (int d = 0; d < nd; ++d) prod *= dims[d];
  if (prod != numel && !(form == F_MAXABS && numel == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == F_SPLIT) {
    a.src = src;
    for (int d = 0; d < MAXD; ++d) a.src_st[d] = src_st[d];
  } else {
    a.x = make_view(ptrs, strides, shared);
  }
  a.acc = form == F_MAXABS ? acc : nullptr;
  a.out = out;
  a.numel = static_cast<unsigned>(numel);
  CLRS_DISPATCH_NW_OPERAND(nw, {
    const int rc = launch_expf64<NWc>(form, a, G, s);
    if (rc != 0) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
