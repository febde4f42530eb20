// The f32-expansion arithmetic of the IPM step as kernels (sm_90a), with a
// plain C interface loaded by clrs_tpu_torch/dd/build.py through ctypes.
//
// On the TPU the JAX package's whole step is one jitted program
// (clrs_tpu/solver/step.py:1621), and every f32 expansion add, subtract,
// multiply and divide routes to the barrier-free forms of
// clrs_tpu/dd/expops.py (clrs_tpu/dd/core.py:448-499), which XLA fuses into
// device kernels. expmap<NW, OP> replaces those fusions op by op: each
// expansion op is one launch instead of one PyTorch launch per f32 word
// operation (dozens to thousands an op). The chains the step runs as one
// XLA fusion on the TPU (a product then a sum, a product then a tree sum)
// are one launch of expfuse.cu or exptree.cu.
//
// expmap<NW, OP>   one expansion op over a broadcast shape of up to six
//   dims, one output element a thread: OP_ADD, OP_SUB, OP_MUL, OP_DIV
//   (csrc/expansion.cuh exp_add/exp_sub/exp_mul/exp_div), OP_NEG, and
//   OP_SYM, exp_add(x, y) then 0.5 * each word (dd/linalg.py dd_symmetrize,
//   y = x^T read through swapped strides). Each word of each operand is
//   read where it lies, through its own pointer and strides (0 on a
//   broadcast axis; csrc/expview.cuh); the output is [NW, numel],
//   contiguous. At the step's sizes (1 to ~10^5 elements) bound by
//   latency: the launch, one load round trip and one element's chain
//   (~200 dependent operations for an add at nw 5, ~3,000 for a division).
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
#include "expview.cuh"

namespace {

using namespace clrs;

constexpr int EXPMAP_THREADS = 128;

enum : int { OP_ADD = 0, OP_SUB = 1, OP_MUL = 2, OP_DIV = 3, OP_NEG = 4, OP_SYM = 5 };

template <int NW, int OP>
__global__ void __launch_bounds__(EXPMAP_THREADS)
    expmap(View a, View b, Dims dm, float* __restrict__ out, unsigned numel) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= numel) return;
  int ix[MAXD];
  unravel(idx, dm, ix);
  float x[NW], r[NW];
  load_view<NW>(a, ix, x);
  if constexpr (OP == OP_NEG) {
#pragma unroll
    for (int k = 0; k < NW; ++k) r[k] = -x[k];
  } else {
    float y[NW];
    load_view<NW>(b, ix, y);
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

}  // namespace

extern "C" {

// ptrs [2][8] word pointers, strides [2][8][6] element strides over the
// right-aligned shape dims [nd] (the wrapper coalesces it to nd <= 6),
// shared [2]; out [nw, numel] contiguous; numel in 1 .. 2^31 - 1.
int clrs_expmap(int op, const void* const* ptrs, const long long* strides, const int* shared,
                const int* dims, int nd, float* out, long long numel, int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Dims dm;
  if (op < OP_ADD || op > OP_SYM || numel <= 0 || numel >= (1LL << 31) || !make_dims(dims, nd, 0, dm))
    return static_cast<int>(cudaErrorInvalidValue);
  long long prod = 1;
  for (int d = 0; d < nd; ++d) prod *= dims[d];
  if (prod != numel) return static_cast<int>(cudaErrorInvalidValue);
  const View a = make_view(ptrs, strides, shared[0]);
  const View b = make_view(ptrs + MAXW, strides + MAXW * MAXD, shared[1]);
  CLRS_DISPATCH_NW(nw, {
    const int rc = launch_expmap<NWc>(op, a, b, dm, out, static_cast<unsigned>(numel), s);
    if (rc != 0) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
