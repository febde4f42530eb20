// The step's fused expansion forms (sm_90a): the product-sum chains of the
// IPM step as one launch each, and the commit's select. Plain C interface,
// loaded by clrs_tpu_torch/dd/build.py through ctypes.
//
// Replaces: the XLA fusions of the jitted TPU step
// (clrs_tpu/solver/step.py:1621) over the expops forms
// (clrs_tpu/dd/core.py:448-499) at the step's product-then-sum sites: the
// state update x + dx alpha (clrs_tpu/solver/step.py:1244-1260 for the
// scalar pack and x, y), the scalar pack's residual mu 1 - Xs Ys [- dXs dYs]
// (:1387), its Z and dY numerators (:1433, :1494), and the masked residual
// (wA - X - sign C) mask (:882-918); and the commit's per-leaf
// jnp.where(commit, ...) (:1661-1666). In the port each form's plain
// version is the composition of dd/kernels.py's plain ops (ew_*_plain,
// the word scales of solver/step.py's _dd_scale, torch.where).
//
// expfuse<NW, FORM>: one output element a thread, over a broadcast shape
// of up to six dims, operands read through their views (csrc/expview.cuh):
//   FMA   a + b c          FMS   a - b c          MSUB  a b - c
//   MMS   a b - c d        SUB2  (a - b) - c
// One operand may be scaled on load by an exact word or constant (the
// sign on C in SUB2), and the result by an exact {0,1} mask; every
// intermediate stays in registers as f32 words, so each form is the plain
// op sequence bit for bit. The output is written through its own view.
// Bound, as expmap<NW, OP>, by latency at the step's sizes (the launch, one
// load round trip, one element's chain of ~400-900 operations at nw 5); a
// form saves the launches and the device-memory round trips of its
// intermediates (two or three of each a site).
//
// expselect<NW>: dst = cond ? src : dst for every word of up to MAXSEG
// contiguous (src, dst) pairs, cond a device bool read by the kernel (no
// host read); in place, so the commit's copy back into the state goes with
// the select. Bound by bytes: nw words of each leaf read and written where
// cond holds (nothing moves where it does not).
#include <cuda_runtime.h>

#include "common.cuh"
#include "expansion.cuh"
#include "expview.cuh"

namespace {

using namespace clrs;

constexpr int FUSE_THREADS = 128;
constexpr int SELECT_THREADS = 256;
constexpr int MAXSEG = 24;

enum : int { F_FMA = 0, F_FMS = 1, F_MSUB = 2, F_MMS = 3, F_SUB2 = 4 };

__host__ __device__ constexpr int operands(int form) { return form == F_MMS ? 4 : 3; }

// All words of the output share one set of strides.
struct OutView {
  float* w[MAXW];
  long long st[MAXD];
};

struct FuseArgs {
  View v[4];
  Word1 sc;      // the scale of operand sc_op (sc_op < 0: none)
  Word1 mask;    // the result's mask (has_mask)
  OutView out;
  Dims dm;
  unsigned numel;
  int sc_op, has_mask;
};

template <int NW, int FORM>
__global__ void __launch_bounds__(FUSE_THREADS) expfuse(FuseArgs a) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.numel) return;
  int ix[MAXD];
  unravel(idx, a.dm, ix);
  float o[4][NW];
#pragma unroll
  for (int j = 0; j < operands(FORM); ++j) {
    load_view<NW>(a.v[j], ix, o[j]);
    if (j == a.sc_op) scale_words<NW>(o[j], load_word1(a.sc, ix));
  }
  float r[NW];
  if constexpr (FORM == F_FMA || FORM == F_FMS) {
    float p[NW];
    exp_mul<NW>(o[1], o[2], p);
    if constexpr (FORM == F_FMA) {
      exp_add<NW>(o[0], p, r);
    } else {
      exp_sub<NW>(o[0], p, r);
    }
  } else if constexpr (FORM == F_MSUB) {
    float p[NW];
    exp_mul<NW>(o[0], o[1], p);
    exp_sub<NW>(p, o[2], r);
  } else if constexpr (FORM == F_MMS) {
    float p[NW], q[NW];
    exp_mul<NW>(o[0], o[1], p);
    exp_mul<NW>(o[2], o[3], q);
    exp_sub<NW>(p, q, r);
  } else {
    float d[NW];
    exp_sub<NW>(o[0], o[1], d);
    exp_sub<NW>(d, o[2], r);
  }
  if (a.has_mask) scale_words<NW>(r, load_word1(a.mask, ix));
  const long long off = offset(a.out.st, ix);
#pragma unroll
  for (int k = 0; k < NW; ++k) a.out.w[k][off] = r[k];
}

struct Seg {
  float* d[MAXW];
  const float* s[MAXW];
  unsigned start, n;  // first thread index, elements
};

struct SelectArgs {
  const bool* cond;
  Seg seg[MAXSEG];
  int nseg;
  unsigned total;
};

template <int NW>
__global__ void __launch_bounds__(SELECT_THREADS) expselect(SelectArgs a) {
  if (!*a.cond) return;
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.total) return;
#pragma unroll
  for (int j = 0; j < MAXSEG; ++j) {
    if (j < a.nseg && idx >= a.seg[j].start && idx - a.seg[j].start < a.seg[j].n) {
      const unsigned e = idx - a.seg[j].start;
#pragma unroll
      for (int k = 0; k < NW; ++k) a.seg[j].d[k][e] = __ldg(a.seg[j].s[k] + e);
    }
  }
}

template <int NW>
int launch_fuse(int form, const FuseArgs& a, cudaStream_t s) {
  const dim3 grid((a.numel + FUSE_THREADS - 1) / FUSE_THREADS);
  switch (form) {
    case F_FMA: expfuse<NW, F_FMA><<<grid, FUSE_THREADS, 0, s>>>(a); break;
    case F_FMS: expfuse<NW, F_FMS><<<grid, FUSE_THREADS, 0, s>>>(a); break;
    case F_MSUB: expfuse<NW, F_MSUB><<<grid, FUSE_THREADS, 0, s>>>(a); break;
    case F_MMS: expfuse<NW, F_MMS><<<grid, FUSE_THREADS, 0, s>>>(a); break;
    case F_SUB2: expfuse<NW, F_SUB2><<<grid, FUSE_THREADS, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <int NW>
void launch_select(const SelectArgs& a, cudaStream_t s) {
  const dim3 grid((a.total + SELECT_THREADS - 1) / SELECT_THREADS);
  expselect<NW><<<grid, SELECT_THREADS, 0, s>>>(a);
}

}  // namespace

extern "C" {

// ptrs [4][8], strides [4][8][6] and shared [4] of the operands over the
// shape dims [nd] (right-aligned); scale (scale_st [6]) or, null, the
// constant scale_c, applied to operand sc_op (-1: none); mask (mask_st
// [6]) or null; out [8] word pointers, out_st [6]; numel in 1 .. 2^31 - 1.
int clrs_expfuse(int form, const void* const* ptrs, const long long* strides, const int* shared,
                 const float* scale, const long long* scale_st, float scale_c, int sc_op,
                 const float* mask, const long long* mask_st, void* const* out,
                 const long long* out_st, const int* dims, int nd, long long numel, int nw,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FuseArgs a{};
  if (form < F_FMA || form > F_SUB2 || numel <= 0 || numel >= (1LL << 31) ||
      sc_op < -1 || sc_op >= operands(form) || !make_dims(dims, nd, 0, a.dm))
    return static_cast<int>(cudaErrorInvalidValue);
  long long prod = 1;
  for (int d = 0; d < nd; ++d) prod *= dims[d];
  if (prod != numel) return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < 4; ++j)
    a.v[j] = make_view(ptrs + j * MAXW, strides + j * MAXW * MAXD, shared[j]);
  a.sc = make_word1(scale, scale_st, scale_c);
  a.mask = make_word1(mask, mask_st, 1.0f);
  a.has_mask = mask != nullptr;
  a.sc_op = sc_op;
  for (int k = 0; k < MAXW; ++k) a.out.w[k] = static_cast<float*>(out[k]);
  for (int d = 0; d < MAXD; ++d) a.out.st[d] = out_st[d];
  a.numel = static_cast<unsigned>(numel);
  CLRS_DISPATCH_NW(nw, {
    const int rc = launch_fuse<NWc>(form, a, s);
    if (rc != 0) return rc;
  });
  return static_cast<int>(cudaGetLastError());
}

// cond: a device bool; dst [nseg][8], src [nseg][8] word pointers of
// contiguous words, numel [nseg] (each > 0); nseg in 1 .. MAXSEG: one
// launch.
int clrs_expselect(const void* cond, void* const* dst, const void* const* src,
                   const long long* numel, int nseg, int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SelectArgs a{};
  if (cond == nullptr || nseg < 1 || nseg > MAXSEG) return static_cast<int>(cudaErrorInvalidValue);
  long long total = 0;
  for (int j = 0; j < nseg; ++j) {
    if (numel[j] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    a.seg[j].start = static_cast<unsigned>(total);
    a.seg[j].n = static_cast<unsigned>(numel[j]);
    for (int k = 0; k < MAXW; ++k) {
      a.seg[j].d[k] = static_cast<float*>(dst[j * MAXW + k]);
      a.seg[j].s[k] = static_cast<const float*>(src[j * MAXW + k]);
    }
    total += numel[j];
    if (total >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  }
  a.cond = static_cast<const bool*>(cond);
  a.nseg = nseg;
  a.total = static_cast<unsigned>(total);
  CLRS_DISPATCH_NW(nw, { launch_select<NWc>(a, s); });
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
