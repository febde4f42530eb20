// Strided word views of f32 expansions for the kernels of the step's
// expansion arithmetic (expmap.cu, exptree.cu, expfuse.cu).
//
// An operand is nw float tensors read where they lie: word k of the element
// at multi-index ix is w[k][sum_d ix[d] st[k][d]], with stride 0 on a
// broadcast axis, so no operand is ever copied to a common layout. The
// shape is right-aligned in MAXD dims (dims first..MAXD-1 are in use); a
// tree sum splits it into column dims [first, split) and entry dims
// [split, MAXD), the entries of a column taken in row-major order.
#pragma once

#include <cuda_runtime.h>

namespace clrs {

constexpr int MAXW = 8;   // words of an operand
constexpr int MAXD = 6;   // dims of the (coalesced) broadcast shape

// `shared`: every word has word 0's strides, so one offset serves all words.
struct View {
  const float* w[MAXW];
  long long st[MAXW][MAXD];
  int shared;
};

// One f32 word over the shape (a {0,1} mask or a power-of-two scale): p
// null means the constant c.
struct Word1 {
  const float* p;
  long long st[MAXD];
  float c;
};

struct Dims {
  int n[MAXD];
  int first;  // the first dim in use
  int split;  // the first entry dim of a tree sum (MAXD: none)
};

// idx unravelled over dims [lo, hi) (row-major, last dim fastest) into ix.
__device__ __forceinline__ void unravel_range(unsigned idx, const Dims& dm, int lo, int hi,
                                              int* ix) {
#pragma unroll
  for (int d = MAXD - 1; d >= 0; --d) {
    if (d >= lo && d < hi) {
      const unsigned nd = static_cast<unsigned>(dm.n[d]);
      ix[d] = static_cast<int>(idx % nd);
      idx /= nd;
    }
  }
}

__device__ __forceinline__ void unravel(unsigned idx, const Dims& dm, int* ix) {
#pragma unroll
  for (int d = 0; d < MAXD; ++d) ix[d] = 0;
  unravel_range(idx, dm, dm.first, MAXD, ix);
}

__device__ __forceinline__ long long offset(const long long* st, const int* ix) {
  long long o = 0;
#pragma unroll
  for (int d = 0; d < MAXD; ++d) o += ix[d] * st[d];
  return o;
}

// Words k < N of the element at ix.
template <int N>
__device__ __forceinline__ void load_view(const View& v, const int* ix, float* out) {
  if (v.shared) {
    const long long o = offset(v.st[0], ix);
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = __ldg(v.w[k] + o);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = __ldg(v.w[k] + offset(v.st[k], ix));
  }
}

__device__ __forceinline__ float load_word1(const Word1& s, const int* ix) {
  return s.p ? __ldg(s.p + offset(s.st, ix)) : s.c;
}

// Every word times one exact f32 factor (the plain version's c * a).
template <int N>
__device__ __forceinline__ void scale_words(float* x, float s) {
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = __fmul_rn(x[k], s);
}

// ---------------------------------------------------------------------------
// host side: the views from the wrappers' flat ctypes arrays
// ---------------------------------------------------------------------------

// ptrs [MAXW], strides [MAXW][MAXD] (right-aligned).
inline View make_view(const void* const* ptrs, const long long* strides, int shared) {
  View v{};
  for (int k = 0; k < MAXW; ++k) {
    v.w[k] = static_cast<const float*>(ptrs[k]);
    for (int d = 0; d < MAXD; ++d) v.st[k][d] = strides[k * MAXD + d];
  }
  v.shared = shared;
  return v;
}

// p null: the constant c (st may then be null too).
inline Word1 make_word1(const float* p, const long long* st, float c) {
  Word1 s{};
  s.p = p;
  for (int d = 0; d < MAXD; ++d) s.st[d] = (p && st) ? st[d] : 0;
  s.c = c;
  return s;
}

// dims [nd], right-aligned; the last ne of them are a tree sum's entry dims.
inline bool make_dims(const int* dims, int nd, int ne, Dims& dm) {
  if (nd < 0 || nd > MAXD || ne < 0 || ne > nd) return false;
  dm.first = MAXD - nd;
  dm.split = MAXD - ne;
  for (int d = 0; d < MAXD; ++d) {
    dm.n[d] = d >= dm.first ? dims[d - dm.first] : 1;
    if (dm.n[d] <= 0) return false;
  }
  return true;
}

}  // namespace clrs
