// f32-expansion arithmetic for the CUDA kernels of clrs_tpu_torch.
//
// Mirrors clrs_tpu_torch/dd/ops.py op for op (which mirrors the JAX
// package's clrs_tpu/dd/expops.py): the same IEEE f32 operations in the same
// order, so a kernel and its plain PyTorch version agree bit for bit on the
// card. Every add, subtract and multiply is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fsub_rn, __fmul_rn), which nvcc never contracts
// into an FMA; the build also passes -fmad=false. Subnormals are kept
// (-ftz=false), as PyTorch's own CUDA kernels keep them.
//
// A value is a float array of NW words. Outputs never alias inputs.
#pragma once

#include <cstdint>

namespace clrs {

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

// Knuth's branch-free error-free sum: s + e == a + b exactly.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = fadd(a, b);
  const float bb = fsub(s, a);
  e = fadd(fsub(a, fsub(s, bb)), fsub(b, bb));
}

// Bit-mask split: hi keeps the top 12 mantissa bits, lo = a - hi (exact).
__device__ __forceinline__ void split_f32(float a, float& hi, float& lo) {
  hi = __int_as_float(__float_as_int(a) & static_cast<int>(0xFFFFF000u));
  lo = fsub(a, hi);
}

// Error-free product from precomputed splits: p + e == a * b exactly.
__device__ __forceinline__ void two_prod(float a, float b, float ahi, float alo,
                                         float bhi, float blo, float& p, float& e) {
  p = fmul(a, b);
  e = fadd(fadd(fadd(fsub(fmul(ahi, bhi), p), fmul(ahi, blo)), fmul(alo, bhi)),
           fmul(alo, blo));
}

// One bottom-up two_sum sweep over cs[0..N), in place.
template <int N>
__device__ __forceinline__ void vec_sum(float* cs) {
  float s = cs[N - 1];
#pragma unroll
  for (int i = N - 2; i >= 0; --i) {
    float e;
    two_sum(cs[i], s, s, e);
    cs[i + 1] = e;
  }
  cs[0] = s;
}

// Three sweeps, then fold the words past NW into the last kept word.
template <int N, int NW>
__device__ __forceinline__ void renorm(float* cs, float* out) {
  vec_sum<N>(cs);
  vec_sum<N>(cs);
  vec_sum<N>(cs);
#pragma unroll
  for (int i = N - 1; i >= NW; --i) cs[i - 1] = fadd(cs[i - 1], cs[i]);
#pragma unroll
  for (int i = 0; i < NW; ++i) out[i] = cs[i];
}

template <int NW>
__device__ __forceinline__ void exp_add(const float* x, const float* y, float* out) {
  float ss[NW], es[NW], cs[2 * NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) two_sum(x[i], y[i], ss[i], es[i]);
  cs[0] = ss[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    cs[2 * i - 1] = ss[i];
    cs[2 * i] = es[i - 1];
  }
  cs[2 * NW - 1] = es[NW - 1];
  renorm<2 * NW, NW>(cs, out);
}

template <int NW>
__device__ __forceinline__ void exp_sub(const float* x, const float* y, float* out) {
  float ny[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) ny[i] = -y[i];
  exp_add<NW>(x, ny, out);
}

template <int NW>
__device__ __forceinline__ void exp_mul(const float* x, const float* y, float* out) {
  if constexpr (NW == 1) {
    out[0] = fmul(x[0], y[0]);
  } else {
    constexpr int NC = (NW - 1) * (NW - 1) + 1;
    float xh[NW], xl[NW], yh[NW], yl[NW];
#pragma unroll
    for (int i = 0; i < NW - 1; ++i) {
      split_f32(x[i], xh[i], xl[i]);
      split_f32(y[i], yh[i], yl[i]);
    }
    float cs[NC];
    float prev[NW], errs[NW];
    int c = 0;
#pragma unroll
    for (int d = 0; d < NW - 1; ++d) {
#pragma unroll
      for (int i = 0; i <= d; ++i)
        two_prod(x[i], y[d - i], xh[i], xl[i], yh[d - i], yl[d - i], cs[c++], errs[i]);
#pragma unroll
      for (int t = 0; t < d; ++t) cs[c++] = prev[t];
#pragma unroll
      for (int i = 0; i <= d; ++i) prev[i] = errs[i];
    }
    float last = fmul(x[0], y[NW - 1]);
#pragma unroll
    for (int i = 1; i < NW; ++i) last = fadd(last, fmul(x[i], y[NW - 1 - i]));
#pragma unroll
    for (int t = 0; t < NW - 1; ++t) last = fadd(last, prev[t]);
    cs[c] = last;
    renorm<NC, NW>(cs, out);
  }
}

// Expansion times one f32 word a, given a's split.
template <int NW>
__device__ __forceinline__ void exp_mul_f32(const float* x, float a, float ahi,
                                            float alo, float* out) {
  if constexpr (NW == 1) {
    out[0] = fmul(x[0], a);
  } else {
    float cs[2 * NW - 2];
    float prev = 0.0f;
    int c = 0;
#pragma unroll
    for (int i = 0; i < NW - 1; ++i) {
      float xh, xl, p, e;
      split_f32(x[i], xh, xl);
      two_prod(x[i], a, xh, xl, ahi, alo, p, e);
      cs[c++] = p;
      if (i > 0) cs[c++] = prev;
      prev = e;
    }
    cs[c] = fadd(fmul(x[NW - 1], a), prev);
    renorm<2 * NW - 2, NW>(cs, out);
  }
}

// Exponent field minus 127 (exact bits).
__device__ __forceinline__ int f32_exp(float v) {
  return static_cast<int>((__float_as_uint(v) >> 23) & 0xFFu) - 127;
}

// Exact 2^e for |e| <= 126, built from bits (never exp2f/ldexpf).
__device__ __forceinline__ float f32_pow2(int e) {
  return __uint_as_float(static_cast<unsigned>(e + 127) << 23);
}

__device__ __forceinline__ int clip126(int v) { return v < -126 ? -126 : (v > 126 ? 126 : v); }

// x * 2^e for one word with STEPS clipped power-of-two factors.
template <int STEPS>
__device__ __forceinline__ float mul_pow2_word(float x, int e) {
  int rem = e;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int h = clip126(rem);
    x = fmul(x, f32_pow2(h));
    rem -= h;
  }
  return x;
}

// Every word times 2^e: the factors are built once, then applied per word
// in the same order (ops.exp_mul_pow2).
template <int NW, int STEPS>
__device__ __forceinline__ void exp_mul_pow2(const float* x, int e, float* out) {
  float fs[STEPS];
  int rem = e;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    const int h = clip126(rem);
    fs[s] = f32_pow2(h);
    rem -= h;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    float c = x[i];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) c = fmul(c, fs[s]);
    out[i] = c;
  }
}

// One progressively widening Newton step of the reciprocal at width W2,
// then the next; r holds W valid words on entry.
template <int NW, int W>
__device__ __forceinline__ void recip_steps(const float* y, float* r) {
  if constexpr (W < NW) {
    constexpr int W2 = (2 * W < NW) ? 2 * W : NW;
    float rw[W2], one[W2], t[W2], e[W2], u[W2], rn[W2];
    const float z = fmul(r[0], 0.0f);
#pragma unroll
    for (int i = 0; i < W2; ++i) rw[i] = i < W ? r[i] : z;
    const float yz = fmul(y[0], 0.0f);
    one[0] = fadd(1.0f, yz);
#pragma unroll
    for (int i = 1; i < W2; ++i) one[i] = yz;
    exp_mul<W2>(y, rw, t);
#pragma unroll
    for (int i = 0; i < W2; ++i) t[i] = -t[i];
    exp_add<W2>(one, t, e);
    exp_mul<W2>(rw, e, u);
    exp_add<W2>(rw, u, rn);
#pragma unroll
    for (int i = 0; i < W2; ++i) r[i] = rn[i];
    recip_steps<NW, W2>(y, r);
  }
}

template <int NW>
__device__ __forceinline__ void exp_div(const float* x, const float* y, float* out) {
  const int k = f32_exp(y[0]);
  float ys[NW], r[NW], q1[NW], t[NW], resid[NW], u[NW], q[NW];
  exp_mul_pow2<NW, 3>(y, -k, ys);
  r[0] = __fdiv_rn(1.0f, ys[0]);
  recip_steps<NW, 1>(ys, r);
  exp_mul<NW>(x, r, q1);
  exp_mul<NW>(ys, q1, t);
#pragma unroll
  for (int i = 0; i < NW; ++i) t[i] = -t[i];
  exp_add<NW>(x, t, resid);
  exp_mul<NW>(resid, r, u);
  exp_add<NW>(q1, u, q);
  exp_mul_pow2<NW, 3>(q, -k, out);
}

template <int NW, int W>
__device__ __forceinline__ void rsqrt_steps(const float* x, float* r) {
  if constexpr (W < NW) {
    constexpr int W2 = (2 * W < NW) ? 2 * W : NW;
    float rw[W2], rr[W2], t[W2], m1[W2], s[W2], e[W2], u[W2], rn[W2];
    const float z = fmul(r[0], 0.0f);
#pragma unroll
    for (int i = 0; i < W2; ++i) rw[i] = i < W ? r[i] : z;
    exp_mul<W2>(rw, rw, rr);
    exp_mul<W2>(x, rr, t);
    const float tz = fmul(t[0], 0.0f);
    m1[0] = fadd(-1.0f, tz);
#pragma unroll
    for (int i = 1; i < W2; ++i) m1[i] = tz;
    exp_add<W2>(t, m1, s);
    float hh, hl;
    split_f32(-0.5f, hh, hl);
    exp_mul_f32<W2>(s, -0.5f, hh, hl, e);
    exp_mul<W2>(rw, e, u);
    exp_add<W2>(rw, u, rn);
#pragma unroll
    for (int i = 0; i < W2; ++i) r[i] = rn[i];
    rsqrt_steps<NW, W2>(x, r);
  }
}

// Inverse square root of a positive expansion (caller guards the sign).
template <int NW>
__device__ __forceinline__ void exp_rsqrt(const float* x, float* out) {
  const int e = f32_exp(x[0]);
  const int m = e >> 1;
  float xs[NW], r[NW];
  exp_mul_pow2<NW, 3>(x, -2 * m, xs);
  r[0] = __fdiv_rn(1.0f, __fsqrt_rn(xs[0]));  // IEEE seed, as the plain 1/sqrt
  rsqrt_steps<NW, 1>(xs, r);
  exp_mul_pow2<NW, 3>(r, -m, out);
}

}  // namespace clrs
