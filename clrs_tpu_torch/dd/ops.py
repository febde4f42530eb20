"""f32-expansion arithmetic on torch tensors.

A value is a tuple of nw same-shape float32 tensors whose exact sum is the
represented number (nw = 5 carries about 106 bits). These are the
sort-free, barrier-free forms of ``clrs_tpu/dd/expops.py`` (the forms the
JAX package's TPU path and its Pallas kernels compute), ported op for op:

- ``two_prod`` splits with a bit mask (clear the low 12 mantissa bits), so
  every half-product is exact in f32 and FMA contraction cannot change a
  bit;
- ``exp_add`` emits word-wise two_sums in diagonal order, which is sorted by
  magnitude class, so plain vec_sum sweeps renormalise without a presort;
- ``exp_div``/``exp_rsqrt`` run progressively widening Newton iterations in
  exponent-scaled space, with powers of two built from bits.

Eager PyTorch rounds every op separately (IEEE f32, round to nearest even,
subnormals kept), so on the CPU these functions are bit-identical to the
JAX forms. ``csrc/expansion.cuh`` mirrors them op for op for the CUDA
kernels. The Newton seeds are IEEE ``1 / y`` and ``1 / sqrt(x)``; the JAX
``_rsqrt_core`` seeds with ``lax.rsqrt``, so ``exp_rsqrt`` and ``exp_sqrt``
agree with it to a stated tolerance, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["two_sum", "quick_two_sum", "split_f32", "two_prod", "vec_sum",
           "renorm", "exp_neg", "exp_add", "exp_sub", "exp_mul",
           "exp_mul_f32", "exp_mul_pow2", "exp_div", "exp_rsqrt", "exp_sqrt",
           "exp_scale_f64", "f32_exp", "f32_pow2"]

_MASK12 = -4096  # 0xFFFFF000 as int32: clear the low 12 of 23 mantissa bits


def two_sum(a, b):
    """Error-free sum (Knuth, branch-free): s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split_f32(a):
    """Exact split of f32 ``a`` into (hi, lo) by bit mask; both halves have
    at most 12 significant bits. Host scalars split with numpy."""
    if isinstance(a, (int, float, np.floating)):
        av = np.float32(a)
        hi = np.uint32(av.view(np.uint32) & np.uint32(0xFFFFF000)) \
            .view(np.float32)
        return float(hi), float(np.float32(av - hi))
    hi = (a.view(torch.int32) & _MASK12).view(torch.float32)
    return hi, a - hi


def two_prod(a, b, a_split=None, b_split=None):
    """Error-free product via mask splits: p + e == a * b exactly."""
    ahi, alo = a_split if a_split is not None else split_f32(a)
    bhi, blo = b_split if b_split is not None else split_f32(b)
    p = a * b
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def vec_sum(cs):
    """One bottom-up two_sum sweep (value-preserving)."""
    n = len(cs)
    out = [None] * n
    s = cs[n - 1]
    for i in range(n - 2, -1, -1):
        s, e = two_sum(cs[i], s)
        out[i + 1] = e
    out[0] = s
    return out


def renorm(cs, nw, sweeps=3):
    """Compress a magnitude-class-ordered list of words to nw words."""
    cs = list(cs)
    for _ in range(sweeps):
        cs = vec_sum(cs)
    while len(cs) > nw:
        t = cs.pop()
        cs[-1] = cs[-1] + t
    return tuple(cs)


def exp_neg(x):
    return tuple(-c for c in x)


def exp_add(x, y):
    """nw-word + nw-word -> nw words (error O(eps^nw) of the result)."""
    nw = len(x)
    ss, es = [], []
    for a, b in zip(x, y):
        s, e = two_sum(a, b)
        ss.append(s)
        es.append(e)
    cs = [ss[0]]
    for i in range(1, nw):
        cs.append(ss[i])
        cs.append(es[i - 1])
    cs.append(es[-1])
    return renorm(cs, nw)


def exp_sub(x, y):
    return exp_add(x, exp_neg(y))


def exp_mul(x, y):
    """nw-word product (error O(eps^nw)); each word is split once."""
    nw = len(x)
    if nw == 1:
        return (x[0] * y[0],)
    xs = [split_f32(c) for c in x[: nw - 1]]
    ys = [split_f32(c) for c in y[: nw - 1]]
    cs = []
    prev_errs = []
    for d in range(nw - 1):
        ps, errs = [], []
        for i in range(d + 1):
            p, e = two_prod(x[i], y[d - i], xs[i], ys[d - i])
            ps.append(p)
            errs.append(e)
        cs.extend(ps)
        cs.extend(prev_errs)
        prev_errs = errs
    last = x[0] * y[nw - 1]
    for i in range(1, nw):
        last = last + x[i] * y[nw - 1 - i]
    for e in prev_errs:
        last = last + e
    cs.append(last)
    return renorm(cs, nw)


def exp_mul_f32(x, a, a_split=None):
    """nw-word times one f32 word (tensor or host scalar)."""
    nw = len(x)
    if nw == 1:
        return (x[0] * a,)
    asp = a_split if a_split is not None else split_f32(a)
    cs = []
    prev_e = None
    for i in range(nw - 1):
        p, e = two_prod(x[i], a, None, asp)
        cs.append(p)
        if prev_e is not None:
            cs.append(prev_e)
        prev_e = e
    cs.append(x[nw - 1] * a + prev_e)
    return renorm(cs, nw)


def f32_exp(v):
    """Biased-exponent field of f32 ``v`` minus 127 (int32, exact bits)."""
    return ((v.view(torch.int32) >> 23) & 0xFF) - 127


def f32_pow2(e):
    """Exact f32 2^e for int32 ``e`` with |e| <= 126, built from bits."""
    return ((e + 127) << 23).view(torch.float32)


def exp_mul_pow2(x, e, steps=3):
    """Exact scaling of every word by 2^e (int32 tensor e, |e| <= 126*steps)."""
    fs = []
    rem = e
    for _ in range(steps):
        h = torch.clamp(rem, -126, 126)
        fs.append(f32_pow2(h))
        rem = rem - h
    out = []
    for c in x:
        for f in fs:
            c = c * f
        out.append(c)
    return tuple(out)


def _ex_scalar(v, like, nw):
    z = like * 0.0
    return (v + z,) + (z,) * (nw - 1)


def _widen(r, w):
    z = r[0] * 0.0
    return tuple(r) + (z,) * (w - len(r))


def _recip_core(y):
    """Progressively-widening Newton reciprocal; y ~ [1, 2)."""
    nw = len(y)
    r = (1.0 / y[0],)
    w = 1
    while w < nw:
        w = min(2 * w, nw)
        rw = _widen(r, w)
        e = exp_add(_ex_scalar(1.0, y[0], w), exp_neg(exp_mul(y[:w], rw)))
        r = exp_add(rw, exp_mul(rw, e))
    return r


def exp_div(x, y):
    """x / y in exponent-scaled space."""
    k = f32_exp(y[0])
    ys = exp_mul_pow2(y, -k)
    r = _recip_core(ys)
    q1 = exp_mul(x, r)
    resid = exp_add(x, exp_neg(exp_mul(ys, q1)))
    q = exp_add(q1, exp_mul(resid, r))
    return exp_mul_pow2(q, -k)


def _rsqrt_core(x):
    nw = len(x)
    # the IEEE seed of the CUDA kernels, __fdiv_rn(1, __fsqrt_rn(x)): f32
    # torch.sqrt on the CPU is not correctly rounded on every build; the
    # f64 root rounded to f32 is (53 >= 2 * 24 + 2)
    r = (1.0 / torch.sqrt(x[0].double()).float(),)
    w = 1
    while w < nw:
        w = min(2 * w, nw)
        rw = _widen(r, w)
        t = exp_mul(x[:w], exp_mul(rw, rw))
        e = exp_mul_f32(exp_add(t, _ex_scalar(-1.0, t[0], w)), -0.5)
        r = exp_add(rw, exp_mul(rw, e))
    return r


def exp_rsqrt(x):
    """Inverse square root (positive inputs; caller guards)."""
    e = f32_exp(x[0])
    m = e >> 1
    xs = exp_mul_pow2(x, -2 * m)                 # ~ [1, 4)
    r = _rsqrt_core(xs)
    return exp_mul_pow2(r, -m)


def exp_sqrt(x):
    e = f32_exp(x[0])
    m = e >> 1
    xs = exp_mul_pow2(x, -2 * m)
    y = _rsqrt_core(xs)
    r = exp_mul(xs, y)
    resid = exp_add(xs, exp_neg(exp_mul(r, r)))
    r = exp_add(r, exp_mul_f32(exp_mul(resid, y), 0.5))
    return exp_mul_pow2(r, m)


def exp_scale_f64(x, v):
    """Multiply an expansion by an f64 scalar (tensor or float), split into
    three exactly representable f32 words first."""
    v = torch.as_tensor(v, dtype=torch.float64, device=x[0].device)
    words = []
    r = v
    for _ in range(3):
        w = r.to(torch.float32)
        words.append(w)
        r = r - w.to(torch.float64)
    nw = len(x)
    out = exp_mul_f32(x, words[0])
    for wv in words[1:]:
        out = exp_add(out, exp_mul_f32(x, wv))
    return out[:nw]


def broadcast_shapes(*shapes):
    """The broadcast of ``shapes`` (``torch.broadcast_shapes`` computes it
    through its symbolic-shape module, which imports sympy; the port runs
    where sympy is absent)."""
    n = max((len(s) for s in shapes), default=0)
    out = []
    for dims in zip(*((1,) * (n - len(s)) + tuple(s) for s in shapes)):
        big = {d for d in dims if d != 1}
        if len(big) > 1:
            raise RuntimeError(f"shapes {shapes} do not broadcast")
        out.append(big.pop() if big else 1)
    return torch.Size(out)
