"""Multi-word float64 arithmetic on torch tensors (the f64 substrate).

A value is a tuple of nw same-shape float64 tensors whose exact sum is the
represented number: nw = 2 is the double word (about 106 bits), nw >= 3
the n-word expansion (about 53 nw bits). This is the torch half of
``clrs_tpu/dd/core.py`` on f64 words, ported op for op in the order the
JAX package runs it off the TPU:

- the error-free transforms without FMA (Knuth two_sum, Dekker split with
  2^27 + 1, Dekker two_prod);
- :func:`renorm` takes the JAX ``_renorm_scan`` order whenever it compresses
  (more words than it keeps): VecSum sweeps, then the sub-target words
  folded into the last kept word in increasing order
  (clrs_tpu/dd/core.py:143-166). The presort is a stable sort on the
  negated magnitudes, as ``jnp.argsort``;
- double-word forms for nw = 2 and the n-word forms (progressively
  widening Newton for the reciprocal and the inverse square root) for
  nw >= 3, dispatching on the word count as ``dd.core`` does.

Eager PyTorch rounds every op on its own (IEEE f64, round to nearest even);
no op here is fused, so nothing is FMA-contracted. The Newton seeds need a
correctly rounded square root: on the card ``torch.sqrt`` is, on the CPU
it is not for large tensors (a vectorised library routine, off by an ulp
on about 0.6% of inputs), so :func:`sqrt_rn` takes numpy's there.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["two_sum", "quick_two_sum", "split", "two_prod", "vec_sum",
           "renorm", "sqrt_rn", "qd_add", "qd_mul", "qd_mul_f64", "qd_div",
           "qd_rsqrt", "qd_sqrt", "qd_neg", "dd_add", "dd_add_f64",
           "dd_neg", "dd_sub", "dd_mul", "dd_mul_f64", "dd_div", "dd_rsqrt",
           "dd_sqrt", "dd_abs", "dd_max", "dd_min", "dd_where", "dd_lt"]

_SPLIT = 134217729.0    # 2**27 + 1, Dekker's split constant for binary64


def two_sum(a, b):
    """Error-free sum: s = fl(a + b), s + e = a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Error-free sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split into two halves of at most 26 significant bits."""
    t = _SPLIT * a
    ahi = t - (t - a)
    alo = a - ahi
    return ahi, alo


def two_prod(a, b):
    """Error-free product: p = fl(a b), p + e = a b exactly."""
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def sqrt_rn(x):
    """The correctly rounded f64 square root (IEEE ``sqrt``)."""
    if x.device.type == "cpu":
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.detach().numpy()))
    return torch.sqrt(x)


def vec_sum(cs):
    """One bottom-up two_sum sweep: value-preserving; cs[0] becomes
    fl(sum)."""
    n = len(cs)
    out = [None] * n
    s = cs[n - 1]
    for i in range(n - 2, -1, -1):
        s, e = two_sum(cs[i], s)
        out[i + 1] = e
    out[0] = s
    return out


def _presort(W):
    """Words sorted by descending magnitude per element, stably (the order
    of ``jnp.argsort(-abs(W), axis=0)``; NaN last)."""
    idx = torch.sort(-W.abs(), dim=0, stable=True).indices
    return torch.gather(W, 0, idx)


def renorm(cs, nw, sweeps=3, presort=False):
    """Compress an expansion (roughly decreasing) to nw words.

    More than nw words: the JAX ``_renorm_scan`` form (the words stacked,
    presorted if asked, ``sweeps`` VecSum sweeps, then the words past nw
    folded into the last kept word in increasing order). At most nw words:
    the presort if asked, then the sweeps (clrs_tpu/dd/core.py:203-227)."""
    if len(cs) > nw or presort:
        W = torch.stack(torch.broadcast_tensors(*cs))
        if presort:
            W = _presort(W)
        cs = list(W.unbind(0))
    for _ in range(sweeps):
        cs = vec_sum(cs)
    out = list(cs[:nw])
    for c in cs[nw:]:
        out[-1] = out[-1] + c
    return tuple(out)


def qd_neg(x):
    return tuple(-c for c in x)


def qd_add(x, y):
    """n-word + n-word (any word count)."""
    merged = []
    for a, b in zip(x, y):
        merged.append(a)
        merged.append(b)
    return renorm(merged, len(x), presort=True)


def qd_mul(x, y):
    """n-word product, accurate to O(eps^nw): error-free products on the
    diagonals d < nw - 1, plain products on the last kept one."""
    nw = len(x)
    if nw == 1:
        return (x[0] * y[0],)
    cs = []
    prev_errs = []
    for d in range(nw - 1):
        ps, errs = [], []
        for i in range(d + 1):
            p, e = two_prod(x[i], y[d - i])
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


def qd_mul_f64(x, a):
    """n-word times one f64 word."""
    nw = len(x)
    cs = []
    prev_e = None
    for i in range(nw - 1):
        p, e = two_prod(x[i], a)
        cs.append(p)
        if prev_e is not None:
            cs.append(prev_e)
        prev_e = e
    cs.append(x[nw - 1] * a + prev_e)
    return renorm(cs, nw)


def _ex_scalar(v, like, nw):
    """nw-word expansion of the scalar v, shaped like ``like``."""
    z = like * 0.0
    return (v + z,) + (z,) * (nw - 1)


def _widen(r, w):
    """Zero-pad an expansion to w words (exact embed)."""
    z = r[0] * 0.0
    return tuple(r) + (z,) * (w - len(r))


def _qd_recip(y):
    """Reciprocal by progressively widening Newton from the IEEE 1 / y0."""
    nw = len(y)
    r = (1.0 / y[0],)
    w = 1
    while w < nw:
        w = min(2 * w, nw)
        rw = _widen(r, w)
        e = qd_add(_ex_scalar(1.0, y[0], w), qd_neg(dd_mul(y[:w], rw)))
        r = qd_add(rw, dd_mul(rw, e))
    return r


def qd_div(x, y):
    """Newton reciprocal and one full-width refinement."""
    r = _qd_recip(y)
    q = qd_mul(x, r)
    resid = qd_add(x, qd_neg(qd_mul(y, q)))
    return qd_add(q, qd_mul(resid, r))


def _qd_rsqrt_core(x):
    """Progressively widening Newton on the inverse square root from the
    IEEE 1 / sqrt(x0)."""
    nw = len(x)
    r = (1.0 / sqrt_rn(x[0]),)
    w = 1
    while w < nw:
        w = min(2 * w, nw)
        rw = _widen(r, w)
        # r <- r + r (1 - x r^2) / 2
        t = dd_mul(x[:w], dd_mul(rw, rw))
        e = dd_mul_f64(qd_add(t, _ex_scalar(-1.0, t[0], w)), -0.5)
        r = qd_add(rw, dd_mul(rw, e))
    return r


def qd_rsqrt(x):
    """n-word inverse square root (positive inputs; the caller guards)."""
    return _qd_rsqrt_core(x)


def qd_sqrt(x):
    """n-word square root through the inverse square root."""
    y = _qd_rsqrt_core(x)
    r = qd_mul(x, y)
    # one final correction: r <- r + (x - r^2) y / 2
    resid = qd_add(x, qd_neg(qd_mul(r, r)))
    return qd_add(r, qd_mul_f64(qd_mul(resid, y), 0.5))


def dd_add(x, y):
    """Multi-word sum (the double-word form at nw = 2)."""
    if len(x) != 2:
        return qd_add(x, y)
    s1, s2 = two_sum(x[0], y[0])
    t1, t2 = two_sum(x[1], y[1])
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def dd_add_f64(x, a):
    """Multi-word plus one f64 word."""
    if len(x) != 2:
        return renorm([x[0], a] + list(x[1:]), len(x), presort=True)
    s1, s2 = two_sum(x[0], a)
    s2 = s2 + x[1]
    return quick_two_sum(s1, s2)


def dd_neg(x):
    return tuple(-c for c in x)


def dd_sub(x, y):
    return dd_add(x, dd_neg(y))


def dd_mul(x, y):
    if len(x) != 2:
        return qd_mul(x, y)
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p, e)


def dd_mul_f64(x, a):
    if len(x) != 2:
        return qd_mul_f64(x, a)
    p, e = two_prod(x[0], a)
    e = e + x[1] * a
    return quick_two_sum(p, e)


def dd_div(x, y):
    if len(x) != 2:
        return qd_div(x, y)
    q1 = x[0] / y[0]
    r = dd_sub(x, dd_mul_f64(y, q1))
    q2 = r[0] / y[0]
    r = dd_sub(r, dd_mul_f64(y, q2))
    q3 = r[0] / y[0]
    q1, q2 = quick_two_sum(q1, q2)
    return dd_add_f64((q1, q2), q3)


def dd_rsqrt(x):
    """Multi-word inverse square root (the n-word Newton at every nw)."""
    return qd_rsqrt(x)


def dd_sqrt(x):
    """Multi-word square root (positive inputs; the caller guards)."""
    if len(x) != 2:
        return qd_sqrt(x)
    r = sqrt_rn(x[0])
    # one Newton step in double word: r + (x - r^2) / (2 r)
    r2 = two_prod(r, r)
    diff = dd_sub(x, r2)
    corr = diff[0] / (2.0 * r)
    return quick_two_sum(r, corr)


def dd_abs(x):
    sgn = torch.where(x[0] < 0, -1.0, 1.0).to(x[0].dtype)
    return tuple(c * sgn for c in x)


def _lex_lt(x, y, i):
    """x < y on words i.. of normalised expansions."""
    if i == len(x) - 1:
        return x[i] < y[i]
    return (x[i] < y[i]) | ((x[i] == y[i]) & _lex_lt(x, y, i + 1))


def dd_lt(x, y):
    return _lex_lt(x, y, 0)


def dd_max(x, y):
    ge = ~dd_lt(x, y)
    return tuple(torch.where(ge, a, b) for a, b in zip(x, y))


def dd_min(x, y):
    le = ~dd_lt(y, x)
    return tuple(torch.where(le, a, b) for a, b in zip(x, y))


def dd_where(cond, x, y):
    return tuple(torch.where(cond, a, b) for a, b in zip(x, y))
