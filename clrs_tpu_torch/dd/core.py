"""Double-word (compensated float64, "double-double") arithmetic primitives.

This is the numeric substrate of the TPU build: it replaces the reference's
Arb ball arithmetic (ClusteredLowRankSolver.jl, src/tools.jl and Arblib calls
throughout src/solver.jl) with ~106-bit double-word float64, which is enough
for the duality-gap / feasibility thresholds used by the reference test
oracles (gap 1e-15, feasibility errors ~1e-30).

The numpy half of ``clrs_tpu/dd/core.py``: host-side compile-time
arithmetic on numpy arrays and Python floats (the JAX branches, the
scan-based renorm and the TPU routing are not carried over). A value is
represented as a pair ``(hi, lo)`` with ``|lo| <= ulp(hi)/2`` after
renormalisation; the represented value is exactly ``hi + lo``.

Algorithms follow the classical error-free transformations (Dekker/Knuth,
and the Ogita-Rump-Oishi Dot2 accumulation used in :mod:`.linalg`), written
without FMA so they are exact under plain IEEE round-to-nearest f64.
"""

from __future__ import annotations

import numpy as np

_SPLIT = 134217729.0  # 2**27 + 1, Dekker split constant for binary64
_SPLIT32 = np.float32(4097.0)  # 2**12 + 1, Dekker split constant for binary32


def _split_const(a):
    """Dekker split constant for the dtype of ``a`` (f64 or f32)."""
    dt = getattr(a, "dtype", None)
    if dt is not None and dt == np.float32:
        return _SPLIT32
    return _SPLIT


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a+b), s + e = a + b exactly."""
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
    """Dekker split into two non-overlapping halves (f64: ~26 bits each,
    f32: ~12 bits each, so half-products are exact in the working dtype)."""
    t = _split_const(a) * a
    ahi = t - (t - a)
    alo = a - ahi
    return ahi, alo


def two_prod(a, b):
    """Error-free product: returns (p, e) with p = fl(a*b), p + e = a*b exactly."""
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


# ---------------------------------------------------------------------------
# multi-word ops; operands are tuples of same-shape float64 arrays.
# len 2 = double-word (~106 bits, the fast default); len 4 = quad-word
# (~212 bits). The quad-word algorithms are floating-point-expansion style
# (VecSum renormalization sweeps, cf. Joldes-Muller-Popescu and the
# CAMPARY/QD libraries), built only on the error-free transforms above so
# they stay exact under IEEE f64.
# ---------------------------------------------------------------------------

def dd_normalize(hi, lo):
    return quick_two_sum(hi, lo)


def _vec_sum(cs):
    """One bottom-up two_sum sweep: value-preserving; cs[0] becomes fl(sum)."""
    n = len(cs)
    out = [None] * n
    s = cs[n - 1]
    for i in range(n - 2, -1, -1):
        s, e = two_sum(cs[i], s)
        out[i + 1] = e
    out[0] = s
    return out


def _presort_stack(W):
    """Sort words of a stacked expansion by descending magnitude, per
    element (exact permutation). VecSum sweeps converge for sorted inputs;
    unsorted merges (e.g. adding operands of very different magnitudes)
    can otherwise leave overlapping words after a fixed sweep count."""
    order = np.argsort(-np.abs(W), axis=0, kind="stable")
    return np.take_along_axis(W, order, axis=0)


def _renorm(cs, nw, sweeps=3, presort=False):
    """Compress an expansion (list, roughly decreasing) to nw words.

    ``presort=True`` sorts words by magnitude first — needed when the input
    order can be far from decreasing (adding operands of very different
    magnitudes); see :func:`_presort_stack`."""
    if presort:
        W = np.stack(np.broadcast_arrays(*[np.asarray(c, dtype=np.float64)
                                           for c in cs]))
        cs = list(_presort_stack(W))
    for _ in range(sweeps):
        cs = _vec_sum(cs)
    cs = list(cs)
    while len(cs) > nw:
        t = cs.pop()
        cs[-1] = cs[-1] + t      # O(eps^nw) relative; below the last word
    return tuple(cs)


def qd_add(x, y):
    """Generic n-word expansion add (any word count, any float dtype)."""
    merged = []
    for a, b in zip(x, y):
        merged.append(a)
        merged.append(b)
    return _renorm(merged, len(x), presort=True)


def _newton_iters(nw):
    """Newton doublings needed to reach nw words from a 1-word seed."""
    it = 0
    reach = 1
    while reach < nw:
        reach *= 2
        it += 1
    return max(it, 2)


def qd_mul(x, y):
    """Generic n-word expansion product, accurate to O(eps^nw).

    Diagonal d (= i+j) terms are order eps^d relative to the result:
    error-free products for d < nw-1 (their residuals are order eps^(d+1)),
    plain products on the last kept diagonal d = nw-1 (their own rounding
    is order eps^nw, below the target)."""
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
    return _renorm(cs, nw)


def qd_mul_f64(x, a):
    """n-word expansion times a single working-precision float."""
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
    return _renorm(cs, nw)


def _ex_scalar(v, like, nw):
    """nw-word expansion of scalar v broadcast like ``like``."""
    z = like * 0.0
    return (v + z,) + (z,) * (nw - 1)


def _widen(r, w):
    """Zero-pad an expansion to w words (exact embed)."""
    z = r[0] * 0.0
    return tuple(r) + (z,) * (w - len(r))


def _is_f32(x):
    dt = getattr(x[0], "dtype", None)
    return dt is not None and dt == np.float32


def _f32_exp(v):
    """Floor exponent e with v = m * 2^e, m in [1, 2), for f32 v."""
    _, e = np.frexp(v)
    return (e - 1).astype(np.int32)


def _f32_pow2(e):
    """Exact f32 power of two for |e| <= 126."""
    return np.ldexp(np.float32(1.0), e).astype(np.float32)


def _f32_scale_pow2(x, e):
    """Multiply every word of an f32 expansion by 2^e (exact where the
    result is representable); |e| <= 378 covered."""
    fs = []
    rem = e
    for _ in range(3):
        h = np.clip(rem, -126, 126)
        fs.append(_f32_pow2(h))
        rem = rem - h
    out = []
    for c in x:
        for f in fs:
            c = c * f
        out.append(c)
    return tuple(out)


def _qd_recip(y):
    """Reciprocal by progressively widening Newton: iteration k only needs
    2^k words of precision, so early iterations run on short (cheap)
    expansions."""
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
    """Newton reciprocal (progressive widening) + one full-width refinement.

    For f32 expansions, Newton runs in exponent-scaled space (y' = y * 2^-k
    with y' ~ 1, exact scaling) so its intermediates never sink into the f32
    subnormal floor."""
    if not _is_f32(y):
        r = _qd_recip(y)
        q = qd_mul(x, r)
        resid = qd_add(x, qd_neg(qd_mul(y, q)))
        return qd_add(q, qd_mul(resid, r))
    k = _f32_exp(y[0])
    ys = _f32_scale_pow2(y, -k)                  # ~ [1, 2)
    r = _qd_recip(ys)                            # ~ (0.5, 1]
    q1 = qd_mul(x, r)                            # = (x/y) * 2^k, ~ x scale
    resid = qd_add(x, qd_neg(qd_mul(ys, q1)))
    q = qd_add(q1, qd_mul(resid, r))
    return _f32_scale_pow2(q, -k)


def _qd_rsqrt_core(x, xp):
    """Progressively widening Newton on the inverse square root."""
    nw = len(x)
    r = (1.0 / xp.sqrt(x[0]),)
    w = 1
    while w < nw:
        w = min(2 * w, nw)
        rw = _widen(r, w)
        # r <- r + r*(1 - x r^2)/2
        t = dd_mul(x[:w], dd_mul(rw, rw))
        e = dd_mul_f64(qd_add(t, _ex_scalar(-1.0, t[0], w)), -0.5)
        r = qd_add(rw, dd_mul(rw, e))
    return r


def _f32_sqrt_scaled(x):
    """(x_scaled ~ [1,4), rsqrt(x_scaled), m) with x = x_scaled * 4^m."""
    e = _f32_exp(x[0])
    m = e >> 1                                   # floor(e/2)
    xs = _f32_scale_pow2(x, -2 * m)              # ~ [1, 4)
    return xs, _qd_rsqrt_core(xs, np), m


def qd_rsqrt(x, xp=np):
    """n-word inverse square root (Newton in exponent-scaled space for f32,
    see :func:`qd_div`)."""
    if not _is_f32(x):
        return _qd_rsqrt_core(x, xp)
    _, r, m = _f32_sqrt_scaled(x)
    return _f32_scale_pow2(r, -m)


def qd_sqrt(x, xp=np):
    """n-word sqrt via the inverse square root (no division)."""
    if not _is_f32(x):
        y = _qd_rsqrt_core(x, xp)
        r = qd_mul(x, y)
        # one final correction: r <- r + (x - r^2) * y / 2
        resid = qd_add(x, qd_neg(qd_mul(r, r)))
        return qd_add(r, qd_mul_f64(qd_mul(resid, y), 0.5))
    xs, y, m = _f32_sqrt_scaled(x)
    r = qd_mul(xs, y)                            # sqrt(xs) ~ [1, 2)
    resid = qd_add(xs, qd_neg(qd_mul(r, r)))
    r = qd_add(r, qd_mul_f64(qd_mul(resid, y), 0.5))
    return _f32_scale_pow2(r, m)


def qd_neg(x):
    return tuple(-c for c in x)


def dd_add(x, y):
    """Accurate multi-word addition (dispatches on word count)."""
    if len(x) != 2:
        return qd_add(x, y)
    s1, s2 = two_sum(x[0], y[0])
    t1, t2 = two_sum(x[1], y[1])
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def dd_add_f64(x, a):
    """multi-word + single working-precision float."""
    if len(x) != 2:
        return _renorm([x[0], a] + list(x[1:]), len(x), presort=True)
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


def dd_rsqrt(x, xp=np):
    """Multi-word inverse square root (non-positive inputs must be guarded
    by the caller, as for :func:`dd_sqrt`)."""
    return qd_rsqrt(x, xp=xp)


def dd_sqrt(x, xp=np):
    """Multi-word square root.

    Caller must guard non-positive inputs (returns garbage / inf there);
    the solver substitutes safe values via a mask before calling.
    """
    if len(x) != 2:
        return qd_sqrt(x, xp=xp)
    r = xp.sqrt(x[0])
    # one Newton step in double-word: r_dd = r + (x - r^2) / (2r)
    r2 = two_prod(r, r)
    diff = dd_sub(x, r2)
    corr = diff[0] / (2.0 * r)
    return quick_two_sum(r, corr)


def dd_abs(x, xp=np):
    sgn = xp.where(x[0] < 0, -1.0, 1.0)
    return tuple(c * sgn for c in x)


def _lex_after_first(x, y, i, xp, op_strict):
    """strict comparison on words i.. (x op y) for normalized expansions."""
    if i == len(x) - 1:
        return op_strict(x[i], y[i])
    return op_strict(x[i], y[i]) | (
        (x[i] == y[i]) & _lex_after_first(x, y, i + 1, xp, op_strict))


def dd_max(x, y, xp=np):
    ge = ~dd_lt(x, y)
    return tuple(xp.where(ge, a, b) for a, b in zip(x, y))


def dd_min(x, y, xp=np):
    le = ~dd_lt(y, x)
    return tuple(xp.where(le, a, b) for a, b in zip(x, y))


def dd_where(cond, x, y, xp=np):
    return tuple(xp.where(cond, a, b) for a, b in zip(x, y))


def dd_lt(x, y):
    import operator
    return _lex_after_first(x, y, 0, np, operator.lt)


def from_float(a, xp=np, nw=2, dtype=None):
    a = xp.asarray(a, dtype=dtype or xp.float64)
    z = xp.zeros_like(a)
    return (a,) + (z,) * (nw - 1)


def to_float(x):
    out = x[0]
    for c in x[1:]:
        out = out + c
    return out
