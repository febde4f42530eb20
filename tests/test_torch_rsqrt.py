"""The Newton seeds of the port's plain expansion ops against IEEE f32, and
its exp_rsqrt / exp_sqrt against a numpy re-run of the same op sequence, on
the CPU.

The CUDA kernels seed the inverse square root with __fdiv_rn(1,
__fsqrt_rn(x)) and the reciprocal with __fdiv_rn(1, y), both correctly
rounded; numpy's f32 sqrt and division are too. The plain versions must
give the same seeds bit for bit, so that the CPU computes the function
the card computes (chol_plain, which runs exp_rsqrt, included). Subnormal
inputs are kept, as on the card. Imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from clrs_tpu_torch.dd import ops as O
from torch_helpers import split_words


@pytest.fixture
def subnormals_kept():
    """Subnormals kept (PyTorch's default; tests/torch_helpers.py's
    xla_subnormals flushes them for the JAX comparisons)."""
    torch.set_flush_denormal(False)
    yield


def _sweep(kind, n=1 << 16, seed=0):
    """Positive f32 inputs: uniform in [1, 4) (the range the Newton core
    sees), or random bit patterns over every finite exponent, subnormals
    and the extremes included."""
    rng = np.random.default_rng(seed)
    if kind == "unit":
        return rng.uniform(1.0, 4.0, n).astype(np.float32)
    bits = rng.integers(1, 0x7F800000, n, dtype=np.uint32)
    bits[:4] = [1, 0x007FFFFF, 0x00800000, 0x7F7FFFFF]   # subnormal .. max
    return bits.view(np.float32)


@pytest.mark.parametrize("kind", ["unit", "wide"])
def test_rsqrt_seed_is_ieee(kind, subnormals_kept):
    """_rsqrt_core's seed (its nw = 1 result) equals 1 / sqrt in f32 with
    both operations correctly rounded."""
    x = _sweep(kind, seed=1)
    assert (x < np.finfo(np.float32).tiny).any() or kind == "unit"
    seed = O._rsqrt_core((torch.from_numpy(x),))[0].numpy()
    with np.errstate(over="ignore"):
        want = np.float32(1.0) / np.sqrt(x)
    assert np.array_equal(seed.view(np.uint32), want.view(np.uint32)), \
        int((seed != want).sum())


@pytest.mark.parametrize("kind", ["unit", "wide"])
def test_recip_seed_is_ieee(kind, subnormals_kept):
    """_recip_core's seed (its nw = 1 result) equals 1 / y in f32."""
    y = _sweep(kind, seed=2)
    if kind == "unit":
        y = y / np.float32(2.0) + np.float32(0.5)      # [1, 2.5)
    seed = O._recip_core((torch.from_numpy(y),))[0].numpy()
    with np.errstate(over="ignore"):
        want = np.float32(1.0) / y
    assert np.array_equal(seed.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "round"])
def test_plain_elementwise_ops_are_ieee(op, subnormals_kept):
    """The other f32 elementwise operations the plain versions run give
    numpy's correctly rounded results, subnormals included."""
    a, b = _sweep("wide", seed=3), _sweep("wide", seed=4)
    sign = np.where(np.random.default_rng(5).random(a.size) < 0.5, -1, 1)
    a = (a * sign).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with np.errstate(over="ignore", under="ignore"):
        got, want = {"add": (ta + tb, a + b), "sub": (ta - tb, a - b),
                     "mul": (ta * tb, a * b), "div": (ta / tb, a / b),
                     "round": (torch.round(ta), np.rint(a))}[op]
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# numpy re-run of dd/ops.py's op sequence (IEEE f32 elementwise, subnormals
# kept), from the IEEE seed
# ---------------------------------------------------------------------------

F = np.float32


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    hi = (a.view(np.uint32) & np.uint32(0xFFFFF000)).view(np.float32)
    return hi, a - hi


def _vec_sum(cs):
    out = [None] * len(cs)
    s = cs[-1]
    for i in range(len(cs) - 2, -1, -1):
        s, out[i + 1] = _two_sum(cs[i], s)
    out[0] = s
    return out


def _renorm(cs, nw):
    for _ in range(3):
        cs = _vec_sum(cs)
    while len(cs) > nw:
        t = cs.pop()
        cs[-1] = cs[-1] + t
    return tuple(cs)


def _add(x, y):
    ss, es = zip(*(_two_sum(a, b) for a, b in zip(x, y)))
    cs = [ss[0]]
    for i in range(1, len(x)):
        cs += [ss[i], es[i - 1]]
    return _renorm(cs + [es[-1]], len(x))


def _mul(x, y):
    nw = len(x)
    if nw == 1:
        return (x[0] * y[0],)
    xs, ys = [_split(c) for c in x[:-1]], [_split(c) for c in y[:-1]]
    cs, prev = [], []
    for d in range(nw - 1):
        ps, errs = [], []
        for i in range(d + 1):
            (ah, al), (bh, bl) = xs[i], ys[d - i]
            p = x[i] * y[d - i]
            ps.append(p)
            errs.append(((ah * bh - p) + ah * bl + al * bh) + al * bl)
        cs += ps + prev
        prev = errs
    last = x[0] * y[nw - 1]
    for i in range(1, nw):
        last = last + x[i] * y[nw - 1 - i]
    for e in prev:
        last = last + e
    return _renorm(cs + [last], nw)


def _mul_f32(x, a):
    nw = len(x)
    ah, al = _split(np.asarray(a, np.float32))
    cs, prev = [], None
    for i in range(nw - 1):
        xh, xl = _split(x[i])
        p = x[i] * F(a)
        cs.append(p)
        if prev is not None:
            cs.append(prev)
        prev = ((xh * ah - p) + xh * al + xl * ah) + xl * al
    cs.append(x[-1] * F(a) + prev)
    return _renorm(cs, nw)


def _pow2(e):
    return ((e + 127).astype(np.int32) << 23).view(np.float32)


def _mul_pow2(x, e):
    fs, rem = [], e
    for _ in range(3):
        h = np.clip(rem, -126, 126)
        fs.append(_pow2(h))
        rem = rem - h
    out = []
    for c in x:
        for f in fs:
            c = c * f
        out.append(c)
    return tuple(out)


def _exp(v):
    return ((v.view(np.int32) >> 23) & 0xFF) - 127


def _rsqrt_core(x):
    nw = len(x)
    r = (F(1.0) / np.sqrt(x[0]),)
    w = 1
    while w < nw:
        w = min(2 * w, nw)
        z = r[0] * F(0.0)
        rw = tuple(r) + (z,) * (w - len(r))
        t = _mul(x[:w], _mul(rw, rw))
        tz = t[0] * F(0.0)
        e = _mul_f32(_add(t, (F(-1.0) + tz,) + (tz,) * (w - 1)), -0.5)
        r = _add(rw, _mul(rw, e))
    return r


def _np_rsqrt(x):
    m = _exp(x[0]) >> 1
    return _mul_pow2(_rsqrt_core(_mul_pow2(x, -2 * m)), -m)


def _np_sqrt(x):
    m = _exp(x[0]) >> 1
    xs = _mul_pow2(x, -2 * m)
    y = _rsqrt_core(xs)
    r = _mul(xs, y)
    resid = _add(xs, tuple(-c for c in _mul(r, r)))
    r = _add(r, _mul_f32(_mul(resid, y), 0.5))
    return _mul_pow2(r, m)


@pytest.mark.parametrize("nw", [5, 8])
def test_rsqrt_sqrt_match_numpy_newton(nw, subnormals_kept):
    """exp_rsqrt and exp_sqrt equal, word for word, the same Newton
    sequence run in numpy from an IEEE seed; inputs over 60 decades, some
    of them with subnormal lower words."""
    rng = np.random.default_rng(30 + nw)
    v = np.abs(rng.standard_normal(4096)) * 10.0 ** rng.integers(-30, 30,
                                                                 4096)
    v[:8] = [1.0, 2.0, 3.999999, 1e-36, 1e-37, 3e38, 0.25, 1.5]
    xs = split_words(v, nw)
    tx = tuple(torch.from_numpy(w) for w in xs)
    with np.errstate(over="ignore", invalid="ignore"):
        for fn, ref in ((O.exp_rsqrt, _np_rsqrt), (O.exp_sqrt, _np_sqrt)):
            got = fn(tx)
            want = ref(tuple(xs))
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
