"""The port's f64 word arithmetic (clrs_tpu_torch.dd.f64ops) against the
jitted clrs_tpu.dd.core forms on the CPU, bit for bit (0 ulps), at nw 2, 4
and 5.

The inputs come from a numpy seed: normalised expansions with word 0
between 1e-150 and 1e150, f64 scalars, the presort case of
clrs_tpu/dd/core.py:122-123 (1e8 + 1e-8: operands far apart, whose merged
words are far from sorted), ties for the stable presort (+0/-0, equal
magnitudes of opposite sign) and a NaN. XLA:CPU flushes f64 subnormals,
so the port runs under the same flush (the ``xla_subnormals`` fixture).
The Newton seeds are IEEE ``1 / y0`` and ``1 / sqrt(x0)`` on both sides:
the JAX CPU seed equals IEEE over 2^21 inputs of every exponent
(test_jax_cpu_seeds_are_ieee), so no tolerance is needed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clrs_tpu.dd import core as C
from clrs_tpu_torch.dd import f64ops as F
from torch_helpers import xla_subnormals  # noqa: F401

N = 512
NWS = (2, 4, 5)
OPS = ("add", "sub", "mul", "div", "mul_f64", "add_f64", "rsqrt", "sqrt",
       "qd_add", "qd_mul", "qd_mul_f64", "abs", "max", "min", "where",
       "lt")


def expansion(rng, n, nw, lo=-150, hi=150, positive=False):
    """nw-word f64 expansions: word 0 with magnitude 10^U(lo, hi), each
    later word 2^-53..2^-59 of the one before it."""
    sign = 1.0 if positive else rng.choice([-1.0, 1.0], n)
    w0 = sign * rng.uniform(1, 2, n) * 10.0 ** rng.uniform(lo, hi, n)
    ws = [w0]
    for _ in range(1, nw):
        ws.append(ws[-1] * 2.0 ** -rng.integers(53, 60, n)
                  * rng.uniform(-1, 1, n))
    return ws


def _inputs(nw):
    rng = np.random.default_rng(100 + nw)
    x = expansion(rng, N, nw)
    y = expansion(rng, N, nw)
    # the presort case: 1e8 + 1e-8 (and its mirror)
    x[0][:2] = (1e8, 1e-8)
    y[0][:2] = (1e-8, 1e8)
    for w in x[1:] + y[1:]:
        w[:2] = 0.0
    # ties: equal magnitudes of opposite sign, signed zeros, a NaN
    y[0][2], x[0][3], y[0][3] = -x[0][2], 0.0, -0.0
    x[0][4] = np.nan
    p = expansion(rng, N, nw, positive=True)
    a = rng.uniform(-3, 3, N) * 10.0 ** rng.uniform(-100, 100, N)
    return x, y, p, a


def _ops(m, x, y, p, a, xp):
    """Every op of the module ``m`` (dd.core or f64ops) on the inputs."""
    kw = {} if m is F else {"xp": xp}
    return {
        "add": m.dd_add(x, y), "sub": m.dd_sub(x, y), "mul": m.dd_mul(x, y),
        "div": m.dd_div(x, y), "mul_f64": m.dd_mul_f64(x, a),
        "add_f64": m.dd_add_f64(x, a), "rsqrt": m.dd_rsqrt(p, **kw),
        "sqrt": m.dd_sqrt(p, **kw), "qd_add": m.qd_add(x, y),
        "qd_mul": m.qd_mul(x, y), "qd_mul_f64": m.qd_mul_f64(x, a),
        "abs": m.dd_abs(x, **kw), "max": m.dd_max(x, y, **kw),
        "min": m.dd_min(x, y, **kw),
        "where": m.dd_where(x[0] > y[0], x, y, **kw),
        "lt": (m.dd_lt(x, y),),
    }


@functools.lru_cache(maxsize=None)
def _jax_results(nw):
    x, y, p, a = _inputs(nw)
    fn = jax.jit(lambda x, y, p, a: _ops(C, x, y, p, a, jnp))
    out = fn(*(tuple(map(jnp.asarray, v)) if isinstance(v, list)
               else jnp.asarray(v) for v in (x, y, p, a)))
    return {k: tuple(np.asarray(w) for w in v) for k, v in out.items()}


def _bits(w):
    """Bit patterns, every NaN as one (its sign and payload follow the
    operand order of the machine instruction, which neither package
    fixes)."""
    w = np.asarray(w)
    if w.dtype != np.float64:
        return w
    return np.where(np.isnan(w), np.float64(np.nan), w).view(np.int64)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("nw", NWS)
def test_f64_op_bit_identical_to_jax(nw, op, xla_subnormals):
    ref = _jax_results(nw)[op]
    x, y, p, a = _inputs(nw)
    t = lambda v: tuple(torch.from_numpy(w) for w in v)  # noqa: E731
    with torch.no_grad():
        got = _ops(F, t(x), t(y), t(p), torch.from_numpy(a), None)[op]
    assert len(got) == len(ref)
    for i, (r, g) in enumerate(zip(ref, got)):
        g = g.numpy()
        assert g.dtype == r.dtype and g.shape == r.shape
        bad = np.flatnonzero(_bits(r) != _bits(g))
        assert bad.size == 0, (op, nw, i, bad[:5], r[bad[:5]], g[bad[:5]])


def test_presort_is_the_stable_argsort():
    """The presort of renorm: jnp.argsort's order on -|W| (stable; NaN
    last; +0/-0 and x/-x keep their order) on words built to tie."""
    rng = np.random.default_rng(7)
    W = rng.choice([0.0, -0.0, 1.0, -1.0, 2.0, -2.0, np.nan, 1e-300],
                   size=(9, 64))
    want = np.take_along_axis(W, np.asarray(jnp.argsort(-jnp.abs(W),
                                                        axis=0)), axis=0)
    got = F._presort(torch.from_numpy(W)).numpy()
    assert np.array_equal(want.view(np.int64), got.view(np.int64))


def test_jax_cpu_seeds_are_ieee():
    """The JAX CPU Newton seeds 1 / sqrt(x) (which XLA may rewrite to
    rsqrt) and 1 / y equal numpy's IEEE forms over 2^21 inputs of every
    exponent, and so does the port's sqrt_rn; torch.sqrt on large CPU
    tensors does not, which is why sqrt_rn exists."""
    rng = np.random.default_rng(11)
    n = 1 << 20
    x = np.concatenate([
        rng.uniform(1, 4, n) * np.exp2(rng.integers(-1000, 1000, n)
                                        .astype(np.float64)),
        rng.uniform(1, 4, n)])
    ref = 1.0 / np.sqrt(x)
    got = np.asarray(jax.jit(lambda v: 1.0 / jnp.sqrt(v))(jnp.asarray(x)))
    assert np.array_equal(got.view(np.int64), ref.view(np.int64))
    got = np.asarray(jax.jit(lambda v: 1.0 / v)(jnp.asarray(x)))
    assert np.array_equal(got.view(np.int64), (1.0 / x).view(np.int64))
    t = F.sqrt_rn(torch.from_numpy(x)).numpy()
    assert np.array_equal(t.view(np.int64), np.sqrt(x).view(np.int64))
