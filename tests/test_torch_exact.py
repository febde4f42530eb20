"""The port's exact-arithmetic stack (clrs_tpu_torch/exact/) against the
JAX package's on the same numpy-seeded inputs: equal results, exactly.
Host code on both sides; no JAX computation runs."""

from decimal import Decimal, getcontext
from fractions import Fraction

import numpy as np
import pytest

import clrs_tpu.native
import clrs_tpu_torch.native
from clrs_tpu.exact import (dixon as dixon_j, field as field_j, hnf as hnf_j,
                            lll as lll_j, modp as modp_j)
from clrs_tpu_torch.exact import (dixon as dixon_t, field as field_t,
                                  hnf as hnf_t, lll as lll_t, modp as modp_t)


def _int_matrix(rng, m, n, lo=-9, hi=10):
    return [[int(v) for v in row] for row in rng.integers(lo, hi, (m, n))]


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("seed,m,n,p", [(0, 8, 12, 10007), (1, 12, 8, 101),
                                        (2, 20, 20, 62003), (3, 5, 5, 2)])
def test_rref_mod_p_matches_jax(route, seed, m, n, p, monkeypatch):
    if route == "python":
        monkeypatch.setattr(clrs_tpu.native, "get_lib", lambda: None)
        monkeypatch.setattr(clrs_tpu_torch.native, "get_lib", lambda: None)
    else:
        assert clrs_tpu_torch.native.get_lib() is not None, \
            "g++ did not build the port's native RREF"
        assert modp_t._rref_native(np.eye(2, dtype=np.int64), 5) is not None
    rng = np.random.default_rng(seed)
    a = rng.integers(0, p, size=(m, n)).astype(np.int64)
    if m > 2:
        a[m // 2] = (a[0] + a[1]) % p          # rank deficiency
    piv_t, red_t = modp_t.rref_mod_p(a.copy(), p)
    piv_j, red_j = modp_j.rref_mod_p(a.copy(), p)
    assert piv_t == piv_j
    np.testing.assert_array_equal(red_t, red_j)
    rows = _int_matrix(rng, m, n, -10 ** 6, 10 ** 6)
    assert (modp_t.find_pivots_modular(rows)
            == modp_j.find_pivots_modular(rows))


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 6), (2, 12)])
def test_solve_dixon_matches_jax(seed, n):
    rng = np.random.default_rng(seed)
    while True:
        a = [[Fraction(int(v), int(d)) for v, d in zip(
            rng.integers(-50, 50, n), rng.integers(1, 9, n))]
            for _ in range(n)]
        if abs(np.linalg.det(np.array(a, dtype=float))) > 1e-6:
            break
    b = [Fraction(int(v), int(d)) for v, d in zip(
        rng.integers(-50, 50, n), rng.integers(1, 9, n))]
    x_t = dixon_t.solve_dixon(a, b)
    assert x_t == dixon_j.solve_dixon(a, b)
    assert all(sum(a[i][j] * x_t[j] for j in range(n)) == b[i]
               for i in range(n))
    for v, m in ((123456789, 10 ** 12 + 39), (-77, 1009 * 1013)):
        assert (dixon_t.rational_reconstruction(v, m)
                == dixon_j.rational_reconstruction(v, m))


@pytest.mark.parametrize("seed,m,n", [(0, 3, 4), (1, 6, 6), (2, 8, 5)])
def test_hnf_matches_jax(seed, m, n):
    a = _int_matrix(np.random.default_rng(seed), m, n)
    assert hnf_t.hnf_with_transform(a) == hnf_j.hnf_with_transform(a)
    assert (hnf_t.hnf_normalmultiplier_with_transform(a)
            == hnf_j.hnf_normalmultiplier_with_transform(a))


@pytest.mark.parametrize("k", [2, 3, 5, 7])
def test_lindep_clindep_match_jax(k):
    getcontext().prec = 50
    x = Decimal(k).sqrt()
    vals = [Fraction(1), Fraction(x), Fraction(x * x)]
    rel = lll_t.lindep(vals, 40)
    assert rel == lll_j.lindep(vals, 40)
    assert rel in ([-k, 0, 1], [k, 0, -1])
    rng = np.random.default_rng(k)
    w = [Fraction(int(v)) for v in rng.integers(1, 20, 3)]
    cols = [[Fraction(1) * c for c in w], [Fraction(x) * c for c in w],
            [Fraction(x * x) * c for c in w]]
    assert (lll_t.clindep(cols, 60, 1e-12)
            == lll_j.clindep(cols, 60, 1e-12))


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 5), (2, 8)])
def test_lll_reduce_matches_jax(seed, n):
    rng = np.random.default_rng(seed)
    while True:
        basis = _int_matrix(rng, n, n, -100, 100)
        if abs(np.linalg.det(np.array(basis, dtype=float))) > 0.5:
            break
    assert (lll_t.lll_reduce([r[:] for r in basis])
            == lll_j.lll_reduce([r[:] for r in basis]))


@pytest.mark.parametrize("minpoly,root", [([-5, 0, 1], 5), ([-2, 0, 1], 2),
                                          ([-2, 0, 0, 1], None)])
def test_number_field_arithmetic_matches_jax(minpoly, root):
    getcontext().prec = 60
    approx = None if root is None else Decimal(root).sqrt()
    Ft = field_t.NumberField(minpoly, "z", approx_root=approx)
    Fj = field_j.NumberField(minpoly, "z", approx_root=approx)
    rng = np.random.default_rng(len(minpoly) + (root or 0))
    for _ in range(20):
        ca, cb = ([Fraction(int(v), int(d)) for v, d in zip(
            rng.integers(-20, 20, Ft.degree), rng.integers(1, 7, Ft.degree))]
            for _ in range(2))
        at, bt = field_t.NFElem(Ft, ca), field_t.NFElem(Ft, cb)
        aj, bj = field_j.NFElem(Fj, ca), field_j.NFElem(Fj, cb)
        for op in (lambda a, b: a + b, lambda a, b: a - b,
                   lambda a, b: a * b, lambda a, b: a ** 3 - b,
                   lambda a, b: a / b if not b.is_zero() else a,
                   lambda a, b: a.inverse() if not a.is_zero() else b):
            assert op(at, bt).coeffs == op(aj, bj).coeffs
        if approx is not None:
            assert at.embed() == aj.embed()
            assert (field_t.generic_embedding(at, approx)
                    == field_j.generic_embedding(aj, approx))
    assert Ft.gen().coeffs == Fj.gen().coeffs
