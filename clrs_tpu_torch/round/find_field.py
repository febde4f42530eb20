"""Heuristic field detection from a numerical solution.

Port of `ClusteredLowRankSolver.jl/src/find_field.jl`: pick large entries of
the kernel RREF of dual blocks as candidate generators, find their minimal
polynomials via integer-relation LLL, and merge the candidates into one
common field (extending the degree when indecomposable).
"""

from __future__ import annotations

from decimal import Decimal, getcontext
from fractions import Fraction

import numpy as np

from ..exact.field import NumberField, QQ
from ..exact.lll import clindep
from ..utils.hp import DDScalar, to_fraction
from .rounding import (RoundingSettings, _dd_rref_colpivot, _to_f64,
                       keeps_decimal_context)

__all__ = ["find_field", "min_poly", "decompose", "to_field"]


def min_poly(g, d, bits=100, errbound=1e-15):
    """Integer coefficients (low->high) with sum_i c_i g^i ~ 0 (find_field.jl:111-113)."""
    gf = to_fraction(g)
    return clindep([[gf ** k] for k in range(d + 1)], bits, errbound)


def decompose(v, g, d, bits=100, errbound=1e-15):
    """Relation v ~ sum of powers of g (find_field.jl:115-117)."""
    vf = to_fraction(v)
    gf = to_fraction(g)
    return clindep([[vf]] + [[gf ** k] for k in range(d)], bits, errbound)


@keeps_decimal_context
def to_field(v, N: NumberField, g, bits=100, errbound=1e-15):
    """Approximate v as an element of N (find_field.jl:124-129)."""
    a = decompose(v, g, N.degree, bits=bits, errbound=errbound)
    z = N.gen()
    out = N(0)
    for i in range(N.degree):
        out = out + N(-Fraction(a[i + 1], a[0])) * z ** i
    return out


def _select_vals(dualsol, primalsol, max_d, valbound, errbound, bits,
                 max_coeff, sizebound=10 ** 6):
    all_vals = []
    for k, m in dualsol.matrixvars.items():
        m64 = _to_f64(m)
        if np.abs(m64).max() > sizebound:
            p64 = _to_f64(primalsol.matrixvars[k])
            if np.abs(p64).max() >= sizebound:
                continue
            u, s, vt = np.linalg.svd(p64)
            num = int(np.sum(np.abs(s) < valbound))
            if num == 0:
                continue
            n = p64.shape[0]
            mat = [[DDScalar(u[i, n - num + kk]) for i in range(n)]
                   for kk in range(num)]
        else:
            mat = [[DDScalar(x) for x in row] for row in np.asarray(m)]
        vecs = _dd_rref_colpivot(mat, errbound)
        for v in vecs:
            # first entry beyond the pivot structure above valbound
            vals = [x for x in v if valbound < abs(float(x))
                    and abs(abs(float(x)) - 1.0) > valbound]
            if not vals:
                continue
            val = vals[0]
            for d in range(1, max_d + 1):
                try:
                    coeffs = min_poly(val, d, bits=bits, errbound=errbound)
                except ValueError:
                    continue
                if all(abs(c) <= max_coeff for c in coeffs):
                    if d > 1:
                        all_vals.append((val, d))
                    break
    return all_vals


def find_common_minpoly(generators, max_coeff=1000, bits=100, errbound=1e-15):
    if not generators:
        return Fraction(1), 1, [-1, 1], QQ
    # start with a maximal-degree generator with smallest coefficients
    def _key(gd):
        g, d = gd
        return (d, -sum(abs(c) for c in min_poly(g, d, bits=bits,
                                                 errbound=errbound)))

    g, d = max(generators, key=_key)
    for v, degv in generators:
        try:
            if degv <= d:
                coeffs = decompose(v, g, d, bits=bits, errbound=errbound)
                switch = False
            else:
                coeffs = decompose(g, v, degv, bits=bits, errbound=errbound)
                switch = True
        except ValueError:
            coeffs = [max_coeff + 1]
        if all(abs(c) < max_coeff for c in coeffs):
            if switch:
                g, d = v, degv
        else:
            # indecomposable: extend the field with the sum
            g = DDScalar(to_fraction(g) + to_fraction(v))
            for deg in range(max(d, degv), d + degv + 1):
                try:
                    coeffs = min_poly(g, deg, bits=bits, errbound=errbound)
                except ValueError:
                    continue
                if all(abs(c) < max_coeff for c in coeffs):
                    d = deg
                    break
    coeffs = min_poly(g, d, bits=bits, errbound=errbound)
    # normalize to a monic minimal polynomial over Q
    lead = Fraction(coeffs[-1])
    mp = [Fraction(c) / lead for c in coeffs]
    N = NumberField(mp, "z", approx_root=None)
    return g, d, coeffs, N


def _refine_root(N: NumberField, g, digits=60):
    """Newton-refine the real root of the minimal polynomial near g
    (replacing the reference's Arb root isolation, rounding.jl:433-445)."""
    getcontext().prec = digits + 10
    x = Decimal(float(g))
    mp = N.minpoly
    dmp = [i * mp[i] for i in range(1, len(mp))]

    def ev(p, t):
        acc = Decimal(0)
        for c in reversed(p):
            acc = acc * t + Decimal(c.numerator) / Decimal(c.denominator)
        return acc

    for _ in range(200):
        f = ev(mp, x)
        fp = ev(dmp, x)
        if fp == 0:
            break
        step = f / fp
        x = x - step
        if abs(step) < Decimal(10) ** (-(digits + 2)):
            break
    return +x


@keeps_decimal_context
def find_field(dualsol, primalsol, max_degree=10, valbound=1e-15,
               errbound=1e-15, bits=None, max_coeff=10 ** 5):
    """Heuristically find the field over which the kernel is defined
    (find_field.jl:89-106). Returns (field_or_QQ, approximate_generator)."""
    bits = bits or max_degree * 100
    vals = _select_vals(dualsol, primalsol, max_degree, valbound, errbound,
                        bits, max_coeff)
    g, d, coeffs, N = find_common_minpoly(vals, max_coeff=max_coeff,
                                          bits=bits, errbound=errbound)
    if N is QQ:
        return QQ, 1.0
    root = _refine_root(N, float(g) if not isinstance(g, DDScalar) else float(g))
    N.approx_root = root
    return N, root
