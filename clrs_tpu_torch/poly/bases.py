"""Orthogonal polynomial bases.

Ports of the exact recurrences in
`ClusteredLowRankSolver.jl/src/basesandsamples.jl:6-99` (monomial, Laguerre,
Jacobi, Chebyshev, Gegenbauer), with exact Fraction coefficients.
"""

from __future__ import annotations

import itertools
from fractions import Fraction

from ..utils.hp import to_fraction

__all__ = [
    "basis_monomial",
    "basis_laguerre",
    "basis_jacobi",
    "basis_chebyshev",
    "basis_gegenbauer",
]


def basis_monomial(d: int, *xs):
    """Monomial basis in the variables xs up to total degree d (basesandsamples.jl:6-21)."""
    n = len(xs)
    out = []
    for k in range(d + 1):
        # exponents of total degree k, in the same order as Combinatorics.multiexponents
        for comp in _multiexponents(n, k):
            m = xs[0].ring.one() if hasattr(xs[0], "ring") else 1
            for x, e in zip(xs, comp):
                m = m * x ** e
            out.append(m)
    return out


def _multiexponents(n, k):
    """All n-tuples of nonnegative ints summing to k (lexicographic like Combinatorics.jl)."""
    if n == 1:
        yield (k,)
        return
    for first in range(k, -1, -1):
        for rest in _multiexponents(n - 1, k - first):
            yield (first,) + rest


def basis_laguerre(d: int, alpha, x):
    """Generalized Laguerre polynomials up to degree d (basesandsamples.jl:28-38)."""
    alpha = to_fraction(alpha)
    v = [x.ring.one()]
    if d == 0:
        return v
    v.append(x.ring(1 + alpha) - x)
    for l in range(2, d + 1):
        v.append((v[l - 1] * (Fraction(2 * l - 1) + alpha) - v[l - 1] * x
                  - v[l - 2] * (Fraction(l - 1) + alpha)) * Fraction(1, l))
    return v


def basis_jacobi(d: int, alpha, beta, x):
    """Jacobi polynomials up to degree d (basesandsamples.jl:45-60)."""
    alpha = to_fraction(alpha)
    beta = to_fraction(beta)
    q = [x.ring.one()]
    if d == 0:
        return q
    q.append(x.ring(alpha + 1) + (x - 1) * ((alpha + beta + 2) * Fraction(1, 2)))
    for k in range(2, d + 1):
        n = k - 1
        t1 = (alpha ** 2 - beta ** 2) / ((2 * n + alpha + beta) * (2 * n + alpha + beta + 2))
        t2 = 2 * (n + alpha) * (n + beta) / ((2 * n + alpha + beta) * (2 * n + alpha + beta + 1))
        nxt = (q[k - 1] * t1 + q[k - 1] * x) - q[k - 2] * t2
        nxt = nxt * ((2 * n + alpha + beta + 1) * (2 * n + alpha + beta + 2)
                     / (2 * (n + 1) * (n + alpha + beta + 1)))
        q.append(nxt)
    return q


def basis_chebyshev(d: int, x):
    """Chebyshev polynomials of the first kind up to degree d (basesandsamples.jl:67-77)."""
    v = [x.ring.one()]
    if d == 0:
        return v
    v.append(x)
    for l in range(2, d + 1):
        v.append(x * v[l - 1] * 2 - v[l - 2])
    return v


def basis_gegenbauer(d: int, n: int, x):
    """Gegenbauer polynomials for dimension n, normalized at 1 (basesandsamples.jl:89-99)."""
    v = [x.ring.one()]
    if d == 0:
        return v
    v.append(x)
    for l in range(2, d + 1):
        v.append(x * v[l - 1] * Fraction(2 * l + n - 4, l + n - 3)
                 - v[l - 2] * Fraction(l - 1, l + n - 3))
    return v
