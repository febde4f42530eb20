"""Plain arithmetic shared by the references: high-precision constants and
Chebyshev points in ``decimal``, exact polynomial bases in ``fractions``,
and the duality gap. Nothing here imports the port or JAX.

A solve's answer comes as plain rationals (``perfbench/harness/answers.py``):
``x`` (one value per constraint and sample), ``X`` and ``Y`` (a matrix per
block name) and ``y`` (a value per free variable). The conventions are
the upstream solver's (ClusteredLowRankSolver.jl, solver.jl:882-950), with
``sign`` +1 to maximize and -1 to minimize:
- primal: ``<A_p, Y> + B_p y = c_p`` at each constraint sample p, Y PSD;
- dual: ``X = sum_p x_p A_p - sign C`` PSD and ``B^T x = sign b``;
- objectives ``p = const + <C, Y> + b y`` and ``d = const + sign <c, x>``;
- the gap ``|d - p| / max(1, |d + p|)``.
"""

from __future__ import annotations

import math
from decimal import Decimal, localcontext
from fractions import Fraction

import numpy as np

DIGITS = 60


def _pi(digits):
    """pi to ``digits`` digits by Machin's formula."""
    with localcontext() as ctx:
        ctx.prec = digits + 10

        def arctan_inv(x):
            x = Decimal(x)
            term = 1 / x
            total, k, x2 = term, 1, x * x
            eps = Decimal(10) ** (-(digits + 8))
            while abs(term) > eps:
                term = -term / x2
                total += term / (2 * k + 1)
                k += 1
            return total

        return 4 * (4 * arctan_inv(5) - arctan_inv(239))


def cospi(q: Fraction, digits: int = DIGITS) -> Decimal:
    """cos(pi q) by its Taylor series after reduction to [0, 1/2]."""
    t = Fraction(q) % 2
    sign = 1
    if t > 1:
        t = 2 - t
    if t > Fraction(1, 2):
        t, sign = 1 - t, -1
    with localcontext() as ctx:
        ctx.prec = digits + 10
        x = Decimal(t.numerator) / Decimal(t.denominator) * _pi(digits)
        x2, term, total, k = x * x, Decimal(1), Decimal(1), 0
        eps = Decimal(10) ** (-(digits + 8))
        while abs(term) > eps:
            term = -term * x2 / ((2 * k + 1) * (2 * k + 2))
            total += term
            k += 1
        return sign * total


def dec(q: Fraction) -> Decimal:
    """A rational as a Decimal in the current context."""
    return Decimal(q.numerator) / Decimal(q.denominator)


def chebyshev_points(m: int, a, b) -> list:
    """The m + 1 Chebyshev points of the first kind on [a, b], in Decimal:
    (a + b)/2 + (b - a)/2 cos(pi (2k - 1) / (2 (m + 1))), k = 1..m+1."""
    a, b = Fraction(a), Fraction(b)
    with localcontext() as ctx:
        ctx.prec = DIGITS
        mid, half = dec(a + b) / 2, dec(b - a) / 2
        return [mid + half * cospi(Fraction(2 * k - 1, 2 * (m + 1)))
                for k in range(1, m + 2)]


def gegenbauer_coeffs(d: int, n: int) -> list:
    """Monomial coefficients (exact) of the Gegenbauer polynomials for
    dimension n normalized at 1, degrees 0..d: G_0 = 1, G_1 = x,
    G_l = (x G_{l-1} (2l + n - 4) - G_{l-2} (l - 1)) / (l + n - 3)."""
    out = [[Fraction(1)], [Fraction(0), Fraction(1)]]
    for l in range(2, d + 1):
        a = Fraction(2 * l + n - 4, l + n - 3)
        b = Fraction(l - 1, l + n - 3)
        c = [Fraction(0)] + [a * v for v in out[l - 1]]
        for i, v in enumerate(out[l - 2]):
            c[i] -= b * v
        out.append(c)
    return out[:d + 1]


def gegenbauer_values(d: int, n: int, x):
    """G_0(x)..G_d(x) by the three-term recurrence (stable on [-1, 1]), in
    the arithmetic of ``x`` (Fraction, Decimal or a float array)."""
    vals = [x * 0 + 1, x]
    for l in range(2, d + 1):
        vals.append((x * vals[l - 1] * (2 * l + n - 4)
                     - vals[l - 2] * (l - 1)) / (l + n - 3))
    return vals[:d + 1]


def chebyshev_values(d: int, x):
    """T_0(x)..T_d(x) by the three-term recurrence."""
    vals = [x * 0 + 1, x]
    for l in range(2, d + 1):
        vals.append(2 * x * vals[l - 1] - vals[l - 2])
    return vals[:d + 1]


def psd(rows) -> bool:
    """Whether a rational matrix's symmetric part is positive
    semidefinite, exactly: fraction-free (Bareiss) elimination over the
    integers with the largest remaining diagonal as pivot. Each pivot is a
    leading principal minor of the matrix so permuted; all positive means
    definite, and where the largest remaining diagonal is 0 the rest has
    to be 0."""
    n = len(rows)
    sym = [[(Fraction(rows[i][j]) + Fraction(rows[j][i])) / 2
            for j in range(n)] for i in range(n)]
    den = 1
    for r in sym:
        for v in r:
            den = den * v.denominator // math.gcd(den, v.denominator)
    a = [[int(v * den) for v in r] for r in sym]
    left, prev = list(range(n)), 1
    while left:
        p = max(left, key=lambda i: a[i][i])
        piv = a[p][p]
        if piv <= 0:
            return piv == 0 and not any(a[i][j] for i in left for j in left)
        left.remove(p)
        for i in left:
            ai, aip = a[i], a[i][p]
            for j in left:
                ai[j] = (piv * ai[j] - aip * a[p][j]) // prev
        prev = piv
    return True


def not_psd(*matrices) -> int:
    """How many blocks of the given {block: rows} maps are not positive
    semidefinite (:func:`psd`)."""
    return sum(not psd(m) for blocks in matrices for m in blocks.values())


def gap(p_obj: Fraction, d_obj: Fraction) -> float:
    return float(abs(d_obj - p_obj) / max(Fraction(1), abs(d_obj + p_obj)))


def to_f64(rows) -> np.ndarray:
    return np.array([[float(v) for v in row] for row in rows],
                    dtype=np.float64)


def max_abs(values) -> float:
    return float(max((abs(v) for v in values), default=0))
