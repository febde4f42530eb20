"""Sample point generators.

Ports of `ClusteredLowRankSolver.jl/src/basesandsamples.jl:106-183` with
Decimal (50-digit) arithmetic in place of BigFloat, and exact Fractions for
the simplex points.
"""

from __future__ import annotations

import itertools
from decimal import Decimal
from fractions import Fraction

from ..utils.hp import HOST_DIGITS, _as_decimal, cospi, log_dec, pi, sqrt_dec

__all__ = [
    "sample_points_simplex",
    "sample_points_padua",
    "sample_points_rescaled_laguerre",
    "sample_points_chebyshev",
    "sample_points_chebyshev_mod",
]


def sample_points_simplex(n, d):
    """Rational points in the unit simplex with denominator d (basesandsamples.jl:106-118)."""
    pts = []
    for tup in itertools.product(range(d + 1), repeat=n):
        # match the reference's CartesianIndices order (first index fastest)
        tup = tuple(reversed(tup))
        if sum(tup) <= d:
            pts.append([Fraction(i, d) for i in tup])
    return pts


def sample_points_padua(d):
    """Padua points for degree d (basesandsamples.jl:125-139)."""
    z = []
    for j in range(d + 1):
        delta_j = 1 if (j % 2 == 1 and d % 2 == 1) else 0
        mu_j = cospi(Fraction(j, d))
        for k in range(1, d // 2 + 2 + delta_j):
            if j % 2 == 1:
                eta_k = cospi(Fraction(2 * k - 2, d + 1))
            else:
                eta_k = cospi(Fraction(2 * k - 1, d + 1))
            z.append([mu_j, eta_k])
    return z


def sample_points_rescaled_laguerre(d):
    """SDPB-style rescaled Laguerre points (basesandsamples.jl:146-155)."""
    c = -sqrt_dec(pi()) / (64 * (d + 1) * log_dec(3 - 2 * sqrt_dec(2)))
    return [c * (-1 + 4 * k) ** 2 for k in range(d + 1)]


def sample_points_chebyshev(d, a=-1, b=1):
    """d+1 Chebyshev points in [a, b] (basesandsamples.jl:162-170)."""
    a = _as_decimal(a)
    b = _as_decimal(b)
    two = Decimal(2)
    return [(a + b) / two + (b - a) / two * cospi(Fraction(2 * k - 1, 2 * (d + 1)))
            for k in range(1, d + 2)]


def sample_points_chebyshev_mod(d, a=-1, b=1):
    """Chebyshev points divided by cos(pi/(2(d+1))) (basesandsamples.jl:177-183)."""
    a = _as_decimal(a)
    b = _as_decimal(b)
    two = Decimal(2)
    c = cospi(Fraction(1, 2 * (d + 1)))
    return [(a + b) / two + (b - a) / two * cospi(Fraction(2 * k - 1, 2 * (d + 1))) / c
            for k in range(1, d + 2)]
