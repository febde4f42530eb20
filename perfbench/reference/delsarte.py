"""The Delsarte LP bound for spherical codes (upstream
``examples/Delsarte.jl``), worked out again from (n, d, cos theta), and
the checks of a solve's answer against it.

The problem: minimize M over a_1..a_2d >= 0, slack >= 0 and two SOS
matrices, such that at the 2d + 1 Chebyshev points s_p of [-1, c]
(c = cos theta, in increasing order)

    sum_k a_k G_k(s_p) + s1(s_p) + (1 + s_p)(c - s_p) s2(s_p) = -1

(G_k the Gegenbauer polynomials for dimension n, normalized at 1; s1 and
s2 sums of squares of degree 2d and 2d - 2 in the solver's own basis) and
sum_k a_k + slack - M = -1. Block names: ("a", k), ("SOS", 1), ("SOS", 2),
"slack"; free variable "M".

The port writes the SOS matrices in a basis of its own making (an
approximate Fekete orthogonalization), so the checks do not read them
through a basis: the primal is held to what the SOS constraint means, a
polynomial -1 - sum_k a_k G_k >= 0 on [-1, c]. Everything else is
compared exactly, and so is the cone: every block of X and Y, the 1 x 1
ones (a_k, slack and their duals) and the SOS matrices, positive
semidefinite. Semidefiniteness does not depend on the basis.
"""

from __future__ import annotations

from decimal import localcontext
from fractions import Fraction

import numpy as np

from perfbench.reference.common import (DIGITS, chebyshev_points,
                                        chebyshev_values, gap,
                                        gegenbauer_values, max_abs, not_psd)


def shape(p):
    """Clusters and blocks (size, rank) for the roofline's work count."""
    d = int(p["d"])
    return {"clusters": [{"P": 2 * d + 2,
                          "blocks": [[d + 1, 1], [d, 1]]
                          + [[1, 1]] * (2 * d + 1)}]}


def samples(p):
    """The 2d + 1 Chebyshev points of [-1, c], increasing, in Decimal."""
    return sorted(chebyshev_points(2 * int(p["d"]), -1,
                                   Fraction(p["costheta"])))


def _poly_min(a, n, lo, hi, m):
    """The least value of -1 - sum_k a_k G_k on [lo, hi]: a grid of ``m``
    Chebyshev-spaced points, then golden sections around its lowest local
    minima (float64)."""
    d = len(a)
    coef = np.asarray([float(v) for v in a])

    def f(t):
        g = gegenbauer_values(d, n, np.asarray(t, dtype=np.float64))
        return -1.0 - sum(coef[k - 1] * g[k] for k in range(1, d + 1))

    t = (lo + hi) / 2 + (hi - lo) / 2 * np.cos(np.pi * np.arange(m + 1) / m)
    t = np.sort(t)
    v = f(t)
    best = float(v.min())
    interior = np.flatnonzero((v[1:-1] <= v[:-2]) & (v[1:-1] <= v[2:])) + 1
    for i in interior[np.argsort(v[interior])][:16]:
        x0, x1 = t[i - 1], t[i + 1]
        g = (np.sqrt(5) - 1) / 2
        for _ in range(80):
            c0, c1 = x1 - g * (x1 - x0), x0 + g * (x1 - x0)
            if f(c0) < f(c1):
                x1 = c1
            else:
                x0 = c0
        best = min(best, float(f((x0 + x1) / 2)))
    return best


def check(p, ans):
    """{gap, primal_error, dual_error, cone} of one answer (see the module
    docstring): the gap exactly; primal_error the largest of the linear
    constraint's residual and how far -1 - sum a_k G_k falls below 0 on
    [-1, c]; dual_error the largest residual of the dual constraints that
    hold no SOS block (exact data: x against G_k at the points) and of
    the free variable's; cone the number of blocks of X and Y that are
    not positive semidefinite, exactly."""
    n, d, c = int(p["n"]), int(p["d"]), Fraction(p["costheta"])
    Y, X, x = ans["Y"], ans["X"], ans["x"]
    x1, x2 = x[0], x[1][0]
    if len(x1) != 2 * d + 1:
        raise ValueError(f"{len(x1)} dual values for {2 * d + 1} points")
    a = [Y[("a", k)][0][0] for k in range(1, 2 * d + 1)]
    slack, M = Y["slack"][0][0], ans["y"]["M"]
    p_obj, d_obj = M, sum(x1) + x2

    res_lin = -1 - (sum(a) + slack - M)
    viol = max(0.0, -_poly_min(a, n, -1.0, float(c), 64 * (2 * d + 1)))

    pts = samples(p)
    with localcontext() as ctx:
        ctx.prec = DIGITS
        G = [gegenbauer_values(2 * d, n, s) for s in pts]
        dres = [X[("a", k)][0][0]
                - (sum(Fraction(xp) * Fraction(Gp[k])
                       for xp, Gp in zip(x1, G)) + x2)
                for k in range(1, 2 * d + 1)]
    dres += [X["slack"][0][0] - x2, x2 - 1]

    return {"gap": gap(p_obj, d_obj),
            "primal_error": max(float(abs(res_lin)), viol),
            "dual_error": max_abs(dres),
            "cone": not_psd(X, Y)}


def dense(p):
    """The problem as dense float64 data for the control
    (``perfbench/reference/ipm64.py``), its SOS blocks in the Chebyshev
    basis of [-1, c]."""
    from perfbench.reference.ipm64 import Dense
    n, d, c = int(p["n"]), int(p["d"]), float(Fraction(p["costheta"]))
    s = np.asarray([float(v) for v in samples(p)])
    m = 2 * d + 2
    w = np.asarray(chebyshev_values(d, (2 * s - (c - 1)) / (c + 1))).T
    G = np.asarray(gegenbauer_values(2 * d, n, s)).T     # [points, 2d + 1]
    A1 = np.zeros((m, d + 1, d + 1))
    A1[:-1] = w[:, :, None] * w[:, None, :]
    A2 = np.zeros((m, d, d))
    wt = (1 + s) * (c - s)
    A2[:-1] = wt[:, None, None] * w[:, :d, None] * w[:, None, :d]
    keys, A = [("SOS", 1), ("SOS", 2)], [A1, A2]
    for k in range(1, 2 * d + 1):
        a = np.ones((m, 1, 1))
        a[:-1, 0, 0] = G[:, k]
        keys.append(("a", k))
        A.append(a)
    sl = np.zeros((m, 1, 1))
    sl[-1] = 1.0
    keys.append("slack")
    A.append(sl)
    B = np.zeros((m, 1))
    B[-1, 0] = -1.0
    return Dense(keys=keys, A=A, B=B, c=-np.ones(m),
                 C=[np.zeros(a.shape[1:]) for a in A], b=np.ones(1),
                 free=["M"], sign=-1.0, rows=[2 * d + 1, 1])
