"""The three-point bound for spherical codes (upstream
``examples/ThreePointBound.jl``), worked out again from (n, cos theta, d2,
d3), and the checks of a solve's answer against it.

Two constraints share the dense blocks ("F", k), k = 0..d3 (the
S3-symmetrized matrices S_k of degree d3):
- univariate, constant -1, at the 2 N2 + 1 Chebyshev points of [-1, 1]
  cut to four decimals (N2 = max(d2, d3)): 3 S_k(w, w, 1), the Gegenbauer
  terms ("a", k) for k <= 2 d2, and two SOS blocks in the Chebyshev basis
  ("univariatesos", 1 and 2, the second weighted by (w + 1)(c - w));
- trivariate, constant 0, at the points that a column-pivoted QR picks
  from a grid of Chebyshev points for the S3-invariant monomials of
  degree <= 2 d3 (cut to four decimals, sorted, repeats dropped): S_k(u,
  v, t), and the SOS blocks ("trivariatesos", weight, equivariant) in the
  invariant basis e1^a e2^b e3^c times the equivariants.
Objective: minimize 1 + <J, Y_F0> + sum_k a_k. Every datum is an exact
rational at these points, so the residuals of an answer are computed
exactly, and so is the cone: every block of X and Y positive
semidefinite.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import scipy.linalg

from perfbench.reference.common import (chebyshev_points, chebyshev_values,
                                        gap, gegenbauer_coeffs,
                                        gegenbauer_values, max_abs, not_psd,
                                        to_f64)

_WEIGHT_DEGREES = (0, 2, 4, 6, 3)
_FACTORS = ([Fraction(1)], [Fraction(1)], [Fraction(1, 2), Fraction(3, 2)])


def _cut(x) -> Fraction:
    """A point cut down to four decimals, as the example cuts them."""
    return Fraction(int(np.floor(float(x) * 10 ** 4)), 10 ** 4)


def _q(coeffs, k, u, v, t):
    """Q_k(u, v, t) = sum_i c_i ((1 - u^2)(1 - v^2))^((k - i)/2) (t - uv)^i
    over the coefficients c_i of G_k for dimension n - 1."""
    base, s = (1 - u * u) * (1 - v * v), t - u * v
    return sum(c * base ** ((k - i) // 2) * s ** i
               for i, c in enumerate(coeffs) if c)


def _smat(gk, k, d, u, v, t):
    """S_k(u, v, t): the (d - k + 1)^2 matrix of ThreePointBound.jl:13-18."""
    sz = d - k + 1
    mu = [u ** i for i in range(sz)]
    mv = [v ** i for i in range(sz)]
    mt = [t ** i for i in range(sz)]
    quv, qtu, qtv = (_q(gk, k, u, v, t), _q(gk, k, t, u, v),
                     _q(gk, k, t, v, u))
    return [[(quv * (mv[i] * mu[j] + mu[i] * mv[j])
              + qtu * (mt[i] * mu[j] + mu[i] * mt[j])
              + qtv * (mt[i] * mv[j] + mv[i] * mt[j])) / 6
             for j in range(sz)] for i in range(sz)]


def _invariant_degrees(top):
    return [(deg, kk, jj) for deg in range(top + 1)
            for kk in range(deg // 3 + 1)
            for jj in range((deg - 3 * kk) // 2 + 1)]


def trivariate_points(d3):
    """The trivariate constraint's points, as the example picks them."""
    N3 = d3
    degs = _invariant_degrees(2 * N3)
    cheb = [[float(v) for v in chebyshev_points(2 * N3 + k, -1, 1)]
            for k in range(3)]
    dcheb = [chebyshev_points(2 * N3 + k, -1, 1) for k in range(3)]
    grid = [(i, j, k) for i in range(2 * N3 + 1) for j in range(2 * N3 + 2)
            for k in range(2 * N3 + 3)]
    V = np.empty((len(grid), len(degs)))
    for gi, (i, j, k) in enumerate(grid):
        a, b, c = cheb[0][i], cheb[1][j], cheb[2][k]
        su, sp, st = a + b + c, (a * b + b * c + a * c), a * b * c
        for ci, (deg, kk, jj) in enumerate(degs):
            V[gi, ci] = su ** (deg - 3 * kk - 2 * jj) * sp ** jj * st ** kk
    _, _, piv = scipy.linalg.qr(V.T, pivoting=True)
    chosen = sorted(piv[:len(degs)])
    pts = sorted(tuple(_cut(dcheb[a][idx]) for a, idx in
                       enumerate(grid[gi])) for gi in chosen)
    return list(dict.fromkeys(pts))


def univariate_points(N2):
    return [_cut(x) for x in chebyshev_points(2 * N2, -1, 1)]


class Problem:
    """The problem's data at every constraint point: for each constraint,
    its constant and, per point, {block: ("dense", rows) or ("lowrank",
    [(lambda, vector)])}."""

    def __init__(self, n, costheta, d2, d3):
        c = Fraction(costheta)
        N2, N3 = max(d2, d3), d3
        self.d2, self.d3 = d2, d3
        gk = [gegenbauer_coeffs(k, n - 1)[k] for k in range(d3 + 1)]

        def pw(z):
            return (z + 1) * (c - z)

        uni = []
        for w in univariate_points(N2):
            row = {("F", k): ("dense",
                              [[3 * e for e in r] for r in
                               _smat(gk[k], k, d3, w, w, Fraction(1))])
                   for k in range(d3 + 1)}
            if d2 >= 0:
                gb = gegenbauer_values(2 * d2, n, w)
                for k in range(2 * d2 + 1):
                    row[("a", k)] = ("lowrank", [(gb[k], [Fraction(1)])])
            T = chebyshev_values(2 * N2, w)
            if N2 >= 0:
                row[("univariatesos", 1)] = ("lowrank",
                                             [(Fraction(1), T[:N2 + 1])])
            if N2 >= 1:
                row[("univariatesos", 2)] = ("lowrank", [(pw(w), T[:N2])])
            uni.append(row)

        basis = _invariant_degrees(N3)
        tri = []
        for u, v, t in trivariate_points(d3):
            row = {("F", k): ("dense", _smat(gk[k], k, d3, u, v, t))
                   for k in range(d3 + 1)}
            e1, e2, e3 = u + v + t, u * v + v * t + u * t, u * v * t
            q = [(e1 ** (deg - 3 * kk - 2 * jj) * e2 ** jj * e3 ** kk, deg)
                 for deg, kk, jj in basis]
            weights = (Fraction(1), pw(u) + pw(v) + pw(t),
                       pw(u) * pw(v) + pw(v) * pw(t) + pw(t) * pw(u),
                       pw(u) * pw(v) * pw(t),
                       2 * u * v * t + 1 - u * u - v * v - t * t)
            eqs = ([[(Fraction(1), 0)]],
                   [[((u - v) * (v - t) * (t - u), 3)]],
                   [[(2 * u - v - t, 1), (2 * v * t - u * t - u * v, 2)],
                    [(v - t, 1), (u * t - u * v, 2)]])
            for wi, (wt, wdeg) in enumerate(zip(weights, _WEIGHT_DEGREES)):
                if wdeg > 2 * N3:
                    continue
                for ei, rows in enumerate(eqs):
                    vecs = []
                    for r in rows:
                        vec = [e * qq for e, edeg in r for qq, qdeg in q
                               if wdeg + 2 * edeg + 2 * qdeg <= 2 * N3]
                        if vec:
                            vecs.append(vec)
                    if vecs:
                        row[("trivariatesos", wi + 1, ei + 1)] = (
                            "lowrank", [(wt * f, vv) for f, vv in
                                        zip(_FACTORS[ei][:len(vecs)], vecs)])
            tri.append(row)
        self.constraints = [(Fraction(-1), uni), (Fraction(0), tri)]
        self.blocks = {k for _, rows in self.constraints for r in rows
                       for k in r}
        self.objective = {("F", 0): [[Fraction(1)] * (d3 + 1)
                                     for _ in range(d3 + 1)]}
        for k in range(2 * d2 + 1):
            self.objective[("a", k)] = [[Fraction(1)]]


def _add_scaled(acc, entry, s):
    kind, data = entry
    if kind == "dense":
        for i, r in enumerate(data):
            for j, a in enumerate(r):
                acc[i][j] += s * a
        return
    for lam, vec in data:
        f = s * lam
        for i, vi in enumerate(vec):
            fv = f * vi
            row = acc[i]
            for j, vj in enumerate(vec):
                row[j] += fv * vj


def shape(p):
    """Clusters and blocks (size, rank) for the roofline's work count."""
    d2, d3 = int(p["d2"]), int(p["d3"])
    prob = Problem(int(p["n"]), Fraction(p["costheta"]), d2, d3)
    P = sum(len(rows) for _, rows in prob.constraints)
    blocks = {}
    for _, rows in prob.constraints:
        for key, (kind, data) in rows[0].items():
            if kind == "dense":
                blocks[key] = [len(data), len(data)]
            else:
                blocks[key] = [len(data[0][1]), len(data)]
    return {"clusters": [{"P": P, "blocks": list(blocks.values())}]}


def _lcm_den(values):
    return math.lcm(*(Fraction(v).denominator for v in values))


def _column(row, keys, sizes):
    """One point's constraint matrices, the blocks of ``keys`` flattened
    and concatenated, as (integer numerators, common denominator)."""
    terms = []                       # (integers, denominator) per block
    for k in keys:
        n = sizes[k]
        if k not in row:
            terms.append(([0] * (n * n), 1))
            continue
        kind, data = row[k]
        if kind == "dense":
            flat = [v for r in data for v in r]
            den = _lcm_den(flat)
            terms.append(([int(v * den) for v in flat], den))
            continue
        acc, den = [0] * (n * n), 1
        for lam, vec in data:
            lam = Fraction(lam)
            dv = _lcm_den(vec)
            vi = [int(v * dv) for v in vec]
            tden = lam.denominator * dv * dv
            new = math.lcm(den, tden)
            acc = [a * (new // den) for a in acc]
            f = lam.numerator * (new // tden)
            for i, a in enumerate(vi):
                fa, base = f * a, i * n
                for j, b in enumerate(vi):
                    acc[base + j] += fa * b
            den = new
        terms.append((acc, den))
    D = math.lcm(*(d for _, d in terms))
    return [v * (D // d) for ints, d in terms for v in ints], D


def _columns(prob, keys, sizes):
    """(integer numerators [points, entries], denominators) of every
    constraint point's matrices, in the constraints' order."""
    cols = [_column(row, keys, sizes)
            for _, rows in prob.constraints for row in rows]
    return np.array([c for c, _ in cols], dtype=object), [d for _, d in cols]


def _primal_residual(prob, Y, keys, N, dens):
    """max_p |c_p - sum_j <A_j(p), Y_j>|, exactly."""
    flat = [v for k in keys for r in Y[k] for v in r]
    Q = _lcm_den(flat)
    sums = N.dot(np.array([int(v * Q) for v in flat], dtype=object))
    consts = [c for c, rows in prob.constraints for _ in rows]
    return max_abs(c - Fraction(int(sv), Q * d)
                   for c, sv, d in zip(consts, sums, dens))


def _dual_residual(prob, X, keys, N, dens):
    """The distance, entry by entry, of X_j - C_j from the span of the
    constraint matrices (sum_p x_p A_j(p) over some x, the blocks taken
    together), exactly: x from a float64 least-squares fit refined on
    exact residuals (integer arithmetic over common denominators). The
    constraint matrices are polynomials sampled at unisolvent points, so
    their span, and this distance, do not depend on which points the port
    or the reference sampled. Returns (distance, x)."""
    sizes = {k: len(X[k]) for k in keys}
    target = []
    for k in keys:
        C = prob.objective.get(k)
        target += [X[k][i][j] - (C[i][j] if C else 0)
                   for i in range(sizes[k]) for j in range(sizes[k])]
    A = np.array([[n / d for n in c] for c, d in zip(N, dens)]).T
    x = [Fraction(0)] * len(dens)
    res = list(target)
    for _ in range(3):
        delta, *_ = np.linalg.lstsq(A, np.array([float(v) for v in res]),
                                    rcond=None)
        x = [a + Fraction(float(b)) for a, b in zip(x, delta)]
        w = [xp / d for xp, d in zip(x, dens)]
        Q = _lcm_den(w)
        W = np.array([int(v * Q) for v in w], dtype=object)
        sums = W.dot(N)
        res = [t - Fraction(int(sv), Q) for t, sv in zip(target, sums)]
    return max_abs(res), x


def check(p, ans):
    """{gap, primal_error, dual_error, cone} of one answer: the gap, the
    larger of two, each dual objective 1 - sum_p c_p x_p (the constants
    are -1 at every univariate point and 0 at every trivariate one, so it
    is the functional at 1, whichever points carry it): from the answer's
    own x, and from the x that :func:`_dual_residual` fits to the
    answer's X at the reference's points, so that the certificate X and
    the objective reported are one; the largest primal residual |c_p -
    sum_j <A_j(p), Y_j>| at the reference's points, exactly; the largest
    entry of X_j - C_j off the span of the constraint matrices, exactly;
    the number of blocks of X and Y not positive semidefinite, exactly."""
    prob = Problem(int(p["n"]), Fraction(p["costheta"]), int(p["d2"]),
                   int(p["d3"]))
    Y, X, x = ans["Y"], ans["X"], ans["x"]
    if [len(v) for v in x] != [len(r) for _, r in prob.constraints]:
        raise ValueError("the answer's constraint points do not match")
    if set(X) != set(Y) or set(Y) != set(prob.blocks):
        raise ValueError("the answer's blocks do not match the problem's")
    p_obj = 1 + sum(sum(sum(a * y for a, y in zip(ra, ry))
                        for ra, ry in zip(C, Y[key]))
                    for key, C in prob.objective.items())
    d_obj = 1 - sum(c * xp for (c, rows), xs in zip(prob.constraints, x)
                    for xp in xs)
    keys = sorted(X, key=repr)
    N, dens = _columns(prob, keys, {k: len(X[k]) for k in keys})
    dual_error, fit = _dual_residual(prob, X, keys, N, dens)
    consts = [c for c, rows in prob.constraints for _ in rows]
    d_fit = 1 - sum(c * xp for c, xp in zip(consts, fit))
    return {"gap": max(gap(p_obj, d_obj), gap(p_obj, d_fit)),
            "primal_error": _primal_residual(prob, Y, keys, N, dens),
            "dual_error": dual_error,
            "cone": not_psd(X, Y)}


def dense(p):
    """The problem as dense float64 data for the control
    (``perfbench/reference/ipm64.py``)."""
    from perfbench.reference.ipm64 import Dense
    prob = Problem(int(p["n"]), Fraction(p["costheta"]), int(p["d2"]),
                   int(p["d3"]))
    keys = sorted(prob.blocks, key=repr)
    rows = [row for _, rs in prob.constraints for row in rs]
    A = []
    for k in keys:
        e = next(r[k] for r in rows if k in r)
        n = len(e[1]) if e[0] == "dense" else len(e[1][0][1])
        a = np.zeros((len(rows), n, n))
        for i, r in enumerate(rows):
            if k in r:
                m = [[Fraction(0)] * n for _ in range(n)]
                _add_scaled(m, r[k], Fraction(1))
                a[i] = to_f64(m)
        A.append(a)
    C = [to_f64(prob.objective[k]) if k in prob.objective
         else np.zeros(a.shape[1:]) for k, a in zip(keys, A)]
    c = np.asarray([float(cc) for cc, rs in prob.constraints for _ in rs])
    return Dense(keys=keys, A=A, B=np.zeros((len(rows), 0)), c=c, C=C,
                 b=np.zeros(0), free=[], sign=-1.0,
                 rows=[len(rs) for _, rs in prob.constraints])
