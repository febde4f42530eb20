"""Example problems on the port's API, shared by ``chip_smoke.py``,
``torch_step_profile.py`` and the tests: copies of the problem builders of
``examples/{delsarte,polyopt,maxcut,delsarte_exact,theta_povm,threepoint,
spherepacking}.py`` (which import the JAX package) on the port's API. The
functions that solve take ``device=`` (the card by default, as
``solvesdp``)."""

from __future__ import annotations

import math
from decimal import Decimal
from fractions import Fraction

import numpy as np

from .device import DEFAULT_DEVICE
from .exact.field import QQ


def delsarte_problem(n, d, costheta):
    """The Delsarte LP bound for spherical codes in dimension ``n`` with
    polynomials of degree ``2 d`` and angle cosine ``costheta``: P = 2 d,
    SOS blocks of sizes d + 1 and d (examples/delsarte.py:15-35)."""
    from . import (Constraint, LowRankMatPol, Minimize, Objective, Problem,
                   approximatefekete, basis_chebyshev, basis_gegenbauer,
                   polynomial_ring, sample_points_chebyshev)

    obj = Objective(0, {}, {"M": 1})
    R, x = polynomial_ring("x")
    samples = sample_points_chebyshev(2 * d, -1, costheta)
    basis = basis_chebyshev(2 * d, x)
    sosbasis, samples = approximatefekete(basis, samples)
    gp = basis_gegenbauer(2 * d, n, x)
    psd1 = {("a", k): [[gp[k]]] for k in range(1, 2 * d + 1)}
    psd1[("SOS", 1)] = LowRankMatPol([1], [sosbasis[: d + 1]])
    psd1[("SOS", 2)] = LowRankMatPol([(1 + x) * (costheta - x)],
                                     [sosbasis[:d]])
    constr1 = Constraint(-1, psd1, {}, samples)
    psd2 = {("a", k): [[1]] for k in range(1, 2 * d + 1)}
    psd2["slack"] = [[1]]
    constr2 = Constraint(-1, psd2, {"M": -1})
    return Problem(Minimize(obj), [constr1, constr2])


def delsarte(n, d, costheta, device=DEFAULT_DEVICE, **kwargs):
    """delsarte_problem solved on ``device`` (examples/delsarte.py:38-41);
    delsarte(3, 10, 1/2) is 13.158314... Returns (problem, status,
    dualsol, primalsol, errorcode)."""
    from . import solvesdp

    problem = delsarte_problem(n, d, costheta)
    status, dualsol, primalsol, t, errorcode = solvesdp(
        problem, device=device, **kwargs)
    return problem, status, dualsol, primalsol, errorcode


def polyopt(f, d, **kwargs):
    """Minimise the univariate polynomial f by maximising lambda such that
    f - lambda is a sum of squares of degree 2 d on Chebyshev samples
    (examples/polyopt.py:16-26); oracle: 1 for x^2 + 1. Returns (problem,
    status, dualsol, primalsol, errorcode) of the port's solvesdp."""
    from . import (Constraint, LowRankMatPol, Maximize, Objective, Problem,
                   basis_chebyshev, sample_points_chebyshev, solvesdp)

    ring = f.ring
    (u,) = ring.gens()
    sosbasis = basis_chebyshev(d, u)
    samples = sample_points_chebyshev(2 * d, -1, 1)
    c = {("sos", 1): LowRankMatPol([1], [sosbasis[: d + 1]])}
    constraint = Constraint(f, c, {"lambda": 1}, samples)
    objective = Objective(0, {}, {"lambda": 1})
    problem = Problem(Maximize(objective), [constraint])
    status, dualsol, primalsol, t, errorcode = solvesdp(problem, **kwargs)
    return problem, status, dualsol, primalsol, errorcode


def invariant_basis(x, y, z, d):
    """S3-invariant basis up to degree d (examples/polyopt.py:43-52)."""
    out = []
    for deg in range(d + 1):
        for j in range(deg // 3 + 1):
            for i in range((deg - 3 * j) // 2 + 1):
                out.append((x + y + z) ** (deg - 2 * i - 3 * j)
                           * (x * y + y * z + z * x) ** i
                           * (x * y * z) ** j)
    return out


def min_f_problem(d):
    """S3-invariant trivariate polynomial optimisation
    (examples/polyopt.py:55-99): maximise M such that f - M is an
    S3-invariant SOS, f = x^4 + y^4 + z^4 - 4xyz + x + y + z; the
    reference's defaults demo, min_f(2) = -2.1129138814..."""
    from . import (Constraint, LowRankMatPol, Maximize, Objective, Problem,
                   approximatefekete, polynomial_ring,
                   sample_points_chebyshev)

    obj = Objective(0, {}, {"M": 1})
    R, x, y, z = polynomial_ring("x", "y", "z")
    f = x ** 4 + y ** 4 + z ** 4 - 4 * x * y * z + x + y + z

    basis = invariant_basis(x, y, z, 2 * d)
    degrees = [p.total_degree() for p in basis]

    cheb = [sample_points_chebyshev(2 * d + k) for k in range(3)]
    grid = [[cheb[0][i], cheb[1][j], cheb[2][k]]
            for i in range(2 * d + 1)
            for j in range(2 * d + 2)
            for k in range(2 * d + 3)]
    sbasis, samples = approximatefekete(basis, grid)

    equivariants = [
        [[R(1)]],
        [[(x - y) * (y - z) * (z - x)]],
        [[(2 * x - y - z), (2 * y * z - x * z - x * y)],
         [(y - z), (x * z - x * y)]],
    ]
    factors = [[1], [1], [Fraction(1, 2), Fraction(3, 2)]]
    psd = {}
    for eqi, eqs in enumerate(equivariants):
        vecs = []
        for row in eqs:
            vec = []
            for eq in row:
                for q, qdeg in zip(sbasis, degrees):
                    if 2 * eq.total_degree() + 2 * qdeg <= 2 * d:
                        vec.append(eq * q)
            if vec:
                vecs.append(vec)
        if vecs:
            psd[("trivariatesos", eqi + 1)] = LowRankMatPol(
                factors[eqi][: len(vecs)], vecs)

    constr = Constraint(f, psd, {"M": 1}, samples)
    return Problem(Maximize(obj), [constr])


def min_f(d, **kwargs):
    """min_f_problem(d) through the port's solvesdp
    (examples/polyopt.py:102-105)."""
    from . import solvesdp

    problem = min_f_problem(d)
    status, dualsol, primalsol, t, code = solvesdp(problem, **kwargs)
    return problem, status, dualsol, primalsol, code


def goemans_williamson(L, eps=1e-15, device=DEFAULT_DEVICE, **kwargs):
    """Goemans-Williamson MAX-CUT relaxation (examples/maxcut.py:14-25):
    maximize <L/4, X> s.t. <E_ii, X> = 1, X PSD; the 3-cycle gives 9/4."""
    from . import Constraint, Maximize, Objective, Problem, solvesdp

    n = len(L)
    obj = Objective(0, {"X": [[Fraction(L[i][j], 4) for j in range(n)]
                              for i in range(n)]}, {})
    constraints = []
    for i in range(n):
        M = [[Fraction(1) if (a == i and b == i) else Fraction(0)
              for b in range(n)] for a in range(n)]
        constraints.append(Constraint(1, {"X": M}, {}))
    problem = Problem(Maximize(obj), constraints)
    status, dualsol, primalsol, t, errorcode = solvesdp(
        problem, duality_gap_threshold=eps, device=device, **kwargs)
    return problem, status, dualsol, primalsol, errorcode


def delsarte_exact_problem(n, d, costheta, FF=QQ):
    """The Delsarte LP bound with rational samples and exact data
    (examples/delsarte_exact.py:21-36); ``costheta`` may lie in a number
    field."""
    from . import (Constraint, LowRankMatPol, Minimize, Objective, Problem,
                   basis_chebyshev, basis_gegenbauer, polynomial_ring,
                   sample_points_chebyshev)

    R, x = polynomial_ring("x")
    gbasis = basis_gegenbauer(2 * d, n, x)
    sosbasis = basis_chebyshev(2 * d, x)
    # rational samples (DelsarteExact.jl:17-18)
    samples = [Fraction(round(float(s) * 10 ** 4), 10 ** 4)
               for s in sample_points_chebyshev(2 * d)]
    c = {}
    for k in range(2 * d + 1):
        c[k] = [[gbasis[k]]]
    c["A"] = LowRankMatPol([1], [sosbasis[: d + 1]])
    c["B"] = LowRankMatPol([(x + 1) * (costheta - x)], [sosbasis[:d]])
    constraints = [Constraint(-1, c, {}, samples)]
    objective = Objective(1, {k: [[1]] for k in range(2 * d + 1)}, {})
    return Problem(Minimize(objective), constraints)


def delsarte_exact(n, d, costheta, FF=QQ, g=1, eps=1e-18,
                   device=DEFAULT_DEVICE, **kwargs):
    """delsarte_exact_problem solved numerically, its field data embedded
    by ``g`` (examples/delsarte_exact.py:39-47). Returns (objective,
    problem, dualsol, primalsol, errorcode)."""
    from . import generic_embedding, objvalue, solvesdp

    problem = delsarte_exact_problem(n, d, costheta, FF)
    if FF is not QQ:
        problem_num = problem.map(lambda v: generic_embedding(v, g))
    else:
        problem_num = problem
    status, dualsol, primalsol, t, code = solvesdp(
        problem_num, duality_gap_threshold=eps, device=device, **kwargs)
    return objvalue(problem_num, primalsol), problem, dualsol, primalsol, code


def delsarte_round(n, d, costheta, FF=QQ, g=1, eps=1e-18,
                   settings=None, verbose=True, device=DEFAULT_DEVICE,
                   **kwargs):
    """delsarte_exact rounded to an exact solution over ``FF``
    (examples/delsarte_exact.py:50-58): delsarte_round(8, 3, 1/2) is 240.
    Returns (success, problem, exact solution)."""
    from . import RoundingSettings, exact_solution, polynomial_ring

    obj, problem, dualsol, primalsol, code = delsarte_exact(
        n, d, costheta, FF=FF, g=g, eps=eps, verbose=verbose, device=device,
        **kwargs)
    R, x = polynomial_ring("x")
    monomial_basis = [x ** k for k in range(2 * d + 1)]
    success, exactsol = exact_solution(
        problem, dualsol, primalsol, FF=FF, g=g,
        settings=settings or RoundingSettings(),
        monomial_bases=[monomial_basis], verbose=verbose)
    return success, problem, exactsol


def lovasz_theta_c5(verbose=False, device=DEFAULT_DEVICE, **kwargs):
    """theta(C5) through the frontend Model: max <J, X> s.t. tr X = 1,
    X_ij = 0 on non-edges, X PSD (examples/theta_povm.py:17-34); sqrt(5),
    exact over Q(sqrt5)."""
    from .frontend import Model

    model = Model()
    edges = {(1, 2), (2, 3), (3, 4), (4, 5), (5, 1)}
    X = model.psd_variable("X", 5)
    for i in range(1, 6):
        for j in range(i + 1, 6):
            if (i, j) not in edges and (j, i) not in edges:
                model.add_constraint(X[i - 1, j - 1] == 0)
    tr = sum(X[i, i] for i in range(5))
    model.add_constraint(tr == 1)
    model.maximize(sum(X[i, j] for i in range(5) for j in range(5)))
    kwargs.setdefault("duality_gap_threshold", 1e-25)  # ~106-bit arithmetic; reference uses 1e-30 at 256-bit
    kwargs.setdefault("omega_p", 100.0)
    kwargs.setdefault("omega_d", 100.0)
    model.solve(verbose=verbose, device=device, **kwargs)
    return model


def povm(verbose=False, device=DEFAULT_DEVICE, **kwargs):
    """Optimal discrimination of two qubit states by a 2-outcome POVM
    through the frontend Model (examples/theta_povm.py:37-55);
    1/2 + sqrt(2)/4, exact over Q(sqrt2)."""
    from .frontend import Model, real_inner

    model = Model()
    states = [np.array([[Fraction(1, 2), Fraction(-1, 2)],
                        [Fraction(-1, 2), Fraction(1, 2)]], dtype=object),
              0.5 * np.array([[1, 1j], [-1j, 1]])]
    E = [model.hermitian_psd_variable(f"E{i}", 2) for i in range(2)]
    # (matrix equality: numpy coerces elementwise `==` on object arrays to
    # bool, so array constraints go through constrain_equal)
    model.constrain_equal(E[0] + E[1], np.eye(2, dtype=object))
    model.maximize((real_inner(states[0], E[0])
                    + real_inner(states[1], E[1])) / 2)
    kwargs.setdefault("duality_gap_threshold", 1e-25)  # ~106-bit arithmetic; reference uses 1e-30 at 256-bit
    kwargs.setdefault("omega_p", 100.0)
    kwargs.setdefault("omega_d", 100.0)
    model.solve(verbose=verbose, device=device, **kwargs)
    return model


def _coeff(p, i):
    return p.terms.get((i,), 0)


def Q_poly(n, k, u, v, t):
    from . import basis_gegenbauer, polynomial_ring

    R, x = polynomial_ring("x")
    p = basis_gegenbauer(k, n, x)[-1]
    tot = 0
    for i in range(k + 1):
        c = _coeff(p, i)
        if c == 0:
            continue
        term = c * ((1 - u ** 2) * (1 - v ** 2)) ** ((k - i) // 2) \
            * (t - u * v) ** i
        tot = term if tot == 0 else tot + term
    return tot


def _mvec(w, d):
    return [w ** k for k in range(d + 1)]


def Smat(n, k, d, u, v, t):
    """S3-symmetrized matrix (ThreePointBound.jl:13-18)."""
    mu = _mvec(u, d - k)
    mv = _mvec(v, d - k)
    mt = _mvec(t, d - k)
    sz = d - k + 1
    out = np.empty((sz, sz), dtype=object)
    quv = Q_poly(n - 1, k, u, v, t)
    qtu = Q_poly(n - 1, k, t, u, v)
    qtv = Q_poly(n - 1, k, t, v, u)
    for i in range(sz):
        for j in range(sz):
            val = quv * (mv[i] * mu[j] + mu[i] * mv[j]) \
                + qtu * (mt[i] * mu[j] + mu[i] * mt[j]) \
                + qtv * (mt[i] * mv[j] + mv[i] * mt[j])
            out[i, j] = Fraction(1, 6) * val
    return out


def _p(u, a, b):
    return (u - a) * (b - u)


def three_point_problem(n, costheta, d2, d3, N2=None, N3=None):
    """The three-point bound for spherical codes
    (examples/threepoint.py:71-193): a univariate and an S3-symmetric
    trivariate SOS constraint sharing the F_k blocks, one cluster."""
    import scipy.linalg

    from . import (Constraint, LowRankMatPol, Minimize, Objective, Problem,
                   basis_chebyshev, basis_gegenbauer, polynomial_ring,
                   sample_points_chebyshev)
    from .poly.sampled import SampledPolyRing

    costheta = Fraction(costheta)
    N2 = max(d2, d3) if N2 is None else N2
    N3 = d3 if N3 is None else N3
    constraints = []

    # --- univariate constraint (ThreePointBound.jl:60-85) ------------------
    W, w = polynomial_ring("w")
    f = {}
    for k in range(d3 + 1):
        T = Smat(n, k, d3, w, w, W(1))
        M = np.empty(T.shape, dtype=object)
        for i in range(T.shape[0]):
            for j in range(T.shape[1]):
                M[i, j] = 3 * T[i, j]
        f[("F", k)] = M
    if d2 >= 0:
        gb = basis_gegenbauer(2 * d2, n, w)
        for k in range(2 * d2 + 1):
            f[("a", k)] = LowRankMatPol([gb[k]], [[1]])
    basis1d = basis_chebyshev(2 * N2, w)
    samples1d = [Fraction(int(np.floor(float(x) * 10 ** 4)), 10 ** 4)
                 for x in sample_points_chebyshev(2 * N2, -1, 1)]
    if N2 >= 0:
        f[("univariatesos", 1)] = LowRankMatPol([1], [basis1d[: N2 + 1]])
    if N2 >= 1:
        f[("univariatesos", 2)] = LowRankMatPol([_p(w, -1, costheta)],
                                                [basis1d[:N2]])
    constraints.append(Constraint(-1, f, {}, samples1d))

    # --- trivariate constraint (ThreePointBound.jl:87-155) -----------------
    R3, u0, v0, t0 = polynomial_ring("u", "v", "t")
    equivariants = [
        [[R3(1)]],
        [[(u0 - v0) * (v0 - t0) * (t0 - u0)]],
        [[2 * u0 - v0 - t0, 2 * v0 * t0 - u0 * t0 - u0 * v0],
         [v0 - t0, u0 * t0 - u0 * v0]],
    ]
    factors = [[1], [1], [Fraction(1, 2), Fraction(3, 2)]]
    weights = [
        R3(1),
        _p(u0, -1, costheta) + _p(v0, -1, costheta) + _p(t0, -1, costheta),
        _p(u0, -1, costheta) * _p(v0, -1, costheta)
        + _p(v0, -1, costheta) * _p(t0, -1, costheta)
        + _p(t0, -1, costheta) * _p(u0, -1, costheta),
        _p(u0, -1, costheta) * _p(v0, -1, costheta) * _p(t0, -1, costheta),
        2 * u0 * v0 * t0 + 1 - u0 ** 2 - v0 ** 2 - t0 ** 2,
    ]

    # invariant monomial count up to degree 2*N3
    inv_degs = [(deg, kk, jj) for deg in range(2 * N3 + 1)
                for kk in range(deg // 3 + 1)
                for jj in range((deg - 3 * kk) // 2 + 1)]
    tmp = len(inv_degs)
    cheb = [sample_points_chebyshev(2 * N3 + k, -1, 1) for k in range(3)]
    grid = [[cheb[0][i], cheb[1][j], cheb[2][k]]
            for i in range(2 * N3 + 1)
            for j in range(2 * N3 + 2)
            for k in range(2 * N3 + 3)]
    # unisolvent subset via pivoted QR over the invariant Vandermonde
    V = np.empty((len(grid), tmp))
    for gi, pt in enumerate(grid):
        su = float(pt[0]) + float(pt[1]) + float(pt[2])
        sp = (float(pt[0]) * float(pt[1]) + float(pt[1]) * float(pt[2])
              + float(pt[0]) * float(pt[2]))
        st = float(pt[0]) * float(pt[1]) * float(pt[2])
        for ci, (deg, kk, jj) in enumerate(inv_degs):
            V[gi, ci] = su ** (deg - 3 * kk - 2 * jj) * sp ** jj * st ** kk
    _, _, piv = scipy.linalg.qr(V.T, pivoting=True)
    chosen = sorted(piv[:tmp])
    samples = sorted(
        tuple(Fraction(int(np.floor(float(x) * 10 ** 4)), 10 ** 4) for x in grid[gi])
        for gi in chosen)
    samples = [list(s) for s in dict.fromkeys(samples)]

    ring = SampledPolyRing(samples)
    u = ring(u0)
    v = ring(v0)
    t = ring(t0)

    F = {}
    for k in range(d3 + 1):
        F[("F", k)] = Smat(n, k, d3, u, v, t)

    _, x = polynomial_ring("x")
    tempbasis = _mvec(x, N3)
    basis3d = []
    degrees3d = []
    e1 = u + v + t
    e2 = u * v + v * t + u * t
    e3 = u * v * t
    for deg, kk, jj in [(d, k2, j2) for d in range(N3 + 1)
                        for k2 in range(d // 3 + 1)
                        for j2 in range((d - 3 * k2) // 2 + 1)]:
        q = tempbasis[deg - 3 * kk - 2 * jj](e1) * tempbasis[jj](e2) \
            * tempbasis[kk](e3)
        basis3d.append(q)
        degrees3d.append(deg)

    for wi, weight in enumerate(weights):
        if weight.total_degree() > 2 * N3:
            continue
        for eqi, eqs in enumerate(equivariants):
            vecs = []
            for row in eqs:
                vec = []
                for eq in row:
                    for q, qdeg in zip(basis3d, degrees3d):
                        if (weight.total_degree() + 2 * eq.total_degree()
                                + 2 * qdeg <= 2 * N3):
                            vec.append(eq * q)
                if vec:
                    vecs.append(vec)
            if vecs:
                F[("trivariatesos", wi + 1, eqi + 1)] = LowRankMatPol(
                    [weight * fac for fac in factors[eqi][: len(vecs)]], vecs)
    constraints.append(Constraint(0, F, {}, samples))

    objdict = {("F", 0): np.ones((d3 + 1, d3 + 1), dtype=object)}
    for k in range(0, 2 * d2 + 1):
        objdict[("a", k)] = [[1]]
    obj = Objective(1, objdict, {})
    return Problem(Minimize(obj), constraints)


def three_point_spherical_codes(n, costheta, d2, d3, device=DEFAULT_DEVICE,
                                **kwargs):
    """three_point_problem through the port's solvesdp
    (examples/threepoint.py:196-199); (4, 1/6, -1, 4) rounds to 10."""
    from . import solvesdp

    problem = three_point_problem(n, costheta, d2, d3)
    status, dualsol, primalsol, t, code = solvesdp(problem, device=device,
                                                   **kwargs)
    return problem, status, dualsol, primalsol, code


# ---------------------------------------------------------------------------
# Cohn-Elkies sphere packing bounds (examples/spherepacking.py, from
# ClusteredLowRankSolver.jl examples/SpherePacking.jl); the reference's
# oracle cohnelkies(8, 15) ~ pi^4/384
# ---------------------------------------------------------------------------

def spherevolume(n, r):
    """vol of the n-ball of radius r, in Decimal (examples/spherepacking.py:
    21-24)."""
    from .utils.hp import _as_decimal, gamma_half, pi

    return (pi().sqrt() ** n / gamma_half(Fraction(n, 2) + 1)
            * _as_decimal(r) ** n)


def _scaled_laguerre_basis(n, d, x, scale):
    """Laguerre basis in ``scale * x``, each normalized by its max
    coefficient (examples/spherepacking.py:27-35)."""
    from . import basis_laguerre
    from .utils.hp import _as_decimal

    q = basis_laguerre(2 * d + 1, Fraction(n, 2) - 1, x * scale)
    out = []
    for p in q:
        mx = max(_as_decimal(c) for c in p.terms.values())
        out.append(p * (1 / mx))
    return out


def cohnelkies_problem(n, d, r=1):
    """The Cohn-Elkies bound in the JAX package's well-conditioned form
    (examples/spherepacking.py:38-118): the coefficients of F(f) in the
    Fekete-orthogonalized Laguerre basis as free variables, F(f)(0) >= 1
    through a 1x1 slack block."""
    from . import (Constraint, LowRankMatPol, Minimize, Objective, Problem,
                   approximatefekete, basis_laguerre, polynomial_ring,
                   sample_points_rescaled_laguerre)
    from .poly.fekete import approximate_fekete
    from .poly.sampled import SampledPoly, SampledPolyRing
    from .utils.hp import _as_decimal, pi

    R, x = polynomial_ring("x")
    two_pi = 2 * pi()
    alpha = Fraction(n, 2) - 1

    basis_polys = _scaled_laguerre_basis(n, d, x, two_pi)
    samples0 = sample_points_rescaled_laguerre(2 * d + 1)
    V1, P1, samples1 = approximate_fekete(samples0, basis_polys)
    ring1 = SampledPolyRing(samples1)
    basis1 = [SampledPoly(ring1, list(V1[:, k]))
              for k in range(len(basis_polys))]
    nb = len(basis_polys)  # 2d+2 basis elements / free variables

    # q_k as explicit polynomials: q_k = sum_i P1[i,k] * basis_polys[i]
    q_polys = []
    for k in range(nb):
        acc = R(0)
        for i in range(nb):
            acc = acc + basis_polys[i] * P1[i, k]
        q_polys.append(acc)

    # constraint 1: sum_k b_k q_k(x) = <SOS21, bb^T> + x <SOS22, bb^T>
    free1 = {k: -basis1[k] for k in range(nb)}
    psd1 = {"SOS21": LowRankMatPol([1], [basis1[: d + 1]]),
            "SOS22": LowRankMatPol([x], [basis1[: d + 1]])}
    con1 = Constraint(0, psd1, free1, samples1)

    # normalization: sum_k b_k q_k(0) - slack = 1  (slack >= 0)
    con0 = Constraint(1, {"slack0": [[-1]]},
                      {k: q_polys[k](Fraction(0)) for k in range(nb)})

    # constraint 2: SOS + (x - r^2) SOS + sum_k b_k g_k(pi x) = 0 for
    # x >= r^2, g_k = sum_m c_{k,m} m!/pi^m L_m(pi x) with c_{k,m} the
    # monomial coefficients of q_k
    lag = basis_laguerre(2 * d + 1, alpha, x * pi())
    g = []
    for k in range(nb):
        acc = R(0)
        for m in range(nb):
            c_km = q_polys[k].terms.get((m,), 0)
            if c_km != 0:
                acc = acc + lag[m] * (_as_decimal(c_km)
                                      * Decimal(math.factorial(m)) / pi() ** m)
        g.append(acc)

    basis2_polys = _scaled_laguerre_basis(n, d, x, two_pi)
    r2 = _as_decimal(r) ** 2
    samples2 = [s + r2 for s in sample_points_rescaled_laguerre(2 * d + 1)]
    basis2, samples2 = approximatefekete(basis2_polys, samples2)

    free2 = {k: g[k] for k in range(nb)}
    psd2 = {"SOS31": [[basis2[0] * basis2[0]]],
            "SOS32": LowRankMatPol([x - Fraction(r) ** 2],
                                   [basis2[: d + 1]])}
    # per-sample row scaling by exact powers of two (interface.jl:493)
    scalings2 = []
    for s_pt in samples2:
        mx = max(abs(float(_as_decimal(gk(s_pt)))) for gk in g)
        scalings2.append(Fraction(2) ** (-int(math.log2(mx))) if mx > 0
                         else 1)
    con2 = Constraint(0, psd2, free2, samples2, scalings2)

    # objective: vol(B(r/2)) * f(0) = vol * sum_k b_k g_k(0)
    vol = spherevolume(n, Fraction(r, 2))
    freedict = {k: vol * _as_decimal(g[k](Fraction(0))) for k in range(nb)}
    obj = Objective(0, {}, freedict)
    return Problem(Minimize(obj), [con0, con1, con2])


def cohnelkies(n, d, r=1, device=DEFAULT_DEVICE, **kwargs):
    """cohnelkies_problem solved on ``device`` (examples/spherepacking.py:
    121-124). Returns (problem, status, dualsol, primalsol, errorcode)."""
    from . import solvesdp

    problem = cohnelkies_problem(n, d, r)
    status, dualsol, primalsol, t, code = solvesdp(problem, device=device,
                                                   **kwargs)
    return problem, status, dualsol, primalsol, code


def Nsphere_packing_problem(n, d, r, N=None):
    """Multi-radius sphere packing (examples/spherepacking.py:127-193)."""
    from . import (Block, Constraint, LowRankMatPol, Minimize, Objective,
                   Problem, approximatefekete, basis_laguerre,
                   polynomial_ring, sample_points_rescaled_laguerre)
    from .utils.hp import _as_decimal, pi, sqrt_dec

    N = len(r) if N is None else N
    R, x = polynomial_ring("x")
    two_pi = 2 * pi()
    alpha = Fraction(n, 2) - 1
    constraints = []

    # constraint 1: PSD1_{ij} - a_{ij,0} = -sqrt(vol_i vol_j)
    for i in range(1, N + 1):
        for j in range(1, i + 1):
            const = -sqrt_dec(spherevolume(n, r[i - 1])
                              * spherevolume(n, r[j - 1]))
            if i != j:
                psd = {Block("PSD1", i, j): LowRankMatPol([Fraction(1, 2)],
                                                          [[1]]),
                       Block("PSD1", j, i): LowRankMatPol([Fraction(1, 2)],
                                                          [[1]])}
            else:
                psd = {Block("PSD1", i, j): LowRankMatPol([1], [[1]])}
            constraints.append(Constraint(const, psd, {(0, i, j): -1}))

    basis = _scaled_laguerre_basis(n, d, x, two_pi)
    samples = sample_points_rescaled_laguerre(2 * d + 1)
    basis, samples = approximatefekete(basis, samples)

    # constraint 2: sum_k a_{ij,k} x^k is an SOS matrix entrywise
    for i in range(1, N + 1):
        for j in range(1, i + 1):
            psd = {}
            free = {}
            if i != j:
                for k in range(0, 2 * d + 2):
                    free[(k, i, j)] = -2 * x ** k
                psd[Block("SOS21", i, j)] = LowRankMatPol([1],
                                                          [basis[: d + 1]])
                psd[Block("SOS22", i, j)] = LowRankMatPol([x],
                                                          [basis[: d + 1]])
                psd[Block("SOS21", j, i)] = LowRankMatPol([1],
                                                          [basis[: d + 1]])
                psd[Block("SOS22", j, i)] = LowRankMatPol([x],
                                                          [basis[: d + 1]])
            else:
                for k in range(0, 2 * d + 2):
                    free[(k, i, j)] = -(x ** k)
                psd[Block("SOS21", i, j)] = LowRankMatPol([1],
                                                          [basis[: d + 1]])
                psd[Block("SOS22", i, j)] = LowRankMatPol([x],
                                                          [basis[: d + 1]])
            constraints.append(Constraint(0, psd, free, samples))

    # constraint 3: -f_{ij} >= 0 beyond (r_i + r_j)^2
    lag = basis_laguerre(2 * d + 1, alpha, x * pi())
    for i in range(1, N + 1):
        for j in range(1, i + 1):
            free = {}
            for k in range(0, 2 * d + 2):
                free[(k, i, j)] = lag[k] * (Decimal(math.factorial(k))
                                            / pi() ** k)
            rij2 = (Fraction(r[i - 1]) + Fraction(r[j - 1])) ** 2
            psd = {("SOS31", i, j): LowRankMatPol([1], [basis[:1]]),
                   ("SOS32", i, j): LowRankMatPol([x - rij2],
                                                  [basis[: d + 1]])}
            constraints.append(Constraint(0, psd, free, samples))

    # constraint 4: M - f_ii(0) >= 0
    lag0 = basis_laguerre(2 * d + 1, alpha, x)
    for i in range(1, N + 1):
        free = {}
        for k in range(0, 2 * d + 2):
            free[(k, i, i)] = (Decimal(math.factorial(k)) / pi() ** k) \
                * _as_decimal(lag0[k](Fraction(0)))
        free["M"] = -1
        psd = {("slack4", i): [[1]]}
        constraints.append(Constraint(0, psd, free))

    obj = Objective(0, {}, {"M": 1})
    return Problem(Minimize(obj), constraints)


def Nsphere_packing(n, d, r, N=None, device=DEFAULT_DEVICE, **kwargs):
    """Nsphere_packing_problem solved on ``device``
    (examples/spherepacking.py:196-199). Returns (problem, status,
    dualsol, primalsol, errorcode)."""
    from . import solvesdp

    problem = Nsphere_packing_problem(n, d, r, N)
    status, dualsol, primalsol, t, code = solvesdp(problem, device=device,
                                                   **kwargs)
    return problem, status, dualsol, primalsol, code
