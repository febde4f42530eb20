"""Example problems on the port's API, shared by ``chip_smoke.py``,
``torch_step_profile.py`` and the tests: copies of the problem builders of
``examples/delsarte.py`` and ``examples/polyopt.py`` (which import the JAX
package) on the port's API."""

from __future__ import annotations


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
    from fractions import Fraction

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
