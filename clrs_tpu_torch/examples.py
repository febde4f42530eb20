"""Example problems on the port's API, shared by ``chip_smoke.py`` and
``torch_step_profile.py``."""

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
