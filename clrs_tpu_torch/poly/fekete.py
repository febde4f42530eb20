"""Approximate Fekete points and basis orthogonalization.

Port of `ClusteredLowRankSolver.jl/src/approximate_fekete.jl`: starting from
candidate points and a polynomial basis, iterate s rounds of V <- V R^{-1}
(QR computed in float64, the basis change applied in high precision), select a
unisolvent subset of points by column-pivoted QR of V^T, and do a final
re-orthogonalization.  High precision here is Decimal (50 digits) in place of
the reference's BigFloat/Arb.
"""

from __future__ import annotations

from decimal import Decimal
from fractions import Fraction

import numpy as np
import scipy.linalg

from ..utils.hp import _as_decimal
from .sampled import SampledPoly, SampledPolyRing

__all__ = ["approximate_fekete", "approximatefekete",
           "approximatefeketeexact"]


def _dec_matrix(a_f64: np.ndarray) -> np.ndarray:
    out = np.empty(a_f64.shape, dtype=object)
    flat = out.reshape(-1)
    for i, v in enumerate(a_f64.reshape(-1)):
        flat[i] = Decimal(float(v))
    return out


def _to_f64(a_obj: np.ndarray) -> np.ndarray:
    return np.array([[float(x) for x in row] for row in a_obj], dtype=np.float64)


def approximate_fekete(initial_points, basis, s: int = 3, verbose: bool = False,
                       show_det: bool = False):
    """Returns (V, P, points): V[i,p] = newbasis_p(point_i) in Decimal,
    P the basis-change matrix from `basis` to the new basis, and the selected
    (sorted) points. Mirrors approximate_fekete (approximate_fekete.jl:6-49)."""
    # Vandermonde in high precision
    V = np.empty((len(initial_points), len(basis)), dtype=object)
    for i, pt in enumerate(initial_points):
        args = pt if isinstance(pt, (list, tuple)) else [pt]
        args = [_as_decimal(a) for a in args]
        for p, pol in enumerate(basis):
            V[i, p] = _as_decimal(pol(*args))
    n = len(basis)
    P = np.empty((n, n), dtype=object)
    for i in range(n):
        for j in range(n):
            P[i, j] = Decimal(1 if i == j else 0)

    for _ in range(s):
        _, r = np.linalg.qr(_to_f64(V))
        u = _dec_matrix(np.linalg.solve(r, np.eye(n)))
        V = V @ u
        P = P @ u

    # select points by column-pivoted QR of V^T
    _, _, piv = scipy.linalg.qr(_to_f64(V).T, pivoting=True)
    point_indices = list(piv[:n])
    Vsel = V[point_indices, :]
    _, r = np.linalg.qr(_to_f64(Vsel))
    u = _dec_matrix(np.linalg.solve(r, np.eye(n)))
    V = Vsel @ u
    P = P @ u
    if show_det:
        print("det:", np.linalg.det(_to_f64(V)))

    pts = [initial_points[i] for i in point_indices]
    order = sorted(range(n), key=lambda i: _ptkey(pts[i]))
    V = V[order, :]
    pts = [pts[i] for i in order]
    return V, P, pts


def _ptkey(p):
    return tuple(p) if isinstance(p, (list, tuple)) else (p,)


def approximatefekete(basis, samples, s: int = 3, verbose: bool = False,
                      show_det: bool = False):
    """basis, samples -> (sampled basis, selected samples).

    Wrapper mirroring `src/interface.jl:263-267`: the returned basis elements
    are :class:`SampledPoly` over the selected sample set, orthogonalized with
    respect to those samples.  Preserves a degree ordering of `basis`.
    """
    V, _, pts = approximate_fekete(samples, basis, s=s, verbose=verbose,
                                   show_det=show_det)
    ring = SampledPolyRing(pts)
    return [SampledPoly(ring, list(V[:, p])) for p in range(len(basis))], pts


def _rationalize(x, tol=Fraction(1, 1000)):
    """Smallest-denominator rational within ``tol`` of x (the analogue of
    Julia's rationalize(BigInt, x; tol), used by approximatefeketeexact)."""
    f = Fraction(float(x))
    for dmax in (1, 8, 64, 512, 4096, 10 ** 6, 10 ** 9, 10 ** 13, 10 ** 17):
        cand = f.limit_denominator(dmax)
        if abs(cand - f) <= tol:
            return cand
    return f


def approximatefeketeexact(basis, samples, s: int = 3):
    """Approximate Fekete with an EXACT (rational) basis transformation
    (approximate_fekete.jl:123-163 `approximatefeketeexact`).

    The candidate samples are rationalized, the Vandermonde matrix is
    evaluated in exact arithmetic, the float-orthogonalized basis-change
    matrix is rationalized, verified invertible, and applied exactly — so
    the returned sampled basis elements have exact Fraction values, usable
    by the exact rounding pipeline (linear systems via sampling stay over
    the rationals)."""
    esamples = []
    for pt in samples:
        if isinstance(pt, (list, tuple)):
            esamples.append(tuple(_rationalize(a) for a in pt))
        else:
            esamples.append(_rationalize(pt))

    def _args(pt):
        return list(pt) if isinstance(pt, (list, tuple)) else [pt]

    npts, n = len(esamples), len(basis)
    eV = np.empty((npts, n), dtype=object)
    for i, pt in enumerate(esamples):
        for p, pol in enumerate(basis):
            v = pol(*_args(pt))
            eV[i, p] = v if isinstance(v, Fraction) else Fraction(v)

    aV = np.array([[float(x) for x in row] for row in eV], dtype=np.float64)
    P = np.eye(n)
    for _ in range(s):
        _, r = np.linalg.qr(aV)
        u = np.linalg.solve(r, np.eye(n))
        aV = aV @ u
        P = P @ u

    _, _, piv = scipy.linalg.qr(aV.T, pivoting=True)
    sample_indices = list(piv[:n])
    _, r = np.linalg.qr(aV[sample_indices, :])
    P = P @ np.linalg.solve(r, np.eye(n))

    eP = np.empty((n, n), dtype=object)
    for i in range(n):
        for j in range(n):
            eP[i, j] = _rationalize(P[i, j])
    # verify the exact transformation is invertible with an EXACT rank
    # check (a float det of an exactly-singular rational matrix is
    # typically a tiny nonzero value, so a float screen alone can silently
    # accept a singular eP; the reference asserts !iszero(det(eP)) on the
    # exact matrix, approximate_fekete.jl:151)
    from ..exact.rational import rref as _rref

    if _rref([list(row) for row in eP])[0] < n:
        raise ValueError("exact Fekete basis change is singular")

    eVnew = eV[sample_indices, :] @ eP
    sel = [esamples[i] for i in sample_indices]
    order = sorted(range(n), key=lambda i: _ptkey(sel[i]))
    sel = [sel[i] for i in order]
    eVnew = eVnew[order, :]
    ring = SampledPolyRing(sel)
    return [SampledPoly(ring, list(eVnew[:, p])) for p in range(n)], sel
