"""Sanity checks on problems and compiled SDPs.

Port of `ClusteredLowRankSolver.jl/src/checks.jl`: symmetry of all blocks
(including the (r,s) <-> (s,r) transpose convention), well-formed low-rank
decompositions, constraints without PSD variables, and objective variables
unused in constraints.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..utils.hp import to_dd
from .problem import Constraint, LowRankMatPol, Problem, name_of, subblock_of, sortkey

__all__ = ["check_problem", "check_sdp", "check_constraint",
           "check_objective", "remove_empty_blocks"]


def _lr_ok(m: LowRankMatPol) -> bool:
    ok = (len(m.ws) == len(m.vs) == len(m.lam)
          and all(len(v) == len(m.vs[0]) and len(w) == len(m.ws[0])
                  for v, w in zip(m.vs, m.ws)))
    if not ok:
        warnings.warn("A coefficient matrix does not have a correct low-rank "
                      "decomposition (need equal numbers of vectors and "
                      "values, and consistent vector lengths).")
    return ok


def check_constraint(constraint: Constraint) -> bool:
    """checks.jl:174-187."""
    ok = True
    for k, v in constraint.matrixcoeff.items():
        if isinstance(v, LowRankMatPol):
            ok = ok and _lr_ok(v)
        else:
            ok = ok and v.shape[0] == v.shape[1]
    if not constraint.matrixcoeff:
        warnings.warn("This constraint does not use any positive semidefinite "
                      "variables")
        ok = False
    return ok


def check_objective(problem: Problem) -> bool:
    """checks.jl:143-172: objective variables must appear in constraints."""
    ok = True
    for p in problem.objective.matrixcoeff:
        found = any(sortkey(name_of(p)) == sortkey(name_of(k))
                    for c in problem.constraints for k in c.matrixcoeff)
        if not found:
            warnings.warn(f"The PSD variable {name_of(p)!r} is used in the "
                          "objective but not in the constraints.")
            ok = False
    for p in problem.objective.freecoeff:
        found = any(sortkey(p) == sortkey(k)
                    for c in problem.constraints for k in c.freecoeff)
        if not found:
            warnings.warn(f"The free variable {p!r} is used in the objective "
                          "but not in the constraints.")
            ok = False
    return ok


def check_problem(problem: Problem) -> bool:
    """checks.jl:131-140."""
    ok = all(check_constraint(c) for c in problem.constraints)
    return ok and check_objective(problem)


def check_sdp(sdp, eps=1e-10) -> bool:
    """Symmetry check on the compiled SDP (checks.jl:7-62).

    The compiler assembles each constraint row's full matrix (subblocks are
    embedded and dense rows symmetrized), so here we verify symmetry of the
    per-row matrices reconstructed from the term tables / dense arrays.
    """
    ok = True
    for j, cl in enumerate(sdp.clusters):
        for l, bd in enumerate(cl.blocks):
            n = bd.n
            if bd.kind == "dense":
                A = bd.A[0] + bd.A[1]
                if not np.allclose(A, np.swapaxes(A, 1, 2), atol=eps):
                    warnings.warn(f"Non-symmetric dense coefficient in cluster "
                                  f"{j}, block {bd.name!r}.")
                    ok = False
            else:
                V = bd.V[0] + bd.V[1]
                lam = (bd.lam[0] + bd.lam[1]) * bd.tmask
                for p in range(lam.shape[0]):
                    M = np.zeros((n, n))
                    for t in range(lam.shape[1]):
                        if bd.tmask[p, t]:
                            M += lam[p, t] * np.outer(V[:, bd.ri[p, t]],
                                                      V[:, bd.li[p, t]])
                    if not np.allclose(M, M.T, atol=eps * max(1, np.abs(M).max())):
                        warnings.warn(
                            f"Constraint matrix row {p} of block {bd.name!r} "
                            f"(cluster {j}) is not symmetric; make sure the "
                            "(r,s) and (s,r) subblocks are transposes.")
                        ok = False
            C = bd.C[0] + bd.C[1]
            if not np.allclose(C, C.T, atol=eps):
                warnings.warn(f"The objective block for {bd.name!r} is not "
                              "symmetric.")
                ok = False
    return ok


def remove_empty_blocks(sdp, verbose: bool = True):
    """Remove zero coefficient blocks and unused PSD variables from a
    compiled SDP, in place (checks.jl:64-102 `remove_empty_mats!`).

    A block whose every constraint coefficient is zero (all low-rank terms
    masked out or zero, or an all-zero dense tensor) corresponds to a PSD
    variable not used in any constraint of its cluster; the reference
    deletes the variable with an @info. Returns the number of removed
    blocks."""
    removed = 0
    for j, cl in enumerate(sdp.clusters):
        keep = []
        for l, bd in enumerate(cl.blocks):
            if bd.kind == "lowrank":
                lam = (np.asarray(bd.lam[0]) + np.asarray(bd.lam[1])) \
                    * np.asarray(bd.tmask)
                V = np.asarray(bd.V[0]) + np.asarray(bd.V[1])
                empty = not lam.size or not np.any(lam) or not np.any(V)
            else:
                A = np.asarray(bd.A[0]) + np.asarray(bd.A[1])
                empty = not A.size or not np.any(A)
            if empty:
                if verbose:
                    warnings.warn(
                        f"The matrix variable {bd.name!r} (cluster {j}) is "
                        "not used in any constraint and will be removed.")
                removed += 1
            else:
                keep.append(l)
        if len(keep) != len(cl.blocks):
            cl.blocks = [cl.blocks[l] for l in keep]
            if (sdp.matrix_coeff_names is not None
                    and j < len(sdp.matrix_coeff_names)):
                names = sdp.matrix_coeff_names[j]
                sdp.matrix_coeff_names[j] = [names[l] for l in keep
                                             if l < len(names)]
    return removed
