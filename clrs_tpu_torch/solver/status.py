"""Solver statuses and solution containers.

Equivalents of `ClusteredLowRankSolver.jl/src/interface.jl:1119-1343`:
status types, DualSolution/PrimalSolution, objvalue, accessors, slacks,
vectorize/as_primal_solution (deterministic sorted order).
Solution entries are host :class:`~clrs_tpu.utils.hp.DDScalar` values
(~106 bits), standing in for the reference's BigFloat output.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..model.problem import Block, LowRankMatPol, Problem, sortkey
from ..utils.hp import DDScalar, hp_add, hp_mul

__all__ = [
    "Status", "Optimal", "NearOptimal", "Feasible", "PrimalFeasible",
    "DualFeasible", "NotConverged", "optimal",
    "DualSolution", "PrimalSolution",
    "objvalue", "matrixvar", "matrixvars", "freevar", "freevars",
    "vectorize", "as_primal_solution", "slacks", "traceinner",
]


class Status:
    def __repr__(self):
        return "NOINFO"


class Optimal(Status):
    def __repr__(self):
        return "pdOpt"


class NearOptimal(Status):
    def __repr__(self):
        return "NearOpt"


class Feasible(Status):
    def __repr__(self):
        return "pdFeas"


class DualFeasible(Status):
    def __repr__(self):
        return "dFeas"


class PrimalFeasible(Status):
    def __repr__(self):
        return "pFeas"


class NotConverged(Status):
    def __repr__(self):
        return "NOINFO"


def optimal(status) -> bool:
    return isinstance(status, Optimal)


class DualSolution:
    """x per (constraint, sample) and the dual PSD matrix variables X."""

    def __init__(self, x: List[List], matrixvars: Dict[Any, np.ndarray]):
        self.x = x
        self.matrixvars = matrixvars


class PrimalSolution:
    """PSD matrix variables Y and free variables y."""

    def __init__(self, matrixvars: Dict[Any, np.ndarray], freevars: Dict[Any, Any]):
        self.matrixvars = matrixvars
        self.freevars = freevars


def matrixvar(sol, name):
    return sol.matrixvars[name]


def matrixvars(sol):
    return sol.matrixvars


def freevar(sol: PrimalSolution, name):
    return sol.freevars[name]


def freevars(sol: PrimalSolution):
    return sol.freevars


def traceinner(m, v):
    """<m, v> where m may be LowRankMatPol or a dense matrix."""
    if isinstance(m, LowRankMatPol):
        tot = 0
        for k in range(m.rank):
            # lambda_k * v_k^T V w_k
            acc = 0
            for i, vi in enumerate(m.vs[k]):
                row = 0
                for jj, wj in enumerate(m.ws[k]):
                    row = hp_add(row, hp_mul(wj, v[i][jj] if isinstance(v, list) else v[i, jj]))
                acc = hp_add(acc, hp_mul(vi, row))
            tot = hp_add(tot, hp_mul(m.lam[k], acc))
        return tot
    m = np.asarray(m, dtype=object) if not isinstance(m, np.ndarray) else m
    if m.ndim == 0:
        m = m.reshape(1, 1)
    tot = 0
    for i in range(m.shape[0]):
        for j in range(m.shape[1]):
            tot = hp_add(tot, hp_mul(m[i, j], v[i, j]))
    return tot


def objvalue(problem_or_obj, sol: PrimalSolution):
    """Objective value of a primal solution (interface.jl:1173-1204).

    Variables used in the objective but absent from the solution (removed
    as unconstrained by the cleanup pass — the reference deletes their A
    and C blocks, checks.jl:85-92, after warning via check_problem) are
    skipped with a warning instead of raising."""
    import warnings

    obj = problem_or_obj.objective if hasattr(problem_or_obj, "objective") else problem_or_obj
    tot = obj.constant
    for k, m in obj.matrixcoeff.items():
        if k not in sol.matrixvars:
            warnings.warn(f"objective variable {k!r} is not part of the "
                          "solution (unconstrained variables are removed "
                          "before solving); treating its contribution as 0")
            continue
        tot = hp_add(tot, traceinner(m, sol.matrixvars[k]))
    for k, cf in obj.freecoeff.items():
        if k not in sol.freevars:
            warnings.warn(f"objective variable {k!r} is not part of the "
                          "solution; treating its contribution as 0")
            continue
        tot = hp_add(tot, hp_mul(cf, sol.freevars[k]))
    return tot


def slacks(problem: Problem, sol: PrimalSolution):
    """lhs - rhs for all constraints (interface.jl:1267-1281)."""
    out = []
    for con in problem.constraints:
        slack = hp_mul(-1, con.constant)
        for b, m in con.matrixcoeff.items():
            slack = hp_add(slack, traceinner(m, sol.matrixvars[b]))
        for b, cf in con.freecoeff.items():
            slack = hp_add(slack, hp_mul(cf, sol.freevars[b]))
        out.append(slack)
    return out


def _mv_sortkey(sol):
    return lambda k: (np.asarray(sol.matrixvars[k]).shape[0], sortkey(k))


def vectorize(sol: PrimalSolution):
    """Upper-triangle vectorization, sorted by (size, name) (interface.jl:1289-1301)."""
    v = []
    for k in sorted(sol.matrixvars.keys(), key=_mv_sortkey(sol)):
        m = sol.matrixvars[k]
        n = m.shape[0]
        for i in range(n):
            for j in range(i, n):
                v.append(m[i, j])
    for k in sorted(sol.freevars.keys(), key=sortkey):
        v.append(sol.freevars[k])
    return v


def as_primal_solution(sol: PrimalSolution, x: List):
    """Undo :func:`vectorize` (interface.jl:1304-1329)."""
    t = 0
    mv = {}
    for k in sorted(sol.matrixvars.keys(), key=_mv_sortkey(sol)):
        n = np.asarray(sol.matrixvars[k]).shape[0]
        m = np.empty((n, n), dtype=object)
        for i in range(n):
            for j in range(i, n):
                m[i, j] = m[j, i] = x[t]
                t += 1
        mv[k] = m
    fv = {}
    for k in sorted(sol.freevars.keys(), key=sortkey):
        fv[k] = x[t]
        t += 1
    return PrimalSolution(mv, fv)
