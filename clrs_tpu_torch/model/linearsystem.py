"""Exact linear-system extraction from a Problem.

Port of `ClusteredLowRankSolver.jl/src/interface.jl:1347-1632`:
- :func:`linearsystem`: A x = b over an exact field via sampling
- :func:`linearsystem_coefficientmatching`: via monomial coefficient matching
- :func:`partial_linearsystem`: column-subset system for the error vector
  (A_I e = b - A x), used by the rounding projection.

Column order matches :func:`clrs_tpu.solver.status.vectorize`: matrix
variables sorted by (size, name), upper-triangle entries (off-diagonal
coefficients doubled), then free variables sorted by name.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List

import numpy as np

from ..model.problem import LowRankMatPol, Problem, blocksizes, sortkey
from ..solver.status import PrimalSolution, as_primal_solution, slacks, vectorize

__all__ = ["linearsystem", "linearsystem_coefficientmatching",
           "partial_linearsystem"]


def _eval(v, sample):
    """myevaluate equivalent: evaluate polynomials, pass scalars through."""
    if hasattr(v, "terms"):  # MPoly
        args = sample if isinstance(sample, (list, tuple)) else [sample]
        return v(*args)
    if hasattr(v, "evaluations"):  # SampledPoly
        return v(sample)
    return v


def _eval_block(m, sample):
    if isinstance(m, LowRankMatPol):
        md = m.to_dense()
    else:
        md = m
    return [[_eval(md[a, b], sample) for b in range(md.shape[1])]
            for a in range(md.shape[0])]


def _sorted_blocks(problem):
    mvd = blocksizes(problem)
    return sorted(mvd.keys(), key=lambda k: (mvd[k], sortkey(k))), mvd


def _sorted_freevars(problem):
    seen = {}
    for c in problem.constraints:
        for k in c.freecoeff:
            seen[sortkey(k)] = k
    return [seen[s] for s in sorted(seen)]


def linearsystem(problem: Problem):
    """(A, b) with rows = (constraint, sample) via sampling (interface.jl:1484-1535)."""
    blocks, mvd = _sorted_blocks(problem)
    free_vars = _sorted_freevars(problem)
    nrs = sum(len(c.samples) for c in problem.constraints)
    ncs = sum(s * (s + 1) // 2 for s in mvd.values()) + len(free_vars)
    A = [[Fraction(0)] * ncs for _ in range(nrs)]
    b = [Fraction(0)] * nrs
    i = 0
    for con in problem.constraints:
        for sample in con.samples:
            j = 0
            for bln in blocks:
                s = mvd[bln]
                if bln in con.matrixcoeff:
                    eb = _eval_block(con.matrixcoeff[bln], sample)
                    for a in range(s):
                        for bcol in range(a, s):
                            val = eb[a][bcol]
                            A[i][j] = 2 * val if a != bcol else val
                            j += 1
                else:
                    j += s * (s + 1) // 2
            for f in free_vars:
                if f in con.freecoeff:
                    A[i][j] = _eval(con.freecoeff[f], sample)
                j += 1
            b[i] = _eval(con.constant, sample)
            i += 1
    return A, b


def _expvec_index(monomial_bases):
    """Per-constraint map: exponent vector of each basis monomial -> row."""
    idx_maps = []
    offset = 0
    for mons in monomial_bases:
        d = {}
        for i, m in enumerate(mons):
            evs = [ev for ev, c in m.terms.items() if c != 0]
            d[evs[-1]] = offset + i
        idx_maps.append(d)
        offset += len(mons)
    return idx_maps, offset


def linearsystem_coefficientmatching(problem: Problem, monomial_bases):
    """(A, b) with one row per monomial (interface.jl:1547-1632)."""
    blocks, mvd = _sorted_blocks(problem)
    free_vars = _sorted_freevars(problem)
    idx_maps, nrs = _expvec_index(monomial_bases)
    ncs = sum(s * (s + 1) // 2 for s in mvd.values()) + len(free_vars)
    A = [[Fraction(0)] * ncs for _ in range(nrs)]
    b = [Fraction(0)] * nrs

    def _terms(v, k):
        ring = monomial_bases[k][-1].ring
        p = ring(v) if not hasattr(v, "terms") else v
        return p.terms.items()

    for k, con in enumerate(problem.constraints):
        jsum = 0
        for bln in blocks:
            s = mvd[bln]
            if bln in con.matrixcoeff:
                m = con.matrixcoeff[bln]
                md = m.to_dense() if isinstance(m, LowRankMatPol) else m
                j = jsum
                for a in range(s):
                    for bcol in range(a, s):
                        for ev, c in _terms(md[a, bcol], k):
                            i = idx_maps[k].get(ev)
                            if i is not None:
                                A[i][j] = 2 * c if a != bcol else c
                        j += 1
            jsum += s * (s + 1) // 2
        j = jsum
        for f in free_vars:
            if f in con.freecoeff:
                for ev, c in _terms(con.freecoeff[f], k):
                    i = idx_maps[k].get(ev)
                    if i is not None:
                        A[i][j] = c
            j += 1
        for ev, c in _terms(con.constant, k):
            i = idx_maps[k].get(ev)
            if i is not None:
                b[i] = c
    return A, b


def partial_linearsystem(problem: Problem, sol: PrimalSolution,
                         columns: List[int], monomial_bases=None):
    """(A_I, b - A x): the system for the error vector over the selected
    columns (interface.jl:1354-1473)."""
    rhs_slacks = slacks(problem, sol)  # Ax - b per constraint (as polys)
    if monomial_bases is None:
        b = []
        for con, sl in zip(problem.constraints, rhs_slacks):
            for sample in con.samples:
                b.append(-_eval(sl, sample))
    else:
        idx_maps, nrs = _expvec_index(monomial_bases)
        b = [Fraction(0)] * nrs
        for k, sl in enumerate(rhs_slacks):
            ring = monomial_bases[k][-1].ring
            p = ring(sl) if not hasattr(sl, "terms") else sl
            for ev, c in p.terms.items():
                i = idx_maps[k].get(ev)
                if i is not None:
                    b[i] = -c

    if monomial_bases is None:
        A_full, _ = linearsystem(problem)
    else:
        A_full, _ = linearsystem_coefficientmatching(problem, monomial_bases)
    A = [[row[c] for c in columns] for row in A_full]
    return A, b
