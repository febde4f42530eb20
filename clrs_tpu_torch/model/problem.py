"""Problem IR: the modeling layer.

Python equivalents of the reference modeling types
(`ClusteredLowRankSolver.jl/src/interface.jl:438-752`):

- :class:`Block` — subblock key (l, r, s) for a PSD variable
- :class:`LowRankMatPol` — symbolic sum_k lambda_k(x) v_k(x) w_k(x)^T
- :class:`Constraint` — <A_i(x), Y_i> + sum_j b_j(x) y_j = c(x), sampled
- :class:`Objective`, :class:`Maximize`, :class:`Minimize`, :class:`Problem`

Constraint semantics match `src/interface.jl:478-513`: dense (non-LowRank)
matrix coefficients are auto-symmetrized; the solver assumes
A[l][r,s] == A[l][s,r]^T, so users must supply both subblocks of an
off-diagonal pair (as the reference's examples do).
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Dict, List

import numpy as np

__all__ = [
    "Block",
    "LowRankMatPol",
    "Constraint",
    "Objective",
    "Maximize",
    "Minimize",
    "Problem",
    "name_of",
    "subblock_of",
    "sortkey",
    "addconstraint",
    "matrixcoeff",
    "matrixcoeffs",
    "freecoeff",
    "freecoeffs",
    "objective",
    "constraints",
    "blocksizes",
]


def sortkey(k) -> str:
    """Deterministic total order on arbitrary hashable block/variable names."""
    return repr(k)


@dataclasses.dataclass(frozen=True, order=False)
class Block:
    """Key for the (r,s) subblock of PSD variable `l` (interface.jl:442-475)."""

    l: Any
    r: int = 1
    s: int = 1

    def __lt__(self, other):
        return (sortkey(self.l), self.r, self.s) < (
            (sortkey(other.l), other.r, other.s)
            if isinstance(other, Block)
            else (sortkey(other), 1, 1)
        )


def name_of(b):
    return b.l if isinstance(b, Block) else b


def subblock_of(b):
    return (b.r, b.s) if isinstance(b, Block) else (1, 1)


class LowRankMatPol:
    """sum_k lambda_k v_k w_k^T with polynomial/scalar entries (interface.jl:273-317)."""

    def __init__(self, lam: List, vs: List[List], ws: List[List] = None):
        ws = vs if ws is None else ws
        if not (len(lam) == len(vs) == len(ws)):
            raise ValueError("LowRankMatPol needs equally many values and vectors")
        if len({len(v) for v in vs}) > 1 or len({len(w) for w in ws}) > 1:
            raise ValueError("inconsistent rank-1 factor sizes in LowRankMatPol")
        self.lam = list(lam)
        self.vs = [list(v) for v in vs]
        self.ws = [list(w) for w in ws]

    @property
    def shape(self):
        return (len(self.vs[0]), len(self.ws[0]))

    @property
    def rank(self):
        return len(self.lam)

    def transpose(self):
        return LowRankMatPol(self.lam, self.ws, self.vs)

    @property
    def T(self):
        return self.transpose()

    def __getitem__(self, ij):
        i, j = ij
        from ..utils.hp import hp_add, hp_mul

        tot = 0
        for k in range(self.rank):
            tot = hp_add(tot, hp_mul(self.lam[k], hp_mul(self.vs[k][i], self.ws[k][j])))
        return tot

    def map(self, f):
        return LowRankMatPol(
            [f(x) for x in self.lam],
            [[f(x) for x in v] for v in self.vs],
            [[f(x) for x in w] for w in self.ws],
        )

    def to_dense(self):
        n, m = self.shape
        out = np.empty((n, m), dtype=object)
        for i in range(n):
            for j in range(m):
                out[i, j] = self[i, j]
        return out

    def __repr__(self):
        return f"LowRankMatPol(rank={self.rank}, shape={self.shape})"


def _as_dense(m):
    """Normalize a dense matrix coefficient to an object numpy array."""
    if isinstance(m, np.ndarray):
        arr = m.astype(object) if m.dtype != object else m.copy()
    else:
        arr = np.array(m, dtype=object)
    if arr.ndim == 0:
        arr = arr.reshape(1, 1)
    elif arr.ndim == 1:
        arr = arr.reshape(len(arr), 1)
    return arr


def _is_symmetric_obj(a) -> bool:
    n, m = a.shape
    if n != m:
        return False
    for i in range(n):
        for j in range(i + 1, n):
            if not _sym_eq(a[i, j], a[j, i]):
                return False
    return True


def _sym_eq(x, y):
    try:
        return bool(x == y)
    except Exception:
        return x is y


class Constraint:
    """One sampled polynomial equality constraint (interface.jl:478-513)."""

    def __init__(self, constant, matrixcoeff: Dict, freecoeff: Dict = None,
                 samples: List = None, scalings: List = None):
        freecoeff = {} if freecoeff is None else dict(freecoeff)
        if samples is None:
            samples = [0]  # scalar constraint: evaluate at a dummy sample
        if scalings is None:
            scalings = [1 for _ in samples]
        mc = {}
        for k, m in matrixcoeff.items():
            if isinstance(m, LowRankMatPol):
                mc[k] = m
            else:
                dm = _as_dense(m)
                if not _is_symmetric_obj(dm):
                    from ..utils.hp import hp_add, hp_mul

                    sym = np.empty_like(dm)
                    for i in range(dm.shape[0]):
                        for j in range(dm.shape[1]):
                            sym[i, j] = hp_mul(Fraction(1, 2), hp_add(dm[i, j], dm[j, i]))
                    dm = sym
                mc[k] = dm
        self.constant = constant
        self.matrixcoeff = mc
        self.freecoeff = freecoeff
        self.samples = list(samples)
        self.scalings = list(scalings)

    def __repr__(self):
        return (f"Constraint(blocks={sorted(map(sortkey, self.matrixcoeff))}, "
                f"free={sorted(map(sortkey, self.freecoeff))}, "
                f"nsamples={len(self.samples)})")


class Objective:
    """Objective data (interface.jl:515-529)."""

    def __init__(self, constant, matrixcoeff: Dict = None, freecoeff: Dict = None):
        self.constant = constant
        self.matrixcoeff = {} if matrixcoeff is None else dict(matrixcoeff)
        self.freecoeff = {} if freecoeff is None else dict(freecoeff)


class Maximize:
    def __init__(self, obj: Objective):
        self.objective = obj


class Minimize:
    def __init__(self, obj: Objective):
        self.objective = obj


class Problem:
    """A clustered low-rank SDP modeling problem (interface.jl:581-605)."""

    def __init__(self, arg1, arg2=None, arg3=None):
        if isinstance(arg1, (Maximize, Minimize)):
            self.maximize = isinstance(arg1, Maximize)
            self.objective = arg1.objective
            self.constraints = list(arg2)
        else:
            self.maximize = bool(arg1)
            self.objective = arg2
            self.constraints = list(arg3)
        assert all(isinstance(c, Constraint) for c in self.constraints)

    def map(self, f):
        """Apply f to every coefficient (interface.jl:628-635)."""
        o = self.objective
        obj = Objective(
            f(o.constant),
            {k: (v.map(f) if isinstance(v, LowRankMatPol)
                 else np.vectorize(f, otypes=[object])(_as_dense(v)))
             for k, v in o.matrixcoeff.items()},
            {k: f(v) for k, v in o.freecoeff.items()},
        )
        cons = []
        for c in self.constraints:
            cons.append(Constraint(
                f(c.constant),
                {k: (v.map(f) if isinstance(v, LowRankMatPol)
                     else np.vectorize(f, otypes=[object])(v))
                 for k, v in c.matrixcoeff.items()},
                {k: f(v) for k, v in c.freecoeff.items()},
                c.samples,
                c.scalings,
            ))
        return Problem(self.maximize, obj, cons)


def addconstraint(problem: Problem, constraint: Constraint):
    problem.constraints.append(constraint)


def matrixcoeff(x, name):
    return x.matrixcoeff[name]


def matrixcoeffs(x):
    return x.matrixcoeff


def freecoeff(x, name):
    return x.freecoeff[name]


def freecoeffs(x):
    return x.freecoeff


def objective(x):
    return x.objective


def constraints(problem: Problem):
    return problem.constraints


def blocksizes(problem: Problem):
    """Sizes of matrix variables keyed like the constraints (interface.jl:1337-1343)."""
    out = {}
    for c in problem.constraints:
        for k, v in c.matrixcoeff.items():
            out[k] = v.shape[0]
    return out
