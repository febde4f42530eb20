"""Scalar-constraint modeling front end (the MOI/JuMP-equivalent layer).

The reference exposes its solver to generic conic modeling through a
MathOptInterface wrapper (`ClusteredLowRankSolver.jl/ext/MOIExt.jl`) and a
JuMP rounding bridge (`ext/JuMPExt.jl`): PSD and nonnegative variables,
scalar affine equality constraints, and `exact_solution`/`find_field` on the
solved model. This module is the Python-native equivalent: a :class:`Model`
holding symbolic affine expressions over entries of PSD blocks, nonnegative
scalars, and free variables, compiled down to the same `Problem` IR the rest
of the framework consumes (so clustering, preprocessing, the solver on the card
and the exact rounding pipeline all apply unchanged).

Supported surface (mirrors MOIExt.jl:156-182):
- PSD matrix variables (`Model.psd_variable`)  — MOI `PSDConeTriangle`
- Hermitian PSD matrix variables (`Model.hermitian_psd_variable`) — JuMP's
  `HermitianPSDCone` (bridged in the reference to a real 2n x 2n embedding;
  we build the same embedding explicitly)
- nonnegative scalars (`Model.nonneg_variable`) — MOI `Nonnegatives`
- free scalars (`Model.free_variable`)
- scalar affine equality constraints (`expr == rhs`), including complex
  expressions which split into real and imaginary parts
- Max/Min objectives; `exact_solution(model)` / `find_field(model)` as in
  `ext/JuMPExt.jl:19-101`.

Coefficients are kept exact (int/Fraction) whenever the user supplies exact
values, so the rounding pipeline sees the same exact problem data it would
from the native modeling API.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..model.problem import (Constraint, Maximize, Minimize, Objective,
                             Problem)
from ..device import DEFAULT_DEVICE
from ..solver.ipm import solvesdp
from ..solver.status import objvalue

__all__ = ["Model", "LinExpr", "exact_solution", "find_field", "trace",
           "real_inner", "hermitian_dot"]


def _exactify(v):
    """ints stay ints; floats that are exact dyadics become Fractions."""
    if isinstance(v, (int, Fraction)):
        return v
    if isinstance(v, float):
        return Fraction(v)  # exact: floats are dyadic rationals
    return v


def _split_complex(v) -> Tuple[Any, Any]:
    if isinstance(v, complex):
        return _exactify(v.real), _exactify(v.imag)
    if isinstance(v, tuple) and len(v) == 2:
        return _exactify(v[0]), _exactify(v[1])
    return _exactify(v), 0


class LinExpr:
    """Affine expression sum_k c_k * var_k + const, complex coefficients.

    Coefficients are stored as (re, im) pairs of exact numbers. Variables
    are opaque hashable keys owned by the Model.
    """

    __slots__ = ("terms", "const")

    def __init__(self, terms=None, const=(0, 0)):
        self.terms: Dict[Any, Tuple[Any, Any]] = dict(terms or {})
        self.const = const

    @staticmethod
    def _coerce(other):
        if isinstance(other, LinExpr):
            return other
        return LinExpr({}, _split_complex(other))

    def __add__(self, other):
        o = LinExpr._coerce(other)
        t = dict(self.terms)
        for k, (re, im) in o.terms.items():
            pre, pim = t.get(k, (0, 0))
            t[k] = (pre + re, pim + im)
        return LinExpr(t, (self.const[0] + o.const[0],
                           self.const[1] + o.const[1]))

    __radd__ = __add__

    def __neg__(self):
        return LinExpr({k: (-re, -im) for k, (re, im) in self.terms.items()},
                       (-self.const[0], -self.const[1]))

    def __sub__(self, other):
        return self + (-LinExpr._coerce(other))

    def __rsub__(self, other):
        return LinExpr._coerce(other) + (-self)

    def __mul__(self, scalar):
        a, b = _split_complex(scalar)
        t = {k: (a * re - b * im, a * im + b * re)
             for k, (re, im) in self.terms.items()}
        cr, ci = self.const
        return LinExpr(t, (a * cr - b * ci, a * ci + b * cr))

    __rmul__ = __mul__

    def __truediv__(self, scalar):
        if isinstance(scalar, int):
            scalar = Fraction(scalar)
        return self * (1 / scalar)

    def __eq__(self, rhs):  # modeling DSL: builds a constraint, not a bool
        return _Con(self, LinExpr._coerce(rhs))

    def __hash__(self):  # keep LinExpr usable in dicts despite __eq__
        return id(self)

    def conj(self):
        return LinExpr({k: (re, -im) for k, (re, im) in self.terms.items()},
                       (self.const[0], -self.const[1]))

    def real_part(self):
        return LinExpr({k: (re, 0) for k, (re, im) in self.terms.items()
                        if re != 0}, (self.const[0], 0))

    def imag_part(self):
        return LinExpr({k: (im, 0) for k, (re, im) in self.terms.items()
                        if im != 0}, (self.const[1], 0))

    def __repr__(self):
        return f"LinExpr({len(self.terms)} terms, const={self.const})"


class _Con:
    def __init__(self, lhs: LinExpr, rhs: LinExpr):
        self.expr = lhs - rhs  # == 0


def _as_expr(v):
    return v if isinstance(v, LinExpr) else LinExpr({}, _split_complex(v))


def trace(M) -> LinExpr:
    """Trace of a square object-array of expressions."""
    n = M.shape[0]
    out = LinExpr()
    for i in range(n):
        out = out + M[i, i]
    return out


def hermitian_dot(S, E) -> LinExpr:
    """<S, E> = tr(S^dagger E) = sum conj(S_ij) E_ij, S a numeric matrix."""
    S = np.asarray(S)
    out = LinExpr()
    for i in range(S.shape[0]):
        for j in range(S.shape[1]):
            s = S[i, j]
            sc = s.conjugate() if isinstance(s, complex) else s
            if sc != 0:
                out = out + _as_expr(E[i, j]) * sc
    return out


def real_inner(S, E) -> LinExpr:
    """real(tr(S^dagger E)) (the objective form of the reference's POVM
    example, examples/jump.jl:47)."""
    return hermitian_dot(S, E).real_part()


class Model:
    """A conic model over PSD / nonnegative / free scalar variables."""

    def __init__(self):
        self._psd: Dict[str, int] = {}        # block name -> size
        self._free: list = []
        self._cons: list = []                 # list of LinExpr (== 0)
        self._objective: Optional[LinExpr] = None
        self._maximize = True
        self._var_names: Dict[Any, Any] = {}  # free var key -> display name
        self.problem: Optional[Problem] = None
        self.status = None
        self.dualsol = None
        self.primalsol = None
        self.errorcode = None

    # -- variables ---------------------------------------------------------

    def psd_variable(self, name: str, n: int):
        """n x n symmetric PSD matrix variable; returns an object array of
        scalar LinExpr entries (entry (i,j) aliases (j,i))."""
        if name in self._psd:
            raise ValueError(f"duplicate PSD variable {name!r}")
        self._psd[name] = n
        M = np.empty((n, n), dtype=object)
        for i in range(n):
            for j in range(n):
                key = ("psd", name, min(i, j), max(i, j))
                M[i, j] = LinExpr({key: (1, 0)})
        return M

    def hermitian_psd_variable(self, name: str, n: int):
        """n x n Hermitian PSD variable E = A + iB via the real embedding
        [[A, -B], [B, A]] (2n x 2n real PSD) plus the structural equalities
        tying the two A copies and forcing B antisymmetric — the same
        reduction JuMP's HermitianPSDCone bridge performs for the reference
        (examples/jump.jl:43)."""
        Y = self.psd_variable(name, 2 * n)
        for i in range(n):
            for j in range(i, n):
                self.add_constraint(Y[i, j] == Y[n + i, n + j])
                if i == j:
                    self.add_constraint(Y[i, n + i] == 0)
                else:
                    self.add_constraint(Y[i, n + j] == -Y[j, n + i])
        E = np.empty((n, n), dtype=object)
        for i in range(n):
            for j in range(n):
                # A[i,j] + i*B[i,j]; B = bottom-left block of the embedding
                E[i, j] = Y[i, j].real_part() + Y[n + i, j] * 1j
        return E

    def nonneg_variable(self, name) -> LinExpr:
        """scalar x >= 0, modeled as a 1x1 PSD block (MOIExt.jl:326-392
        maps Nonnegatives the same way)."""
        bname = f"__nonneg_{name}"
        if bname in self._psd:
            raise ValueError(f"duplicate nonneg variable {name!r}")
        self._psd[bname] = 1
        return LinExpr({("psd", bname, 0, 0): (1, 0)})

    def free_variable(self, name) -> LinExpr:
        key = ("free", name)
        if key in self._var_names:
            raise ValueError(f"duplicate free variable {name!r}")
        self._free.append(name)
        self._var_names[key] = name
        return LinExpr({key: (1, 0)})

    # -- constraints & objective -------------------------------------------

    def add_constraint(self, con):
        """Accepts `expr == rhs` results, (lhs, rhs) pairs, or elementwise
        object arrays; complex constraints split into re/im parts."""
        if isinstance(con, np.ndarray):
            for idx in np.ndindex(*con.shape):
                self.add_constraint(con[idx])
            return
        if isinstance(con, tuple) and len(con) == 2:
            con = _Con(_as_expr(con[0]), _as_expr(con[1]))
        if not isinstance(con, _Con):
            raise TypeError("expected `expr == rhs` (or an array of them)")
        for part in (con.expr.real_part(), con.expr.imag_part()):
            if part.terms:
                self._cons.append(part)
            elif part.const[0] != 0:
                raise ValueError("constraint is constant and nonzero: "
                                 "infeasible by construction")

    def constrain_equal(self, A, B):
        """Elementwise A == B for object arrays / scalars."""
        A = np.asarray(A, dtype=object)
        B = np.asarray(B, dtype=object) if not np.isscalar(B) else B
        for idx in np.ndindex(*A.shape):
            rhs = B if np.isscalar(B) else B[idx]
            self.add_constraint(_Con(_as_expr(A[idx]), _as_expr(rhs)))

    def maximize(self, expr):
        self._objective = _as_expr(expr)
        self._maximize = True

    def minimize(self, expr):
        self._objective = _as_expr(expr)
        self._maximize = False

    # -- compile & solve ----------------------------------------------------

    def _expr_to_coeffs(self, expr: LinExpr):
        """LinExpr -> (matrixcoeff dict, freecoeff dict, constant).

        A coefficient c on PSD entry (i,j), i<j, becomes c/2 on A_ij and
        A_ji so that <A, Y> = c * Y_ij (Y symmetric)."""
        mats: Dict[str, Any] = {}
        free: Dict[Any, Any] = {}
        for key, (re, _im) in expr.terms.items():
            if re == 0:
                continue
            if key[0] == "psd":
                _, name, i, j = key
                n = self._psd[name]
                if name not in mats:
                    m = np.empty((n, n), dtype=object)
                    m[:] = Fraction(0)
                    mats[name] = m
                if i == j:
                    mats[name][i, i] += re
                else:
                    half = re / 2 if not isinstance(re, int) else Fraction(re, 2)
                    mats[name][i, j] += half
                    mats[name][j, i] += half
            else:
                free[key[1]] = free.get(key[1], 0) + re
        mats = {k: m for k, m in mats.items()
                if any(m[idx] != 0 for idx in np.ndindex(*m.shape))}
        return mats, {k: v for k, v in free.items() if v != 0}, expr.const[0]

    def build_problem(self) -> Problem:
        if self._objective is None:
            raise ValueError("no objective set")
        omats, ofree, oconst = self._expr_to_coeffs(self._objective)
        obj = Objective(oconst, omats, ofree)
        cons = []
        seen = set()
        for expr in self._cons:
            mats, free, const = self._expr_to_coeffs(expr)
            if not mats and not free:
                if const != 0:
                    raise ValueError("infeasible constant constraint")
                continue
            sig = repr((sorted((k, m.tolist()) for k, m in mats.items()),
                        sorted(free.items(), key=repr), const))
            if sig in seen:  # exact duplicates (e.g. Hermitian redundancy)
                continue
            seen.add(sig)
            # constraint is expr == 0  =>  <A,Y> + B y = -const
            cons.append(Constraint(-const, mats, free))
        self.problem = Problem(
            Maximize(obj) if self._maximize else Minimize(obj), cons)
        return self.problem

    def solve(self, device=DEFAULT_DEVICE, **kwargs):
        """Build the problem and solve it with the port's ``solvesdp`` on
        ``device`` (the card by default; ``"cpu"`` runs the kernels' plain
        versions)."""
        problem = self.build_problem()
        (self.status, self.dualsol, self.primalsol,
         t, self.errorcode) = solvesdp(problem, device=device, **kwargs)
        return self.status

    # -- solution access ----------------------------------------------------

    def objective_value(self):
        return objvalue(self.problem, self.primalsol)

    def value(self, expr, sol=None):
        """Numeric value of an expression or object array of expressions."""
        if isinstance(expr, np.ndarray):
            out = np.empty(expr.shape, dtype=complex)
            for idx in np.ndindex(*expr.shape):
                out[idx] = self.value(expr[idx], sol)
            return out
        sol = sol or self.primalsol
        re, im = expr.const
        tot = complex(float(re), float(im))
        for key, (cre, cim) in expr.terms.items():
            if key[0] == "psd":
                _, name, i, j = key
                v = float(sol.matrixvars[name][i, j])
            else:
                v = float(sol.freevars[key[1]])
            tot += complex(float(cre), float(cim)) * v
        return tot


def find_field(model: Model, **kwargs):
    """Field detection on the solved model (ext/JuMPExt.jl:19-40)."""
    from ..round.find_field import find_field as _ff

    return _ff(model.dualsol, model.primalsol, **kwargs)


def exact_solution(model: Model, FF=None, g=1, settings=None, verbose=True,
                   **kwargs):
    """Round the model's numerical solution to an exact one
    (ext/JuMPExt.jl:42-101). Returns (success, problem, exact_solution)."""
    from ..exact.field import QQ
    from ..round.rounding import exact_solution as _es

    FF = QQ if FF is None else FF
    success, esol = _es(model.problem, model.dualsol, model.primalsol,
                        FF=FF, g=g, settings=settings, verbose=verbose,
                        **kwargs)
    return success, model.problem, esol
