"""Minimal multivariate polynomial arithmetic over exact host scalars.

Replaces the reference's use of Nemo/AbstractAlgebra polynomial rings for the
modeling layer (see `ClusteredLowRankSolver.jl/src/interface.jl` passim).
Coefficients are exact (int/Fraction, or number-field elements from
:mod:`clrs_tpu.exact.field`); evaluation promotes into the sample's domain
(Fraction / Decimal / DDScalar) via :func:`clrs_tpu.utils.hp.hp_mul`.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Tuple

from ..utils.hp import hp_add, hp_mul

__all__ = ["PolyRing", "MPoly", "polynomial_ring"]


def _norm_coeff(c):
    if isinstance(c, float):
        return Fraction(c)
    return c


class PolyRing:
    def __init__(self, names):
        self.names = tuple(names)
        self.nvars = len(self.names)

    def __eq__(self, other):
        return isinstance(other, PolyRing) and self.names == other.names

    def __hash__(self):
        return hash(self.names)

    def gens(self):
        return [MPoly(self, {tuple(1 if j == i else 0 for j in range(self.nvars)): 1})
                for i in range(self.nvars)]

    def __call__(self, c):
        if isinstance(c, MPoly):
            if c.ring != self:
                raise ValueError("wrong ring")
            return c
        c = _norm_coeff(c)
        return MPoly(self, {} if _iszero(c) else {(0,) * self.nvars: c})

    def zero(self):
        return MPoly(self, {})

    def one(self):
        return self(1)

    def __repr__(self):
        return f"PolyRing{self.names}"


def polynomial_ring(*names):
    """polynomial_ring('x', 'y') -> (ring, x, y)."""
    if len(names) == 1 and isinstance(names[0], (list, tuple)):
        names = tuple(names[0])
    r = PolyRing(names)
    return (r, *r.gens())


def _iszero(c):
    try:
        return c == 0
    except Exception:
        return False


class MPoly:
    __slots__ = ("ring", "terms")

    def __init__(self, ring: PolyRing, terms: Dict[Tuple[int, ...], object]):
        self.ring = ring
        self.terms = {e: _norm_coeff(c) for e, c in terms.items() if not _iszero(c)}

    # -- ring ops ---------------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, MPoly):
            if other.ring != self.ring:
                raise ValueError("incompatible polynomial rings")
            return other
        return self.ring(other)

    def __add__(self, other):
        o = self._coerce(other)
        t = dict(self.terms)
        for e, c in o.terms.items():
            t[e] = hp_add(t.get(e, 0), c)
        return MPoly(self.ring, t)

    __radd__ = __add__

    def __neg__(self):
        return MPoly(self.ring, {e: hp_mul(-1, c) for e, c in self.terms.items()})

    def __sub__(self, other):
        return self + (-self._coerce(other))

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        if isinstance(other, MPoly) or not hasattr(other, "evaluations"):
            o = self._coerce(other)
            t = {}
            for e1, c1 in self.terms.items():
                for e2, c2 in o.terms.items():
                    e = tuple(a + b for a, b in zip(e1, e2))
                    t[e] = hp_add(t.get(e, 0), hp_mul(c1, c2))
            return MPoly(self.ring, t)
        return NotImplemented

    __rmul__ = __mul__

    def __pow__(self, n: int):
        if n < 0:
            raise ValueError("negative power of a polynomial")
        result = self.ring.one()
        base = self
        while n:
            if n & 1:
                result = result * base
            n >>= 1
            if n:
                base = base * base
        return result

    def __eq__(self, other):
        try:
            o = self._coerce(other)
        except Exception:
            return NotImplemented
        return self.terms == o.terms

    def __hash__(self):
        return hash((self.ring, tuple(sorted(self.terms.items(), key=lambda kv: kv[0]))))

    # -- queries ----------------------------------------------------------
    def total_degree(self):
        return max((sum(e) for e in self.terms), default=0)

    def degree(self, var: int = 0):
        return max((e[var] for e in self.terms), default=0)

    def is_zero(self):
        return not self.terms

    def coefficients(self):
        return list(self.terms.values())

    def exponent_vectors(self):
        return list(self.terms.keys())

    def constant_coefficient(self):
        return self.terms.get((0,) * self.ring.nvars, 0)

    # -- evaluation --------------------------------------------------------
    def __call__(self, *point):
        if len(point) == 1 and isinstance(point[0], (list, tuple)):
            point = tuple(point[0])
        if len(point) != self.ring.nvars:
            raise ValueError(
                f"expected {self.ring.nvars} values, got {len(point)}")
        # sampled-poly composition: evaluate pointwise on the sample grid
        from .sampled import SampledPoly

        if any(isinstance(v, SampledPoly) for v in point):
            rings = {v.ring for v in point if isinstance(v, SampledPoly)}
            if len(rings) != 1:
                raise ValueError("mixed sampled rings")
            sring = rings.pop()
            evals = []
            for i, s in enumerate(sring.samples):
                pt = [v.evaluations[i] if isinstance(v, SampledPoly) else v
                      for v in point]
                evals.append(self(*pt))
            return SampledPoly(sring, evals)
        # precompute powers per variable in the sample domain
        maxe = [0] * self.ring.nvars
        for e in self.terms:
            for i, ei in enumerate(e):
                maxe[i] = max(maxe[i], ei)
        powers = []
        for i, v in enumerate(point):
            p = [1]
            for _ in range(maxe[i]):
                p.append(hp_mul(p[-1], v))
            powers.append(p)
        tot = 0
        for e, c in self.terms.items():
            m = c
            for i, ei in enumerate(e):
                if ei:
                    m = hp_mul(m, powers[i][ei])
            tot = hp_add(tot, m)
        return tot

    def evaluate(self, *point):
        return self(*point)

    def map_coefficients(self, f):
        return MPoly(self.ring, {e: f(c) for e, c in self.terms.items()})

    def __repr__(self):
        if not self.terms:
            return "0"
        parts = []
        for e, c in sorted(self.terms.items()):
            mono = "*".join(
                f"{n}^{k}" if k > 1 else n
                for n, k in zip(self.ring.names, e) if k)
            parts.append(f"({c})" + (f"*{mono}" if mono else ""))
        return " + ".join(parts)
