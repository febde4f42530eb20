"""Number fields Q(alpha) with exact arithmetic.

Replaces the reference's Nemo/Antic number fields used by the rounding
pipeline (`ClusteredLowRankSolver.jl/src/rounding.jl`, `src/find_field.jl`):
elements are coefficient vectors modulo a monic rational minimal polynomial;
inversion via the extended Euclidean algorithm over Q[x]; real embedding via
a Decimal approximation of the chosen root.
"""

from __future__ import annotations

from decimal import Decimal
from fractions import Fraction
from typing import List, Optional

from ..utils.hp import HOST_DIGITS, _as_decimal, to_fraction

__all__ = ["NumberField", "NFElem", "QQ", "generic_embedding"]


def _poly_trim(p):
    while p and p[-1] == 0:
        p.pop()
    return p


def _poly_divmod(a, b):
    a = list(a)
    q = [Fraction(0)] * max(0, len(a) - len(b) + 1)
    while len(a) >= len(b) and any(a):
        if a[-1] == 0:
            a.pop()
            continue
        f = a[-1] / b[-1]
        k = len(a) - len(b)
        q[k] = f
        for i in range(len(b)):
            a[k + i] -= f * b[i]
        a.pop()
    return _poly_trim(q), _poly_trim(a)


class NumberField:
    """Q(alpha) where alpha has monic minimal polynomial `minpoly`
    (coefficients low->high, last == 1)."""

    def __init__(self, minpoly: List, name: str = "a", approx_root=None):
        mp = [to_fraction(c) for c in minpoly]
        assert mp[-1] == 1, "minimal polynomial must be monic"
        self.minpoly = mp
        self.degree = len(mp) - 1
        self.name = name
        self.approx_root = approx_root  # Decimal/float approximation

    def __eq__(self, other):
        return isinstance(other, NumberField) and self.minpoly == other.minpoly

    def __hash__(self):
        return hash(tuple(self.minpoly))

    def gen(self):
        c = [Fraction(0)] * self.degree
        if self.degree >= 2:
            c[1] = Fraction(1)
        else:
            # degree-1 field is just Q with alpha = -c0
            c[0] = -self.minpoly[0]
        return NFElem(self, c)

    def __call__(self, x):
        if isinstance(x, NFElem):
            if x.field == self:
                return x
            raise ValueError("element of a different field")
        c = [Fraction(0)] * self.degree
        c[0] = to_fraction(x)
        return NFElem(self, c)

    def zero(self):
        return self(0)

    def one(self):
        return self(1)

    def __repr__(self):
        return f"QQ[{self.name}]/({self.minpoly})"


class NFElem:
    __slots__ = ("field", "coeffs")

    def __init__(self, field: NumberField, coeffs: List[Fraction]):
        assert len(coeffs) == field.degree
        self.field = field
        self.coeffs = [to_fraction(c) for c in coeffs]

    def _coerce(self, other):
        if isinstance(other, NFElem):
            if other.field != self.field:
                raise ValueError("different fields")
            return other
        if isinstance(other, (int, float, Fraction, Decimal)):
            return self.field(other)
        return NotImplemented

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return NFElem(self.field, [a + b for a, b in zip(self.coeffs, o.coeffs)])

    __radd__ = __add__

    def __neg__(self):
        return NFElem(self.field, [-a for a in self.coeffs])

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return self + (-o)

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        d = self.field.degree
        prod = [Fraction(0)] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a == 0:
                continue
            for j, b in enumerate(o.coeffs):
                if b:
                    prod[i + j] += a * b
        _, rem = _poly_divmod(prod, self.field.minpoly)
        rem = rem + [Fraction(0)] * (d - len(rem))
        return NFElem(self.field, rem[:d])

    __rmul__ = __mul__

    def inverse(self):
        # extended euclid: find u with u*self = 1 mod minpoly
        a = self.field.minpoly
        b = _poly_trim(list(self.coeffs))
        if not b:
            raise ZeroDivisionError("inverse of zero field element")
        r0, r1 = list(a), list(b)
        s0, s1 = [], [Fraction(1)]
        while True:
            q, r = _poly_divmod(r0, r1)
            if not r:
                break
            # s = s0 - q*s1
            s = list(s0) + [Fraction(0)] * max(0, len(q) + len(s1) - 1 - len(s0))
            for i, qi in enumerate(q):
                if qi:
                    for j, sj in enumerate(s1):
                        if sj:
                            s[i + j] -= qi * sj
            r0, r1 = r1, r
            s0, s1 = s1, _poly_trim(s)
        if len(r1) != 1:
            raise ZeroDivisionError("element is a zero divisor (minpoly not irreducible?)")
        inv_c = 1 / r1[0]
        d = self.field.degree
        out = [c * inv_c for c in s1] + [Fraction(0)] * d
        return NFElem(self.field, out[:d])

    def __truediv__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return self * o.inverse()

    def __rtruediv__(self, other):
        return self.inverse() * other

    def __pow__(self, n: int):
        out = self.field.one()
        base = self
        if n < 0:
            base = self.inverse()
            n = -n
        while n:
            if n & 1:
                out = out * base
            n >>= 1
            if n:
                base = base * base
        return out

    def __eq__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return self.coeffs == o.coeffs

    def __hash__(self):
        return hash((self.field, tuple(self.coeffs)))

    def is_zero(self):
        return all(c == 0 for c in self.coeffs)

    @property
    def numerator(self):  # for integerize_rows compatibility on QQ-like use
        raise AttributeError

    @property
    def denominator(self):
        raise AttributeError

    def embed(self, g=None, digits: int = HOST_DIGITS) -> Decimal:
        """Evaluate at an approximate real root g of the minimal polynomial."""
        g = self.field.approx_root if g is None else g
        gd = _as_decimal(g, digits)
        tot = Decimal(0)
        p = Decimal(1)
        for c in self.coeffs:
            if c:
                tot += _as_decimal(c, digits) * p
            p *= gd
        return tot

    def __repr__(self):
        name = self.field.name
        parts = []
        for i, c in enumerate(self.coeffs):
            if c:
                parts.append(f"{c}" if i == 0 else
                             (f"{c}*{name}" if i == 1 else f"{c}*{name}^{i}"))
        return " + ".join(parts) if parts else "0"


class _QQMarker:
    """Sentinel standing for the rational field (degree 1)."""

    degree = 1

    def __call__(self, x):
        return to_fraction(x)

    def gen(self):
        return Fraction(1)

    def __repr__(self):
        return "QQ"


QQ = _QQMarker()


def generic_embedding(x, g=None, digits: int = HOST_DIGITS):
    """Map exact coefficients (rational or number field) to host scalars,
    mirroring interface.jl:1640-1710; polynomials map coefficientwise."""
    if isinstance(x, NFElem):
        return x.embed(g, digits)
    if hasattr(x, "map_coefficients"):  # MPoly
        return x.map_coefficients(lambda c: generic_embedding(c, g, digits))
    if hasattr(x, "map"):  # LowRankMatPol
        return x.map(lambda c: generic_embedding(c, g, digits))
    return x
