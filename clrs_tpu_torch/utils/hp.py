"""Host-side high-precision helpers.

The compile path (sample evaluation, orthogonal bases, approximate Fekete)
needs more than float64; the reference uses BigFloat/Arb there
(`ClusteredLowRankSolver.jl/src/interface.jl:320-435`).  We use:

- exact `fractions.Fraction` whenever inputs are exact, and
- `decimal.Decimal` (default 50 digits ~ 166 bits) for irrational
  constructors (pi, cos, sqrt),

then convert to double-word float64 pairs at the device boundary.
"""

from __future__ import annotations

import math
from decimal import Decimal, getcontext, localcontext
from fractions import Fraction

import numpy as np

from ..dd.core import dd_add, dd_div, dd_mul, dd_sqrt, dd_sub, two_sum

HOST_DIGITS = 50

_PI_STR = ("3.14159265358979323846264338327950288419716939937510"
           "58209749445923078164062862089986280348253421170679821480865132823")


def pi(digits: int = HOST_DIGITS) -> Decimal:
    with localcontext() as ctx:
        ctx.prec = digits + 5
        return +Decimal(_PI_STR[: digits + 10])


def cospi(q, digits: int = HOST_DIGITS) -> Decimal:
    """cos(pi*q) for a rational/decimal q, via argument reduction + Taylor."""
    q = _as_decimal(q, digits)
    with localcontext() as ctx:
        ctx.prec = digits + 15
        # reduce to t in [0, 2)
        t = q % 2
        sign = Decimal(1)
        if t > 1:
            t = 2 - t
        if t > Decimal("0.5"):
            t = 1 - t
            sign = -sign
        # now t in [0, 1/2]; cos(pi t)
        x = t * pi(digits + 10)
        term = Decimal(1)
        s = Decimal(1)
        x2 = x * x
        k = 0
        while True:
            k += 1
            term = -term * x2 / (2 * k * (2 * k - 1))
            s += term
            if abs(term) < Decimal(10) ** (-(digits + 10)):
                break
        return +(sign * s)


def sqrt_dec(q, digits: int = HOST_DIGITS) -> Decimal:
    q = _as_decimal(q, digits)
    with localcontext() as ctx:
        ctx.prec = digits + 10
        return q.sqrt()


def log_dec(q, digits: int = HOST_DIGITS) -> Decimal:
    q = _as_decimal(q, digits)
    with localcontext() as ctx:
        ctx.prec = digits + 10
        return q.ln()


def _as_decimal(x, digits: int = HOST_DIGITS) -> Decimal:
    if isinstance(x, Decimal):
        return x
    if isinstance(x, Fraction):
        with localcontext() as ctx:
            ctx.prec = digits + 10
            return Decimal(x.numerator) / Decimal(x.denominator)
    if isinstance(x, int):
        return Decimal(x)
    if isinstance(x, float):
        return Decimal(x)
    if isinstance(x, DDScalar):
        return Decimal(x.hi) + Decimal(x.lo)
    raise TypeError(f"cannot convert {type(x)} to Decimal")


def to_dd(x):
    """Convert an exact/high-precision host scalar to a (hi, lo) float64 pair."""
    if isinstance(x, DDScalar):
        return (x.hi, x.lo)
    if isinstance(x, float):
        return (x, 0.0)
    if isinstance(x, int):
        hi = float(x)
        lo = float(x - int(hi)) if abs(x) > 2 ** 53 else 0.0
        return (hi, lo)
    if isinstance(x, Fraction):
        hi = float(x)
        if math.isinf(hi):
            raise OverflowError("Fraction too large for float64")
        lo = float(x - Fraction(hi))
        return (hi, lo)
    if isinstance(x, Decimal):
        hi = float(x)
        lo = float(x - Decimal(hi))
        return (hi, lo)
    raise TypeError(f"cannot convert {type(x)} to double-word: {x!r}")


def to_words(x, nw: int):
    """Split an exact/high-precision host scalar into ``nw`` float64 words.

    The words are non-overlapping and decreasing; their exact sum is the
    closest nw*53-bit approximation of x. ``nw=2`` agrees with :func:`to_dd`.
    This is the host/device boundary for the configurable-precision backend
    (the reference's `prec` kwarg, solver.jl:100-128, maps onto the word
    count here: 2 words ~ 106 bits, 4 words ~ 212 bits).
    """
    if isinstance(x, DDScalar):
        ws = [x.hi, x.lo] + [0.0] * max(0, nw - 2)
        return tuple(ws[:nw])
    if isinstance(x, float):
        return (x,) + (0.0,) * (nw - 1)
    if isinstance(x, Decimal):
        x = to_fraction(x)
    if isinstance(x, int):
        x = Fraction(x)
    if isinstance(x, Fraction):
        out = []
        r = x
        for _ in range(nw):
            h = float(r)
            if math.isinf(h):
                raise OverflowError("value too large for float64")
            out.append(h)
            r = r - Fraction(h)
        return tuple(out)
    raise TypeError(f"cannot convert {type(x)} to {nw} words: {x!r}")


def words_to_fraction(ws) -> Fraction:
    out = Fraction(0)
    for w in ws:
        out += Fraction(float(w))
    return out


def to_fraction(x) -> Fraction:
    if isinstance(x, Fraction):
        return x
    if isinstance(x, int):
        return Fraction(x)
    if isinstance(x, float):
        return Fraction(x)
    if isinstance(x, Decimal):
        return Fraction(x)
    if isinstance(x, DDScalar):
        return Fraction(x.hi) + Fraction(x.lo)
    raise TypeError(f"cannot convert {type(x)} to Fraction")


class DDScalar:
    """Host double-word scalar (hi + lo, both float64).

    Used to carry solver output values (which have ~106 significant bits) into
    the rounding pipeline and user-facing solution objects without truncating
    to a single float64.
    """

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo=0.0):
        if isinstance(hi, DDScalar):
            self.hi, self.lo = hi.hi, hi.lo
            return
        if isinstance(hi, (Fraction, Decimal)) or (isinstance(hi, int) and abs(hi) > 2 ** 53):
            h, l = to_dd(hi)
            s, e = two_sum(np.float64(h), np.float64(l) + np.float64(lo))
            self.hi, self.lo = float(s), float(e)
            return
        s, e = two_sum(np.float64(hi), np.float64(lo))
        self.hi, self.lo = float(s), float(e)

    def _coerce(self, other):
        if isinstance(other, DDScalar):
            return other
        if isinstance(other, (int, float, Fraction, Decimal)):
            return DDScalar(other)
        return NotImplemented

    def _pair(self):
        return (np.float64(self.hi), np.float64(self.lo))

    def __add__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return DDScalar(*map(float, dd_add(self._pair(), o._pair())))

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return DDScalar(*map(float, dd_sub(self._pair(), o._pair())))

    def __rsub__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return DDScalar(*map(float, dd_sub(o._pair(), self._pair())))

    def __mul__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return DDScalar(*map(float, dd_mul(self._pair(), o._pair())))

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return DDScalar(*map(float, dd_div(self._pair(), o._pair())))

    def __rtruediv__(self, other):
        o = self._coerce(other)
        if o is NotImplemented:
            return NotImplemented
        return DDScalar(*map(float, dd_div(o._pair(), self._pair())))

    def __neg__(self):
        return DDScalar(-self.hi, -self.lo)

    def __abs__(self):
        return DDScalar(-self.hi, -self.lo) if self.hi < 0 else DDScalar(self.hi, self.lo)

    def sqrt(self):
        return DDScalar(*map(float, dd_sqrt(self._pair(), xp=np)))

    def __float__(self):
        return self.hi + self.lo

    def __eq__(self, other):
        o = self._coerce(other)
        return o is not NotImplemented and self.hi == o.hi and self.lo == o.lo

    def __lt__(self, other):
        o = self._coerce(other)
        return (self.hi, self.lo) < (o.hi, o.lo)

    def __le__(self, other):
        return self == other or self < other

    def __gt__(self, other):
        return not self <= other

    def __ge__(self, other):
        return not self < other

    def __hash__(self):
        return hash((self.hi, self.lo))

    def __repr__(self):
        return f"DDScalar({self.hi!r}, {self.lo!r})"

    def as_fraction(self):
        return Fraction(self.hi) + Fraction(self.lo)

    def as_decimal(self):
        return Decimal(self.hi) + Decimal(self.lo)


getcontext().prec = HOST_DIGITS


_STD_TYPES = (int, float, Fraction, Decimal)


def promote_pair(a, b):
    """Promote two host scalars to a common arithmetic domain.

    Ladder: Decimal > DDScalar > Fraction > int. floats are promoted exactly
    into Fraction (binary floats are exact rationals). Non-standard operands
    (polynomials, sampled polynomials, number-field elements) are passed
    through: their own operator overloads handle mixing.
    """
    if not isinstance(a, _STD_TYPES + (DDScalar,)) \
            or not isinstance(b, _STD_TYPES + (DDScalar,)):
        return a, b
    types = (type(a), type(b))
    if Decimal in types:
        return _as_decimal(a), _as_decimal(b)
    if DDScalar in types:
        return DDScalar(a), DDScalar(b)
    if Fraction in types or float in types:
        return to_fraction(a), to_fraction(b)
    return a, b


def hp_mul(a, b):
    if isinstance(a, int):
        if a == 0:
            return 0
        if a == 1:
            return b
    if isinstance(b, int):
        if b == 0:
            return 0
        if b == 1:
            return a
    x, y = promote_pair(a, b)
    return x * y


def hp_add(a, b):
    if isinstance(a, int) and a == 0:
        return b
    if isinstance(b, int) and b == 0:
        return a
    x, y = promote_pair(a, b)
    return x + y


def gamma_half(q, digits: int = HOST_DIGITS) -> Decimal:
    """Gamma(q) for q a positive multiple of 1/2 (Decimal)."""
    q = to_fraction(q)
    if q <= 0 or (2 * q).denominator != 1:
        raise ValueError("gamma_half needs a positive half-integer")
    with localcontext() as ctx:
        ctx.prec = digits + 10
        if q.denominator == 1:
            out = Decimal(1)
            k = int(q)
            for i in range(2, k):
                out *= i
            return out
        out = pi(digits).sqrt()
        x = Fraction(1, 2)
        while x < q:
            out *= _as_decimal(x, digits)
            x += 1
        return +out
