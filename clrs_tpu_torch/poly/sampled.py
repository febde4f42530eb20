"""Sampled polynomial rings.

Equivalent of the reference's SampledMPolyRing/SampledMPolyRingElem
(`ClusteredLowRankSolver.jl/src/interface.jl:11-253`): a polynomial is
represented only by its evaluations on a fixed sorted sample set; ring
arithmetic is pointwise and evaluation is a binary search.
"""

from __future__ import annotations

import bisect
from typing import List

from ..utils.hp import hp_add, hp_mul

__all__ = ["SampledPolyRing", "SampledPoly", "sampled_polynomial_ring"]


def _key(sample):
    if isinstance(sample, (list, tuple)):
        return tuple(sample)
    return (sample,)


class SampledPolyRing:
    """Ring of functions defined only on a fixed sorted sample set."""

    def __init__(self, samples: List):
        keys = [_key(s) for s in samples]
        if any(keys[i] >= keys[i + 1] for i in range(len(keys) - 1)):
            raise ValueError("samples must be sorted and distinct")
        self.samples = list(samples)
        self._keys = keys

    def __eq__(self, other):
        return isinstance(other, SampledPolyRing) and self._keys == other._keys

    def __hash__(self):
        return hash(tuple(map(str, self._keys)))

    def __call__(self, x):
        if isinstance(x, SampledPoly):
            if x.ring == self:
                return x
            return SampledPoly(self, [x(s) for s in self.samples])
        if hasattr(x, "ring") and hasattr(x, "terms"):  # MPoly
            return SampledPoly(self, [x(*_key(s)) for s in self.samples])
        return SampledPoly(self, [x for _ in self.samples])

    def zero(self):
        return self(0)

    def one(self):
        return self(1)

    def index_of(self, sample) -> int:
        k = _key(sample)
        i = bisect.bisect_left(self._keys, k)
        if i >= len(self._keys) or self._keys[i] != k:
            raise KeyError(f"sample {sample!r} not in the sample set")
        return i

    def __repr__(self):
        n = len(self._keys[0]) if self._keys else 0
        return f"SampledPolyRing({len(self.samples)} samples, {n} vars)"


def sampled_polynomial_ring(samples):
    return SampledPolyRing(samples)


class SampledPoly:
    """An element of a :class:`SampledPolyRing`: a vector of evaluations."""

    __slots__ = ("ring", "evaluations")

    def __init__(self, ring: SampledPolyRing, evaluations: List):
        if len(evaluations) != len(ring.samples):
            raise ValueError("wrong number of evaluations")
        self.ring = ring
        self.evaluations = list(evaluations)

    def _coerce(self, other):
        if isinstance(other, SampledPoly):
            if other.ring != self.ring:
                raise ValueError("incompatible sampled rings")
            return other
        return self.ring(other)

    def __add__(self, other):
        o = self._coerce(other)
        return SampledPoly(self.ring, [hp_add(a, b) for a, b in
                                       zip(self.evaluations, o.evaluations)])

    __radd__ = __add__

    def __neg__(self):
        return SampledPoly(self.ring, [hp_mul(-1, a) for a in self.evaluations])

    def __sub__(self, other):
        return self + (-self._coerce(other))

    def __rsub__(self, other):
        return (-self) + other

    def __mul__(self, other):
        o = self._coerce(other)
        return SampledPoly(self.ring, [hp_mul(a, b) for a, b in
                                       zip(self.evaluations, o.evaluations)])

    __rmul__ = __mul__

    def __pow__(self, n: int):
        if n < 0:
            raise ValueError("negative power of a SampledPoly")
        out = self.ring.one()
        for _ in range(n):
            out = out * self
        return out

    def __eq__(self, other):
        try:
            o = self._coerce(other)
        except Exception:
            return NotImplemented
        return all(a == b for a, b in zip(self.evaluations, o.evaluations))

    def __hash__(self):
        return hash((self.ring, tuple(map(str, self.evaluations))))

    def __call__(self, *v):
        if len(v) == 1 and isinstance(v[0], (list, tuple)):
            v = tuple(v[0])
        return self.evaluations[self.ring.index_of(v if len(v) > 1 else v[0])]

    def evaluate(self, v):
        return self.evaluations[self.ring.index_of(v)]

    def is_zero(self):
        return all(a == 0 for a in self.evaluations)

    def __repr__(self):
        return f"SampledPoly({len(self.evaluations)} evaluations)"
