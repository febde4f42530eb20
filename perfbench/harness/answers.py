"""A solve's answer in plain form for the reference: exact rationals.

The port returns ``DualSolution(x, matrixvars)`` and
``PrimalSolution(matrixvars, freevars)`` whose entries are double words
(``hi + lo``, each a float64). Each becomes the exact ``Fraction`` of its
two parts, so the reference reads every bit the port returned and nothing
of the port's classes.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np


def exact(v) -> Fraction:
    hi = getattr(v, "hi", None)
    if hi is None:
        return Fraction(v)
    return Fraction(float(hi)) + Fraction(float(v.lo))


def _key(k):
    if isinstance(k, (str, int)):
        return k
    if isinstance(k, tuple):
        return tuple(_key(a) for a in k)
    raise TypeError(f"block key {k!r} of an unknown kind")


def _matrix(a) -> list:
    a = np.asarray(a, dtype=object)
    return [[exact(v) for v in row] for row in a]


def plain(dualsol, primalsol) -> dict:
    """{"x": [[Fraction]] per constraint and sample, "X": {block: rows},
    "Y": {block: rows}, "y": {free variable: Fraction}}."""
    return {
        "x": [[exact(v) for v in row] for row in dualsol.x],
        "X": {_key(k): _matrix(m) for k, m in dualsol.matrixvars.items()},
        "Y": {_key(k): _matrix(m) for k, m in primalsol.matrixvars.items()},
        "y": {_key(k): exact(v) for k, v in primalsol.freevars.items()},
    }
