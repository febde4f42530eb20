"""Exact rational linear algebra (host).

Replaces the reference's Nemo/FLINT QQ-matrix routines used by the rounding
pipeline (`ClusteredLowRankSolver.jl/src/rounding.jl`): RREF, nullspace from
RREF (rounding.jl:1106-1160), row integerization (rounding.jl:102-113),
matrix products/inverse over Fraction.

Matrices are list-of-lists of Fraction (or number-field elements, which
implement the same operators).
"""

from __future__ import annotations

from fractions import Fraction
from math import gcd, lcm
from typing import List, Tuple

__all__ = ["rref", "nullspace_from_rref", "mat_mul", "mat_vec", "mat_inv",
           "integerize_rows", "identity", "transpose", "is_rref",
           "zeros_matrix"]

Mat = List[List]


def zeros_matrix(m, n, zero=Fraction(0)):
    return [[zero for _ in range(n)] for _ in range(m)]


def identity(n, one=Fraction(1), zero=Fraction(0)):
    return [[one if i == j else zero for j in range(n)] for i in range(n)]


def transpose(a: Mat) -> Mat:
    return [list(row) for row in zip(*a)] if a else []


def mat_mul(a: Mat, b: Mat) -> Mat:
    n, k = len(a), len(b)
    m = len(b[0]) if b else 0
    out = [[0] * m for _ in range(n)]
    bt = transpose(b)
    for i in range(n):
        ai = a[i]
        for j in range(m):
            bj = bt[j]
            s = 0
            for t in range(k):
                if ai[t] and bj[t]:
                    s += ai[t] * bj[t]
            out[i][j] = s if s else Fraction(0)
    return out


def mat_vec(a: Mat, v: List) -> List:
    return [sum((x * y for x, y in zip(row, v) if x and y), Fraction(0))
            for row in a]


def rref(a: Mat) -> Tuple[int, Mat]:
    """Reduced row echelon form over an exact field; returns (rank, R)."""
    a = [list(r) for r in a]
    m = len(a)
    n = len(a[0]) if m else 0
    rank = 0
    for col in range(n):
        piv = next((i for i in range(rank, m) if a[i][col] != 0), None)
        if piv is None:
            continue
        a[rank], a[piv] = a[piv], a[rank]
        inv = 1 / a[rank][col]
        a[rank] = [x * inv for x in a[rank]]
        for i in range(m):
            if i != rank and a[i][col] != 0:
                f = a[i][col]
                a[i] = [x - f * y for x, y in zip(a[i], a[rank])]
        rank += 1
        if rank == m:
            break
    return rank, a


def is_rref(a: Mat) -> bool:
    lastpiv = -1
    for row in a:
        pc = next((j for j, x in enumerate(row) if x != 0), None)
        if pc is None:
            continue
        if pc <= lastpiv or row[pc] != 1:
            return False
        lastpiv = pc
    return True


def nullspace_from_rref(a: Mat) -> Tuple[int, Mat]:
    """Nullspace basis (as columns) of a matrix, using RREF structure if
    already reduced (rounding.jl:1106-1160). Returns (nullity, X) with X an
    n x nullity matrix."""
    m = len(a)
    n = len(a[0]) if m else 0
    if is_rref(a):
        R = a
        rank = sum(1 for row in a if any(x != 0 for x in row))
    else:
        rank, R = rref(a)
    nullity = n - rank
    X = zeros_matrix(n, nullity)
    if rank == 0:
        for i in range(nullity):
            X[i][i] = Fraction(1)
        return nullity, X
    # pivot bookkeeping
    pivots = []
    free = []
    j = 0
    for i in range(rank):
        while j < n and R[i][j] == 0:
            free.append(j)
            j += 1
        pivots.append(j)
        j += 1
    while j < n:
        free.append(j)
        j += 1
    for i, fc in enumerate(free):
        for r, pc in enumerate(pivots):
            X[pc][i] = -R[r][fc]
        X[fc][i] = Fraction(1)
    return nullity, X


def mat_inv(a: Mat) -> Mat:
    n = len(a)
    aug = [list(r) + [Fraction(1) if i == j else Fraction(0) for j in range(n)]
           for i, r in enumerate(a)]
    rank, R = rref(aug)
    if rank < n or any(R[i][i] != 1 for i in range(n)):
        raise ValueError("matrix not invertible")
    return [row[n:] for row in R]


def integerize_rows(a: Mat, b: List = None, include_b: bool = False):
    """Scale each row by the lcm of denominators (rounding.jl:102-113)."""
    out = []
    outb = []
    for i, row in enumerate(a):
        dens = [x.denominator for x in row]
        if include_b and b is not None:
            dens.append(b[i].denominator)
        l = 1
        for d in dens:
            l = lcm(l, d)
        out.append([x * l for x in row])
        if b is not None:
            outb.append(b[i] * l)
    return (out, outb) if b is not None else out
