"""Hermite normal form over the integers.

Replaces Nemo's hnf/hnf_with_transform used in the kernel-vector reduction
(`ClusteredLowRankSolver.jl/src/rounding.jl:1074-1104`).  Row-style HNF: for
an integer matrix A, returns H (row echelon, positive pivots, entries above
pivots reduced) and unimodular T with H = T A.

Python ints are arbitrary precision, so no overflow concerns.
"""

from __future__ import annotations

from math import gcd
from typing import List, Tuple

__all__ = ["hnf", "hnf_with_transform", "hnf_normalmultiplier_with_transform"]


def _xgcd(a: int, b: int) -> Tuple[int, int, int]:
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    return old_r, old_s, old_t


def hnf_with_transform(a: List[List[int]]) -> Tuple[List[List[int]], List[List[int]]]:
    """Row HNF with unimodular transform: H = T A."""
    m = len(a)
    n = len(a[0]) if m else 0
    H = [[int(x) for x in row] for row in a]
    T = [[1 if i == j else 0 for j in range(m)] for i in range(m)]
    r = 0
    for col in range(n):
        # find a row >= r with nonzero entry in this column; reduce the
        # column below r to a single nonzero via extended gcds
        nz = [i for i in range(r, m) if H[i][col]]
        if not nz:
            continue
        i0 = nz[0]
        for i in nz[1:]:
            g, s, t = _xgcd(H[i0][col], H[i][col])
            u, v = H[i][col] // g, H[i0][col] // g
            row0 = [s * x + t * y for x, y in zip(H[i0], H[i])]
            rowi = [-u * x + v * y for x, y in zip(H[i0], H[i])]
            H[i0], H[i] = row0, rowi
            t0 = [s * x + t * y for x, y in zip(T[i0], T[i])]
            ti = [-u * x + v * y for x, y in zip(T[i0], T[i])]
            T[i0], T[i] = t0, ti
        H[r], H[i0] = H[i0], H[r]
        T[r], T[i0] = T[i0], T[r]
        if H[r][col] < 0:
            H[r] = [-x for x in H[r]]
            T[r] = [-x for x in T[r]]
        # reduce entries above the pivot
        piv = H[r][col]
        for i in range(r):
            q = H[i][col] // piv
            if q:
                H[i] = [x - q * y for x, y in zip(H[i], H[r])]
                T[i] = [x - q * y for x, y in zip(T[i], T[r])]
        r += 1
        if r == m:
            break
    return H, T


def hnf(a: List[List[int]]) -> List[List[int]]:
    return hnf_with_transform(a)[0]


def hnf_normalmultiplier_with_transform(a: List[List[int]]):
    """HNF with the 'normal' multiplier (rounding.jl:1089-1104, after Hubert
    and Labahn): appending an identity puts the nullspace part of the
    transformation itself in HNF and reduces the rest against it."""
    m = len(a)
    n = len(a[0]) if m else 0
    if m < n:
        return hnf_with_transform(a)
    ext = [list(map(int, row)) + [1 if i == j else 0 for j in range(m)]
           for i, row in enumerate(a)]
    H = hnf(ext)
    return [row[:n] for row in H], [row[n:] for row in H]
