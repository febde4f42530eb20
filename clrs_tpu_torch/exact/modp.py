"""Modular (F_p) linear algebra for fast pivot detection.

Replaces the reference's Nemo RREF-mod-p pivot search
(`ClusteredLowRankSolver.jl/src/rounding.jl:288-333`): reduce an integer
matrix mod several primes and read off the pivot columns.  Vectorized with
numpy int64 (primes ~1e4, products stay within int64).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from .primes import nextprime

__all__ = ["find_pivots_modular", "rref_mod_p"]


def _rref_native(a_mod: np.ndarray, p: int):
    """C++ RREF kernel via ctypes; None if the native lib is unavailable."""
    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    a = np.ascontiguousarray(np.asarray(a_mod, dtype=np.int64) % p,
                             dtype=np.uint64)
    m, n = a.shape
    if m == 0 or n == 0:
        return [], a.astype(np.int64)
    pivots = np.zeros(min(m, n), dtype=np.int64)
    rank = lib.rref_mod_p_u64(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), m, n, p,
        pivots.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return [int(c) for c in pivots[:rank]], a.astype(np.int64)


def rref_mod_p(a_mod: np.ndarray, p: int):
    """RREF of an int64 matrix already reduced mod p; returns (pivot columns,
    reduced matrix). Uses the native C++ kernel when available (the FLINT
    nmod_mat role, rounding.jl:288-333), falling back to numpy."""
    if 2 <= p < 2 ** 62:
        native = _rref_native(a_mod, p)
        if native is not None:
            return native
    a = a_mod % p
    m, n = a.shape
    pivots = []
    r = 0
    for col in range(n):
        piv = None
        for i in range(r, m):
            if a[i, col] % p:
                piv = i
                break
        if piv is None:
            continue
        a[[r, piv]] = a[[piv, r]]
        inv = pow(int(a[r, col]), -1, p)
        a[r] = (a[r] * inv) % p
        for i in range(m):
            if i != r and a[i, col]:
                a[i] = (a[i] - a[i, col] * a[r]) % p
        pivots.append(col)
        r += 1
        if r == m:
            break
    return pivots, a


def find_pivots_modular(a_int: List[List[int]], maxprimes: int = 3) -> List[int]:
    """Pivot columns of an integer matrix, via RREF mod up to `maxprimes`
    primes (rounding.jl:288-311). Returns the best pivot set found."""
    if not a_int or not a_int[0]:
        return []
    m = len(a_int)
    amax = max((abs(int(x)) for row in a_int for x in row), default=1)
    p = min(max(amax, 2), 10 ** 4)
    history = []
    for trial in range(maxprimes):
        p = int(nextprime(p))
        a = np.array([[int(x) % p for x in row] for row in a_int], dtype=np.int64)
        pivots, _ = rref_mod_p(a, p)
        if len(pivots) == m:
            return pivots
        history.append(pivots)
    best = max(len(h) for h in history)
    return next(h for h in history if len(h) == best)
