"""Dixon p-adic linear system solving over the rationals.

Replaces Nemo's `_solve_dixon`
(`ClusteredLowRankSolver.jl/src/rounding.jl:274,351,360`): solve A x = b for
square nonsingular integer A by p-adic lifting + rational reconstruction.
Much faster than fraction-based Gaussian elimination for medium systems
because all arithmetic is on bounded integers until the final
reconstruction.
"""

from __future__ import annotations

from fractions import Fraction
from math import gcd, isqrt
from typing import List, Optional

import numpy as np
from .primes import nextprime

from .modp import rref_mod_p

__all__ = ["solve_dixon", "rational_reconstruction"]


def rational_reconstruction(a: int, m: int) -> Optional[Fraction]:
    """Find p/q with a ≡ p q^{-1} (mod m), |p|,|q| <= sqrt(m/2)."""
    bound = isqrt(m // 2)
    r0, r1 = m, a % m
    s0, s1 = 0, 1
    while r1 > bound:
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        s0, s1 = s1, s0 - q * s1
    if abs(s1) > bound or gcd(r1, abs(s1)) != 1 or s1 == 0:
        return None
    return Fraction(r1, s1) if s1 > 0 else Fraction(-r1, -s1)


def _inv_mod_p(a_int: List[List[int]], p: int) -> Optional[List[List[int]]]:
    n = len(a_int)
    aug = np.zeros((n, 2 * n), dtype=np.int64)
    for i in range(n):
        for j in range(n):
            aug[i, j] = a_int[i][j] % p
        aug[i, n + i] = 1
    pivots, red = rref_mod_p(aug, p)
    if pivots[:n] != list(range(n)):
        return None
    return [[int(red[i, n + j]) for j in range(n)] for i in range(n)]


def solve_dixon(a: List[List], b: List, max_denominator_bits: int = 1 << 22):
    """Solve A x = b over Q for square nonsingular A (entries Fraction/int).

    Returns the exact solution vector of Fractions.
    """
    n = len(a)
    assert all(len(r) == n for r in a) and len(b) == n
    # clear denominators to integers
    from math import lcm

    den = 1
    for row in a:
        for x in row:
            den = lcm(den, Fraction(x).denominator)
    for x in b:
        den = lcm(den, Fraction(x).denominator)
    A = [[int(Fraction(x) * den) for x in row] for row in a]
    B = [int(Fraction(x) * den) for x in b]

    p = 62003
    Ainv = None
    for _ in range(25):
        Ainv = _inv_mod_p(A, p)
        if Ainv is not None:
            break
        p = int(nextprime(p))
    if Ainv is None:
        raise ValueError("matrix is singular")

    # Hadamard-ish bound on numerators/denominators -> number of lifting steps
    import math

    norm = max(max(abs(x) for x in row) for row in A) or 1
    bnorm = max((abs(x) for x in B), default=1) or 1
    hadamard_bits = n * (math.log2(norm) + 0.5 * math.log2(n)) + math.log2(bnorm) + 4
    steps = int(hadamard_bits / math.log2(p)) * 2 + 4

    Ainv_np = [[Ainv[i][j] for j in range(n)] for i in range(n)]
    r = list(B)
    digits = []
    for _ in range(steps):
        # x_i = Ainv r mod p
        xi = [sum(Ainv_np[i][j] * (r[j] % p) for j in range(n)) % p
              for i in range(n)]
        digits.append(xi)
        # r = (r - A xi) / p   (exact integer division)
        new_r = []
        for i in range(n):
            val = r[i] - sum(A[i][j] * xi[j] for j in range(n))
            assert val % p == 0
            new_r.append(val // p)
        r = new_r
        if all(v == 0 for v in r):
            break

    # x = sum digits[k] p^k mod p^steps, then rational reconstruction
    m = p ** len(digits)
    out = []
    for i in range(n):
        acc = 0
        pk = 1
        for k in range(len(digits)):
            acc += digits[k][i] * pk
            pk *= p
        fr = rational_reconstruction(acc % m, m)
        if fr is None:
            raise ValueError("rational reconstruction failed; need more lifting")
        out.append(fr)
    # verify
    for i in range(n):
        s = sum(Fraction(A[i][j]) * out[j] for j in range(n))
        if s != B[i]:
            raise ValueError("dixon solution verification failed")
    return out
