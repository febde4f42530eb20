"""The next prime, without sympy.

The rounding stack's prime searches (``exact/modp.py`` and
``exact/dixon.py``) call ``nextprime`` where the JAX package imports
``sympy.nextprime``; the machines the port runs on need not have sympy.
Miller-Rabin with the first thirteen prime bases is deterministic below
3,317,044,064,679,887,385,961,981 (Sorenson and Webster, 2016), far above
the primes the callers search (from at most 62003 up).
"""

from __future__ import annotations

from operator import index

__all__ = ["nextprime", "isprime"]

_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41)
_LIMIT = 3317044064679887385961981


def isprime(n: int) -> bool:
    """Whether ``n`` is prime; deterministic for ``n`` below ``_LIMIT``."""
    n = index(n)
    if n >= _LIMIT:
        raise ValueError(f"isprime({n}): beyond the deterministic bound")
    if n < 2:
        return False
    for p in _BASES:
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in _BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def nextprime(n: int) -> int:
    """The smallest prime greater than ``n`` (``sympy.nextprime(n)``)."""
    n = index(n)
    if n < 2:
        return 2
    c = n + 1 if n % 2 == 0 else n + 2
    while not isprime(c):
        c += 2
    return c
