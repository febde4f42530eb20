"""LLL lattice basis reduction and integer relation finding.

Replaces Nemo's `lll` and `lindep`
(`ClusteredLowRankSolver.jl/src/rounding.jl:878-958,481-509`,
`src/find_field.jl:111-117`): textbook LLL with exact rational
Gram-Schmidt (delta = 3/4), and `lindep` via the standard integer-relation
lattice [I | round(2^bits * v)].
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

__all__ = ["lll_reduce", "lindep", "clindep"]


def lll_reduce(basis: List[List[int]], delta: Fraction = Fraction(3, 4)):
    """LLL-reduce the lattice spanned by the rows; returns a new row basis."""
    b = [[int(x) for x in row] for row in basis if any(row)]
    n = len(b)
    if n == 0:
        return [list(map(int, row)) for row in basis]

    def dot(u, v):
        return sum(x * y for x, y in zip(u, v))

    def gso():
        bstar = []
        mu = [[Fraction(0)] * n for _ in range(n)]
        norms = []
        for i in range(n):
            v = [Fraction(x) for x in b[i]]
            for j in range(i):
                if norms[j] == 0:
                    mu[i][j] = Fraction(0)
                    continue
                mu[i][j] = Fraction(dot_f(b[i], bstar[j])) / norms[j]
                v = [x - mu[i][j] * y for x, y in zip(v, bstar[j])]
            bstar.append(v)
            norms.append(sum(x * x for x in v))
        return bstar, mu, norms

    def dot_f(u, v):
        return sum(Fraction(x) * y for x, y in zip(u, v))

    bstar, mu, norms = gso()
    k = 1
    while k < n:
        # size reduction
        for j in range(k - 1, -1, -1):
            q = round(mu[k][j])
            if q:
                b[k] = [x - q * y for x, y in zip(b[k], b[j])]
                for jj in range(j):
                    mu[k][jj] -= q * mu[j][jj]
                mu[k][j] -= q
        # Lovasz condition
        if norms[k] >= (delta - mu[k][k - 1] ** 2) * norms[k - 1]:
            k += 1
        else:
            b[k], b[k - 1] = b[k - 1], b[k]
            bstar, mu, norms = gso()
            k = max(k - 1, 1)
    return b


def lindep(values: List[Fraction], bits: int) -> Optional[List[int]]:
    """Find a small integer relation sum_i a_i values_i ~ 0 using `bits` bits
    of the values. Returns the coefficient vector (like Nemo's lindep)."""
    n = len(values)
    scale = 1 << bits
    ints = [round(v * scale) for v in values]
    # lattice rows: [e_i | N * v_i]
    rows = [[1 if j == i else 0 for j in range(n)] + [ints[i]]
            for i in range(n)]
    red = lll_reduce(rows)
    # the shortest row gives the relation
    best = min(red, key=lambda r: sum(x * x for x in r))
    return best[:n]


def clindep(vectors: List[List[Fraction]], bits: int, errbound: float,
            step: int = 5) -> List[int]:
    """Find an integer relation a with |sum_i a_i vectors[i]| < errbound
    entrywise, increasing precision gradually (rounding.jl:481-509).
    `vectors` is a list of columns over which a single relation is sought;
    each entry may be a vector (simultaneous relation)."""
    ncols = len(vectors)
    nrows = len(vectors[0])
    for p in range(1, bits + 1, step):
        scale = 1 << p
        rows = [[1 if j == i else 0 for j in range(ncols)]
                + [round(vectors[i][k] * scale) for k in range(nrows)]
                for i in range(ncols)]
        red = lll_reduce(rows)
        a = min(red, key=lambda r: sum(x * x for x in r))[:ncols]
        if all(x == 0 for x in a):
            continue
        err = max(abs(sum(Fraction(a[i]) * vectors[i][k] for i in range(ncols)))
                  for k in range(nrows))
        if err < errbound:
            return a
    raise ValueError("clindep failed to find a relation")
