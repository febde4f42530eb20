"""The port's nextprime (clrs_tpu_torch/exact/primes.py) against
sympy.nextprime, which the JAX package's prime searches import
(clrs_tpu/exact/modp.py:14, dixon.py:18)."""

import random

import pytest
import sympy

from clrs_tpu_torch.exact.primes import isprime, nextprime


@pytest.mark.parametrize("lo", range(0, 200000, 50000))
def test_nextprime_equals_sympy_below_200000(lo):
    for n in range(lo, lo + 50000):
        assert nextprime(n) == sympy.nextprime(n), n


@pytest.mark.parametrize("bits", [20, 31, 32, 48, 62])
def test_nextprime_equals_sympy_at_seeded_large_n(bits):
    rng = random.Random(bits)
    for _ in range(300):
        n = rng.randrange(2 ** (bits - 1), 2 ** bits)
        assert nextprime(n) == sympy.nextprime(n), n
        assert isprime(n) == sympy.isprime(n), n


def test_nextprime_below_two_and_past_the_bound():
    for n in (-7, -1, 0, 1):
        assert nextprime(n) == sympy.nextprime(n) == 2
    # strong pseudoprimes to many bases stay composite
    for n in (3215031751, 3825123056546413051,
              318665857834031151167461):
        assert not isprime(n) and not sympy.isprime(n)
    with pytest.raises(ValueError):
        isprime(2 ** 82)
