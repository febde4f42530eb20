"""The port's batched factorizations (plain versions of its CUDA kernels and
the blocked front-ends) against the JAX package's Pallas kernels, run in
the Pallas interpreter on the CPU, as tests/test_expops.py runs them.

Tolerances: given the same factor, both triangular solves are
bit-identical (the same IEEE op sequence). The Cholesky is held to
2^-(24 nw - 8) relative to max|L|: its pivot Newton seed is IEEE
1/sqrt(x) in the port and lax.rsqrt in the reference. Blocked against
unblocked inside the port is held to 2^-(24 nw - 16) relative: each
trailing GEMM rounds once more to nw words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clrs_tpu.dd import pallas_linalg as P
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.dd import linalg as tl
from torch_helpers import spd_words, split_words, xla_subnormals  # noqa: F401


def _val(ws):
    """Exact-enough value of word arrays (f64 sum; for tolerances only)."""
    return sum(np.asarray(c, np.float64) for c in ws)


def _t(ws):
    return tuple(torch.from_numpy(np.array(w)) for w in ws)


def test_cholesky_matches_pallas_kernel(xla_subnormals):
    nw = 3
    A = spd_words(2, 6, nw, seed=0)
    Lj, okj = P.pl_cholesky_b(tuple(map(jnp.asarray, A)))
    Lt, okt = K.chol_plain(_t(A))
    assert np.array_equal(np.asarray(okj), okt.numpy())
    ref = _val(Lj)
    err = np.max(np.abs(ref - _val(Lt)))
    assert err <= 2.0 ** -(24 * nw - 8) * np.max(np.abs(ref)), err
    # leading words agree exactly: the seeds differ far below them
    assert np.array_equal(np.asarray(Lj[0]), Lt[0].numpy())


@pytest.mark.parametrize("trans", [False, True])
def test_solves_bit_identical_to_pallas_kernels(trans, xla_subnormals):
    nw = 3
    A = spd_words(2, 6, nw, seed=1)
    Bm = split_words(np.random.default_rng(3).standard_normal((2, 6, 4)), nw)
    Lj, _ = P.pl_cholesky_b(tuple(map(jnp.asarray, A)))
    fj = P.pl_solve_tril_t_b if trans else P.pl_solve_tril_b
    Xj = fj(Lj, tuple(map(jnp.asarray, Bm)))
    Xt = K.tri_solve_plain(_t([np.asarray(c) for c in Lj]), _t(Bm), trans)
    for a, b in zip(Xj, Xt):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_cholesky_flags_indefinite_member():
    A = spd_words(3, 4, 5, seed=2)
    A[0][1, 3, 3] = -50.0
    for w in A[1:]:
        w[1, 3, 3] = 0.0
    _, ok = tl.b_cholesky(_t(A))
    assert ok.tolist() == [True, False, True]


def test_blocked_matches_unblocked_at_n100():
    nw, n = 3, 100
    A = _t(spd_words(1, n, nw, seed=5))
    Lb, okb = tl.b_cholesky(A)                    # blocked: n >= 96
    Lu, oku = K.chol_plain(A)
    assert bool(okb[0]) and bool(oku[0])
    tol = 2.0 ** -(24 * nw - 16)
    ref = _val([c.numpy() for c in Lu])
    assert np.max(np.abs(_val([c.numpy() for c in Lb]) - ref)) \
        <= tol * np.max(np.abs(ref))
    B = _t(split_words(np.random.default_rng(6).standard_normal((1, n, 3)), nw))
    for blocked, plain in ((tl.b_solve_tril, False), (tl.b_solve_tril_t, True)):
        xb = _val([c.numpy() for c in blocked(Lu, B)])
        xu = _val([c.numpy() for c in K.tri_solve_plain(Lu, B, plain)])
        assert np.max(np.abs(xb - xu)) <= tol * np.max(np.abs(xu))


def test_tree_schedule_matches_recursive_halving():
    """The batched tree of tree_sum_rows pairs exactly the nodes of the
    recursive halving of pallas_linalg._exp_sum_axis0."""
    def rec(lo, hi):
        if hi - lo == 1:
            return f"{lo}"
        mid = lo + (hi - lo) // 2
        return f"({rec(lo, mid)}+{rec(mid, hi)})"

    for n in (2, 3, 5, 6, 7, 22, 64, 95):
        sched, root, nodes = K._tree_schedule(n)
        expr = {i: f"{i}" for i in range(n)}
        for a, b, o in sched:
            for x, y, z in zip(a, b, o):
                expr[z] = f"({expr[x]}+{expr[y]})"
        assert expr[root] == rec(0, n), n
        assert nodes == 2 * n - 1
