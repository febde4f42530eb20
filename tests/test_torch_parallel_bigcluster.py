"""The port's row-panel functions (clrs_tpu_torch.parallel.bigcluster)
over 4 gloo rank processes against the JAX package's same functions
(clrs_tpu/parallel/bigcluster.py) under ``shard_map`` over 4 of
conftest's virtual CPU devices, with the Pallas routes off: P = 32,
nb 8 (8 rows a rank), f32 words, nw 5, subnormals flushed on both sides
as XLA:CPU does. The JAX regions run under ``jax.jit`` (about 95 s of
XLA compile here; called eagerly they run op by op for many minutes).

- dist_cholesky: the JAX package's factorization reaches f32 words
  through its XLA loop, whose pivot seed is lax.rsqrt; the port's is
  IEEE 1/sqrt (ROADMAP.md section C). It is held to that documented
  exception as tests/test_torch_linalg.py measures it: word 0 equal, the
  f64 value of the words within 2^-(24 nw - 8) of max|L|.
- dist_solve_tril and dist_solve_tril_t, given the JAX factor: the JAX
  package's XLA loops sum each row's products over the whole masked row,
  the port's solves (those of the kernels and of the Pallas solves) over
  the row's prefix by a tree, so the last words differ.
- All three: words 0-2 equal, and the exact values (sums of the words as
  Fractions) within 2^-100 of max|X|, about 64 units of the ~106 bits an
  f32 expansion of 5 words carries. Measured: 2^-103.6 (the factor),
  2^-101.3 and 2^-102.1 (the solves).
"""

from fractions import Fraction

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from clrs_tpu.dd import linalg as JL
from clrs_tpu.parallel import bigcluster as JB
from torch_helpers import run_ranks, spd_words, split_words

NW, PN, NB, M, WORLD = 5, 32, 8, 3, 4


def _jax_side(S, B):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("blk",))

    def chol(S_loc):
        return JB.dist_cholesky(S_loc, PN, "blk", NB)

    def solves(L_loc, B_):
        return (JB.dist_solve_tril(L_loc, B_, PN, "blk", NB),
                JB.dist_solve_tril_t(L_loc, B_, PN, "blk", NB))

    rows = P("blk", None)
    L, ok = jax.jit(JB.shard_map(chol, mesh, in_specs=(rows,),
                                 out_specs=(rows, P())))(S)
    X, Xt = jax.jit(JB.shard_map(solves, mesh, in_specs=(rows, P()),
                                 out_specs=(P(), P())))(L, B)
    return bool(ok), [[np.asarray(c) for c in ws] for ws in (L, X, Xt)]


def _val(ws):
    """The f64 sum of the words (for the documented exception only)."""
    return sum(np.asarray(c, np.float64) for c in ws)


def _exact(ws):
    """The exact values of nw-word arrays (sums of Fractions)."""
    return np.vectorize(lambda *v: sum(Fraction(float(x)) for x in v),
                        otypes=[object])(*ws)


def _rel_err(want, got):
    """max |want - got| / max |want|, in exact arithmetic."""
    a = _exact(want)
    return float(np.max(np.abs(a - _exact(got))) / np.max(np.abs(a)))


def test_row_panel_functions_match_jax_shard_map(tmp_path, monkeypatch):
    monkeypatch.setattr(JL, "_USE_PALLAS_LINALG", False)
    S = [w[0] for w in spd_words(1, PN, NW, seed=5)]
    B = split_words(np.random.default_rng(6).standard_normal((PN, M)), NW)
    with jax.default_device(jax.devices("cpu")[0]):
        ok_j, (Lj, Xj, Xtj) = _jax_side(tuple(map(jnp.asarray, S)),
                                        tuple(map(jnp.asarray, B)))
    assert ok_j
    ranks = run_ranks(tmp_path, WORLD, "dist_linalg", S, Lj, B, NB,
                      flush=True)
    ref = _val(Lj)
    for r, (ok, (Lt, Xt, Xtt)) in enumerate(ranks):
        assert ok, r
        # the documented exception, measured as tests/test_torch_linalg.py
        # measures it (on the f64 values of the words)
        assert np.array_equal(Lj[0], Lt[0]), r
        err = np.max(np.abs(ref - _val(Lt)))
        assert err <= 2.0 ** -(24 * NW - 8) * np.max(np.abs(ref)), (r, err)
        for want, got in ((Lj, Lt), (Xj, Xt), (Xtj, Xtt)):
            assert all(np.array_equal(a, b) for a, b in zip(want[:3],
                                                            got[:3])), r
            assert _rel_err(want, got) <= 2.0 ** -100, r
