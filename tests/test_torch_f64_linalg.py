"""The port's f64 factorizations (clrs_tpu_torch.dd.linalg on f64 words)
against the JAX package's on the CPU, bit for bit.

- b_cholesky, b_solve_tril and b_solve_tril_t on f64 words against the
  jitted clrs_tpu.dd.linalg front ends at nw 2 and 4: unblocked (n 7,
  the vmapped dd_cholesky/dd_solve_tril/dd_solve_triu) and blocked (n 100,
  nb 64, the trailing updates as slice GEMMs). XLA:CPU flushes f64
  subnormals, so the port runs under the same flush.
- ok is False for an indefinite member only.
- The f32 kernel wrappers raise on f64 words, on the CPU as on the card:
  nothing casts f64 words to f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clrs_tpu.dd import linalg as JL
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.dd import linalg as TL
from torch_helpers import xla_subnormals  # noqa: F401

B = 3


def spd_f64(rng, n, nw, indefinite=None):
    """nw-word f64 symmetric positive definite [B, n, n] (member
    ``indefinite``, if given, has a negative pivot)."""
    a = rng.standard_normal((B, n, n))
    a = a @ a.transpose(0, 2, 1) + n * np.eye(n)
    if indefinite is not None:
        a[indefinite, n // 2, n // 2] = -1.0
    ws = [a]
    for _ in range(1, nw):
        ws.append(ws[-1] * 2.0 ** -53 * rng.uniform(-1, 1, a.shape))
    return [0.5 * (w + w.transpose(0, 2, 1)) for w in ws]


@functools.lru_cache(maxsize=None)
def _case(nw, n):
    rng = np.random.default_rng(10 * nw + n)
    a = spd_f64(rng, n, nw)
    b = [rng.standard_normal((B, n, 3))] + \
        [rng.standard_normal((B, n, 3)) * 2.0 ** -60 for _ in range(nw - 1)]
    ja = tuple(map(jnp.asarray, a))
    L, ok = jax.jit(JL.b_cholesky)(ja)
    jb = tuple(map(jnp.asarray, b))
    X = jax.jit(JL.b_solve_tril)(L, jb)
    Y = jax.jit(JL.b_solve_tril_t)(L, jb)
    host = lambda v: [np.asarray(c) for c in v]  # noqa: E731
    return a, b, host(L), np.asarray(ok), host(X), host(Y)


def _t(ws):
    return tuple(torch.from_numpy(np.array(w)) for w in ws)


def _same(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert np.array_equal(r.view(np.int64), g.numpy().view(np.int64))


CASES = [(2, 7), (4, 7), (2, 100), (4, 100)]


@pytest.mark.parametrize("nw, n", CASES)
def test_b_cholesky_bit_identical_to_jax(nw, n, xla_subnormals):
    a, _, L, ok, _, _ = _case(nw, n)
    Lt, okt = TL.b_cholesky(_t(a))
    _same(L, Lt)
    assert ok.all() and okt.all()


@pytest.mark.parametrize("nw, n", CASES)
def test_b_solve_tril_bit_identical_to_jax(nw, n, xla_subnormals):
    _, b, L, _, X, _ = _case(nw, n)
    _same(X, TL.b_solve_tril(_t(L), _t(b)))


@pytest.mark.parametrize("nw, n", CASES)
def test_b_solve_tril_t_bit_identical_to_jax(nw, n, xla_subnormals):
    _, b, L, _, _, Y = _case(nw, n)
    _same(Y, TL.b_solve_tril_t(_t(L), _t(b)))


@pytest.mark.parametrize("n", [7, 100])
def test_cholesky_flags_the_indefinite_member(n):
    rng = np.random.default_rng(n)
    _, ok = TL.b_cholesky(_t(spd_f64(rng, n, 2, indefinite=1)))
    assert ok.tolist() == [True, False, True]


def test_f32_kernel_wrappers_refuse_f64_words():
    rng = np.random.default_rng(0)
    a = _t(spd_f64(rng, 7, 5))
    b = tuple(c[:, :, :2] for c in a)
    calls = [lambda: K.chol_batched(a),
             lambda: K.tri_solve_batched(a, b),
             lambda: K.tri_solve_batched(a, b, trans=True),
             lambda: K.limb_extract(a, K.limb_params(5)[0], "a"),
             lambda: K.plmap_add(a, a),
             lambda: K.plmap_axpy(a, a, tuple(c[:, :1, :1] for c in a[:3])),
             lambda: K.plmap_residual(tuple(c[:, :1, :1] for c in a),
                                      a[0], a)]
    for call in calls:
        with pytest.raises(ValueError, match="f64 words"):
            call()
