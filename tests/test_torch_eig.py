"""The step-length eigensolver's plain versions (clrs_tpu_torch/dd/
kernels.py ``eig_lowest_plain`` and ``eig_pairs_plain``, op for op the
kernels of csrc/eig.cu) against the JAX package and LAPACK, on the CPU.

- The float64 lowest eigenvalue against the JAX package's off-TPU bound
  (``clrs_tpu.solver.step._eig_lo_bound``, ``jnp.linalg.eigvalsh``, at
  eig_safety 0 and 1e-12) and numpy's LAPACK, within 8 n 2^-53 ||A||_F.
- The Jacobi pairs: the residual ||A - V diag(lam) V^T||_F and
  ||V^T V - I||_F within 8 n 2^-24 (times ||A||_F for the residual); the
  certified bound from them (``_eig_lo_certified``) no higher than numpy's
  float64 lambda_min (1e-12 (1 + |lambda|) of slack) and within 1e-4
  (1 + |lambda|) of the JAX package's ``_eig_lo_verified`` on the same
  words.
- The reduction order the kernels use (thread t takes the terms t, t + T,
  ..., then the halving tree) against a literal emulation of the
  kernels' loops, and the round-robin tables.
- delsarte(3,10) solved at f64 on the CPU with the step's eigensolver
  routed to the plain lowest eigenvalue: phase 8's oracle.

Inputs: seeded numpy symmetric matrices at n 1, 2, 7, 11, 33 and 96:
random, diagonal, with a repeated lowest eigenvalue, and zero.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clrs_tpu_torch as ct
from clrs_tpu.solver import step as JS
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.examples import delsarte_problem
from clrs_tpu_torch.solver import step as TS
from torch_helpers import split_words

NS = (1, 2, 7, 11, 33, 96)
KINDS = ("random", "diagonal", "repeated", "zero")
B = 3


def _matrices(n, kind, seed=0):
    """B symmetric float64 n x n matrices of the given kind."""
    rng = np.random.default_rng(1000 * n + KINDS.index(kind) + seed)
    if kind == "zero":
        return np.zeros((B, n, n))
    if kind == "diagonal":
        return np.stack([np.diag(rng.standard_normal(n)) for _ in range(B)])
    a = rng.standard_normal((B, n, n))
    a = 0.5 * (a + np.swapaxes(a, 1, 2))
    if kind == "random":
        return a
    # a lowest eigenvalue of multiplicity min(n, 3) in a random basis
    out = []
    for m in a:
        q, _ = np.linalg.qr(m + n * np.eye(n))
        lam = np.sort(rng.standard_normal(n))
        lam[:min(n, 3)] = lam[0]
        out.append((q * lam) @ q.T)
    out = np.stack(out)
    return 0.5 * (out + np.swapaxes(out, 1, 2))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", NS)
def test_plain_lowest_eigenvalue(n, kind):
    a = _matrices(n, kind)
    K.reset_counts()
    lo = K.eig_lowest(torch.from_numpy(a)).numpy()
    assert K.counts()["eig_lowest_plain"] == 1
    ref = np.linalg.eigvalsh(a)[:, 0]
    tol = 8 * n * 2.0 ** -53 * np.linalg.norm(a, axis=(1, 2))
    assert np.all(np.abs(lo - ref) <= tol), (lo - ref, tol)
    for safety in (0.0, 1e-12):
        jax_lo = np.asarray(JS._eig_lo_bound((jnp.asarray(a),), safety))
        ours = lo - safety * (1.0 + np.abs(lo))
        assert np.all(np.abs(ours - jax_lo) <= tol + 1e-15 * np.abs(jax_lo))
    if kind == "zero":
        assert np.all(lo == 0.0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", NS)
def test_plain_jacobi_pairs(n, kind):
    a = _matrices(n, kind).astype(np.float32)
    K.reset_counts()
    lam, V = K.eig_pairs(torch.from_numpy(a))
    assert K.counts()["eig_pairs_plain"] == 1
    lam, V = lam.numpy().astype(np.float64), V.numpy().astype(np.float64)
    assert np.all(np.diff(lam, axis=1) >= 0)
    a64 = a.astype(np.float64)
    fro = np.linalg.norm(a64, axis=(1, 2))
    bound = 8 * n * 2.0 ** -24
    res = np.linalg.norm(a64 - (V * lam[:, None, :]) @ np.swapaxes(V, 1, 2),
                         axis=(1, 2))
    orth = np.linalg.norm(np.swapaxes(V, 1, 2) @ V - np.eye(n), axis=(1, 2))
    assert np.all(res <= bound * fro), (res, bound * fro)
    assert np.all(orth <= bound), (orth, bound)


@pytest.mark.parametrize("n", NS)
def test_certified_bound_from_plain_pairs(n, monkeypatch):
    """The certified route's bound from the plain Jacobi pairs: a lower
    bound of the float64 lambda_min, within the JAX test's 1e-4 of the JAX
    package's own certified bound on the same f32 words."""
    monkeypatch.setattr(JS, "_STEPLEN_VERIFIED", True)
    a = _matrices(n, "random", seed=1)
    ws = split_words(a, 5)
    W2 = tuple(torch.from_numpy(np.ascontiguousarray(w)) for w in ws)
    A32, _ = TS._eig_input_f32(W2)
    lam, V = K.eig_pairs(A32)
    ours = TS._eig_lo_certified(W2, lam, V).numpy()
    words64 = sum(w.astype(np.float64) for w in ws)
    true = np.linalg.eigvalsh(0.5 * (words64 + np.swapaxes(words64, 1, 2)))[:, 0]
    scale = 1.0 + np.abs(true)
    assert np.all(ours <= true + 1e-12 * scale), (ours - true)
    jax_lo = np.asarray(jax.jit(JS._eig_lo_verified)(
        tuple(jnp.asarray(w) for w in ws)))
    assert np.all(np.abs(ours - jax_lo) <= 1e-4 * scale), (ours - jax_lo)


def _emulated_sum(x, T):
    """The kernels' order, literally: thread t adds x[t], x[t + T], ... to
    +0 in turn, then partial[t] += partial[t + off] for off = T/2, ..., 1."""
    part = [0.0] * T
    for t in range(T):
        for i in range(t, len(x), T):
            part[t] = float(np.float64(part[t]) + np.float64(x[i]))
    off = T // 2
    while off:
        for t in range(off):
            part[t] = float(np.float64(part[t]) + np.float64(part[t + off]))
        off //= 2
    return part[0]


@pytest.mark.parametrize("m, T", [(1, 32), (31, 32), (33, 32), (95, 32),
                                  (9216, 1024), (5000, 1024)])
def test_strided_sum_is_the_kernels_order(m, T):
    x = np.random.default_rng(m).standard_normal(m) * np.exp(
        np.random.default_rng(m + 1).uniform(-30, 30, m))
    got = K.strided_sum(torch.from_numpy(x)[None], T)[0].item()
    assert got == _emulated_sum(x, T)


@pytest.mark.parametrize("N", [2, 4, 12, 96])
def test_round_robin_pairs_cover_every_pair_once(N):
    seen = set()
    for p, q in K.jacobi_pairs(N):
        idx = torch.cat([p, q]).tolist()
        assert sorted(idx) == list(range(N)) and bool((p < q).all())
        seen.update(zip(p.tolist(), q.tolist()))
    assert len(seen) == N * (N - 1) // 2


def test_step_eigensolver_on_the_cpu_is_lapack():
    """The step's eigensolver on CPU tensors is LAPACK's (the JAX package's
    CPU route), not the kernels' plain versions."""
    a = _matrices(7, "random")
    K.reset_counts()
    (lo,) = TS.eig_lowest([torch.from_numpy(a)])
    ((lam, V),) = TS.eig_pairs([torch.from_numpy(a.astype(np.float32))])
    assert K.counts()["eig_lowest_plain"] == K.counts()["eig_pairs_plain"] == 0
    A = torch.from_numpy(a)
    assert torch.equal(lo, torch.linalg.eigvalsh(A)[:, 0])
    ref = torch.linalg.eigh(A.float())
    assert torch.equal(lam, ref[0]) and torch.equal(V, ref[1])


# clrs_tpu.solvesdp(delsarte(3,10), substrate="f64") on the CPU (chip_smoke
# phase 8's oracle): pdOpt, code 0, 13.15831434739031 in 28 iterations
DELSARTE_3_10 = 13.15831434739031


def test_delsarte_f64_solve_with_the_plain_lowest_eigenvalue(monkeypatch):
    monkeypatch.setattr(TS, "eig_lowest",
                        lambda mats: [K.eig_lowest_plain(A) for A in mats])
    problem = delsarte_problem(3, 10, Fraction(1, 2))
    iters = []
    K.reset_counts()
    status, _, primal, _, code = ct.solvesdp(
        problem, substrate="f64", device="cpu", omega_p=100, omega_d=100,
        sync_every=1, verbose=False, callback=lambda it, info: iters.append(it),
        dual_error_threshold=1e-12, primal_error_threshold=1e-12)
    assert code == 0 and ct.optimal(status)
    assert abs(float(ct.objvalue(problem, primal)) - DELSARTE_3_10) < 1e-9
    assert iters[-1] == 28
    assert K.counts()["eig_lowest_plain"] >= 28
