"""The certified step-length route (clrs_tpu_torch.solver.step,
``_STEPLEN_VERIFIED = True``; the JAX package's TPU route,
clrs_tpu/solver/step.py:1083-1151) against the JAX package, on the CPU.

- The limb GEMMs at the word counts the route calls them with (an nw-word
  by one-word product, and one-word operands into two words) equal the JAX
  ``fx_matmul`` (its CPU route, the Pallas kernels off) bit for bit, on
  both of the port's routes.
- Given the JAX package's own eigenpairs, everything after the eigensolver
  equals ``_eig_lo_verified`` bit for bit.
- With the port's own f32 eigensolver (LAPACK's last bits differ from the
  JAX package's by about 1e-6 here) the bound is a lower bound, tight to
  the JAX test's tolerance (tests/test_expops.py:165-189), and a member
  that is not finite gives NaN without touching the others.
- delsarte(3,10)'s first step: the step lengths of the port's tail equal
  the JAX package's ``_step_lengths`` on the same directions and factors
  within rel 1e-12 (the two sides' triangular solves sum in different
  orders), with the JAX eigensolver's pairs on the port's own matrices.

Inputs come from a numpy seed, split into f32 words as
tests/test_expops.py:174-184 does. Every test sets the module globals
through monkeypatch, which restores them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clrs_tpu as jc
import clrs_tpu_torch as ct
from clrs_tpu.dd import limb_gemm as JG
from clrs_tpu.solver import step as JS
from clrs_tpu_torch.dd import limb_gemm as TG
from clrs_tpu_torch.solver import step as TS
from clrs_tpu_torch.state import state_to_numpy
from torch_helpers import delsarte, split_words, xla_subnormals  # noqa: F401

STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)


def _sym_words(B, n, nw, seed):
    """nw f32 words of B random symmetric n x n matrices (test_expops.py)."""
    a = np.random.default_rng(seed).standard_normal((B, n, n))
    return split_words(0.25 * (a + np.swapaxes(a, 1, 2)), nw), a


def _t(ws):
    return tuple(torch.from_numpy(np.ascontiguousarray(w)) for w in ws)


def _bits(x):
    x = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int64)


@pytest.mark.parametrize("route", ["split", "fused"])
@pytest.mark.parametrize("nw_a, nw, n", [(5, None, 12), (8, None, 12),
                                         (1, 2, 12), (1, 2, 130)],
                         ids=["nw5_by_1", "nw8_by_1", "nw2_n12", "nw2_n130"])
def test_limb_gemm_word_counts_match_jax(nw_a, nw, n, route):
    rng = np.random.default_rng(nw_a * 1000 + n)
    a = split_words(rng.standard_normal((n, n)), nw_a)
    b = split_words(rng.standard_normal((n, n)), 1)
    want = jax.jit(lambda a, b: JG.fx_matmul(a, b, nw=nw))(
        tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    got = TG.fx_matmul(_t(w[None] for w in a), _t(w[None] for w in b), nw=nw,
                       route=route)
    assert len(got) == len(want) == (nw or nw_a)
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g[0]), _bits(w))


def test_route_decision_at_nw2():
    """The V^T V product takes the fused limb GEMM from n = 126 on, as the
    JAX package's route decision does ((10 n)^2 4 B above 6 MiB)."""
    assert TG.gemm_route(125, 125, 125, 2) == "split"
    assert TG.gemm_route(126, 126, 126, 2) == "fused"


def test_certification_equals_jax_on_its_eigenpairs(monkeypatch,
                                                    xla_subnormals):
    monkeypatch.setattr(JS, "_STEPLEN_VERIFIED", True)
    ws, _ = _sym_words(4, 12, 5, 0)
    wj = tuple(map(jnp.asarray, ws))
    want = np.asarray(jax.jit(JS._eig_lo_verified)(wj))

    def a32(w):
        A = w[0]
        for c in w[1:]:
            A = A + c
        return 0.5 * (A + jnp.swapaxes(A, -1, -2))

    A_j = jax.jit(a32)(wj)
    lam, V = jax.jit(jnp.linalg.eigh)(A_j)
    W2 = _t(ws)
    A_t, bad = TS._eig_input_f32(W2)
    assert np.array_equal(_bits(A_t), _bits(A_j)) and not bad.any()
    got = TS._eig_lo_certified(W2, torch.from_numpy(np.array(lam)),
                               torch.from_numpy(np.array(V)))
    assert got.dtype == torch.float64
    assert np.array_equal(_bits(got), _bits(want))


def test_own_eigensolver_bound_is_tight_and_masks_nan(monkeypatch):
    monkeypatch.setattr(TS, "_STEPLEN_VERIFIED", True)
    ws, a = _sym_words(4, 12, 5, 0)
    W2 = _t(ws)

    def bounds(W2):
        A, bad = TS._eig_input_f32(W2)
        (pair,) = TS.step_eig([A])
        return torch.where(bad, float("nan"), TS._eig_lo_certified(W2, *pair))

    lo = bounds(W2).numpy()
    true = np.linalg.eigvalsh(0.25 * (a + np.swapaxes(a, 1, 2)))[:, 0]
    assert np.all(lo <= true + 1e-12)
    assert np.all(true - lo < 1e-4 * (1 + np.abs(true)))
    # a NaN in one member (a failed Cholesky's factor) gives NaN there and
    # leaves the other members' bounds as they were
    bad = tuple(w.clone() for w in W2)
    bad[0][2, 5, 7] = float("nan")
    lo_bad = bounds(bad).numpy()
    assert np.isnan(lo_bad[2])
    keep = [0, 1, 3]
    assert np.array_equal(_bits(lo_bad[keep]), _bits(lo[keep]))


def test_route_global():
    """None picks the float64 eigvalsh route, as the JAX package does off a
    TPU; the eager eigensolver follows the matrices' dtype."""
    assert TS._STEPLEN_VERIFIED is None and not TS._use_verified_eig()
    A = torch.eye(3, dtype=torch.float64)[None]
    (low,) = TS.step_eig([A])
    assert low.shape == (1,) and low.dtype == torch.float64
    (pair,) = TS.step_eig([A.float()])
    assert [t.shape for t in pair] == [(1, 3), (1, 3, 3)]


def test_first_step_lengths_match_jax(monkeypatch):
    monkeypatch.setattr(TS, "_STEPLEN_VERIFIED", True)
    monkeypatch.setattr(JS, "_STEPLEN_VERIFIED", True)
    # the JAX eigensolver's pairs on the port's own matrices
    monkeypatch.setattr(TS, "eig_pairs", lambda mats: [
        tuple(torch.from_numpy(np.array(x)) for x in
              jax.jit(jnp.linalg.eigh)(jnp.asarray(A.numpy())))
        for A in mats])
    dt = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 10)), nw=5,
                      device="cpu")
    state = TS.initial_state(dt, 100.0, 100.0)
    head, tail = TS.make_step_parts(dt, **STEP_KW)
    mid, mats = head(state, torch.zeros((), dtype=torch.bool))
    assert all(A.dtype == torch.float32 for A in mats)
    assert len(mid["words"]) == len(mats) > 0
    _, info = tail(state, mid, TS.step_eig(mats))

    cholX, cholY = [], []
    for j, cl in enumerate(dt.clusters):
        cx, cy = [], []
        for ki, k in enumerate(cl.classes):
            L2, _ = TS.dl.b_cholesky(TS._cat(state["X"][j][ki],
                                             state["Y"][j][ki]))
            cx.append(tuple(c[:k.L] for c in L2))
            cy.append(tuple(c[k.L:] for c in L2))
        cholX.append(cx)
        cholY.append(cy)

    def np_tree(t):
        if isinstance(t, torch.Tensor):
            return jnp.asarray(t.numpy())
        return type(t)(np_tree(x) for x in t)

    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(delsarte(jc, 10)), nw=5,
                      dtype=jnp.float32)
    sj = jax.tree_util.tree_map(jnp.asarray, state_to_numpy(state))
    args = [np_tree(mid[k]) for k in ("dX", "dXs", "dY", "dYs")]
    lengths = jax.jit(lambda s, dX, dXs, dY, dYs, cx, cy: JS._step_lengths(
        dj, s, dX, dXs, dY, dYs, cx, cy, STEP_KW["gamma"], 1e-12))
    a_d, a_p, _ = lengths(sj, *args, np_tree(cholX), np_tree(cholY))
    for got, want in ((info["alpha_d"], a_d), (info["alpha_p"], a_p)):
        assert float(got) == pytest.approx(float(want), rel=1e-12, abs=0)
    assert float(info["alpha_d"]) < 1.0 or float(info["alpha_p"]) < 1.0
