"""theta(C5) at f32 nw 5, the port against the JAX package on the CPU
(ROADMAP.md, section C, C4: the two solves end differently, the JAX
package's with a failed Cholesky, the port's at the iteration cap).

The two states differ from the first iteration on, through two known
deviations and no fault of the port:

- the arithmetic route: the JAX package runs f32 words on the CPU through
  its presorted qd forms (clrs_tpu/dd/core.py:448-458 routes its exp_*
  forms to the TPU only); the port runs the exp_* forms everywhere, as the
  TPU and the card do. The first quantity that differs is X^-1's
  symmetrization in the first iteration: the port's sum equals the JAX
  package's exp_add bit for bit, its CPU route differs in words 3-4;
- the step-length eigensolver: on the port's own first step-length
  matrices, PyTorch's LAPACK and the JAX package's give lambda_min 1 ulp
  apart (-1.00392 against -1.0039199999999995), so alpha_p differs in its
  last bits.

Handed the JAX package's state before each of the first four iterations
(tests/fixtures/c4_theta_c5_jax.npz, written by tests/c4_theta.py) and the
JAX eigensolver's lowest eigenvalues, the port's step gives the JAX
step's mu, step lengths and objectives exactly: the trajectories agree to
every decision of those iterations. theta(C5)'s optimum is degenerate, so
the last-bit differences grow as the solve runs on (tests/c4_theta.py
--solves runs the whole solves).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clrs_tpu as jc
import clrs_tpu.frontend.model as model_j
import clrs_tpu_torch as ct
import clrs_tpu_torch.examples as examples_t
import clrs_tpu_torch.frontend.model as model_t
from clrs_tpu.dd import core as JCORE
from clrs_tpu.dd import expops as JEXP
from clrs_tpu.solver import step as JS
from clrs_tpu_torch.dd import linalg as TL
from clrs_tpu_torch.dd.arith import dd_add
from clrs_tpu_torch.solver import step as TS
from clrs_tpu_torch.state import state_from_numpy
from torch_helpers import xla_subnormals  # noqa: F401
import c4_theta

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "c4_theta_c5_jax.npz"


@pytest.fixture(scope="module")
def packages():
    """theta(C5)'s DeviceSDP in each package, from each package's own
    example function (f32 nw 5)."""
    import theta_povm

    dj = JS.DeviceSDP(c4_theta.compiled_sdp(jc, model_j,
                                            theta_povm.lovasz_theta_c5),
                      nw=5, dtype=jnp.float32)
    dt = TS.DeviceSDP(c4_theta.compiled_sdp(ct, model_t,
                                            examples_t.lovasz_theta_c5),
                      nw=5, device="cpu")
    return dj, dt


def _jax_eig(mats):
    return [torch.from_numpy(np.array(jnp.linalg.eigvalsh(
        jnp.asarray(A.numpy())))[:, 0]) for A in mats]


def _first_head(dt, monkeypatch):
    """The port's first head from omega 100 I, and the first input of
    dd_symmetrize on the way (X^-1 = L^-T L^-1 of the first iteration)."""
    seen = []
    sym = TL.dd_symmetrize

    def spy(x):
        seen.append(tuple(c.clone() for c in x))
        return sym(x)

    monkeypatch.setattr(TL, "dd_symmetrize", spy)
    state = TS.initial_state(dt, 100.0, 100.0)
    head, tail = TS.make_step_parts(dt, **c4_theta.STEP_KW)
    mid, mats = head(state, torch.tensor(False))
    return state, tail, mid, mats, seen[0]


def test_first_difference_is_the_cpu_arithmetic_route(packages, monkeypatch,
                                                      xla_subnormals):
    _, dt = packages
    *_, w = _first_head(dt, monkeypatch)
    wt = tuple(c.transpose(-1, -2) for c in w)
    port = [c.numpy() for c in dd_add(w, wt)]
    wj = tuple(jnp.asarray(c.numpy()) for c in w)
    wjt = tuple(jnp.swapaxes(c, -1, -2) for c in wj)
    tpu_form = [np.asarray(c) for c in JEXP.exp_add(wj, wjt)]
    assert not JCORE._route_expops(wj)          # the CPU takes the qd forms
    cpu_form = [np.asarray(c) for c in JCORE.dd_add(wj, wjt)]
    assert all(np.array_equal(a, b) for a, b in zip(port, tpu_form))
    same = [np.array_equal(a, b) for a, b in zip(port, cpu_form)]
    assert same[:3] == [True] * 3 and not all(same[3:])
    # the two forms agree to the nw-word rounding: the words' sums differ
    # by 2^-100.8 of the entry (0.02), below 2^-96 of the largest entry
    diff = sum(a.astype(np.float64) - b.astype(np.float64)
               for a, b in zip(port[3:], cpu_form[3:]))
    assert 0 < np.abs(diff).max() <= 2.0 ** -96 * np.abs(port[0]).max()


def test_eigensolver_last_bits(packages, monkeypatch, xla_subnormals):
    _, dt = packages
    state, tail, mid, mats, _ = _first_head(dt, monkeypatch)
    lows_t = [torch.linalg.eigvalsh(A)[:, 0] for A in mats]
    lows_j = _jax_eig(mats)
    for lt, lj in zip(lows_t, lows_j):
        ulp = np.spacing(np.abs(lj.numpy()))
        assert np.all(np.abs(lt.numpy() - lj.numpy()) <= 4 * ulp)
    _, info_t = tail(state, mid, lows_t)
    _, info_j = tail(state, mid, lows_j)
    a_t, a_j = float(info_t["alpha_p"]), float(info_j["alpha_p"])
    assert a_t == pytest.approx(a_j, rel=1e-15, abs=0)


@pytest.mark.parametrize("it", range(1, c4_theta.N_ITERATIONS + 1))
def test_jax_state_and_eigenvalues_give_the_jax_step(packages, it,
                                                     xla_subnormals):
    dj, dt = packages
    data = np.load(FIXTURE)
    treedef = jax.tree_util.tree_structure(JS.initial_state(dj, 1.0, 1.0))
    n = treedef.num_leaves
    state_j = jax.tree_util.tree_unflatten(
        treedef, [data[f"state{it}_{i}"] for i in range(n)])
    head, tail = TS.make_step_parts(dt, **c4_theta.STEP_KW)
    state = state_from_numpy(dt, state_j)
    mid, mats = head(state, torch.tensor(bool(data[f"feas{it}"])))
    _, info = tail(state, mid, _jax_eig(mats))
    got = [float(info[k]) for k in c4_theta.INFO_KEYS]
    assert got == data[f"info{it}"].tolist()
