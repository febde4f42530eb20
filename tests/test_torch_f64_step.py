"""The port's IPM iteration on f64 words against the JAX package's
default CPU step (f64 double words, nw 2), on delsarte(3,5) (one JAX
compile in this file).

- DeviceSDP(nw=2, float64): every word array is bit-identical to
  clrs_tpu.solver.step.DeviceSDP(nw=2)'s.
- The first step's new state equals the JAX step's word for word. The
  step-length eigensolver is the one place where the last bits may
  differ (LAPACK through XLA against PyTorch's LAPACK), so the port's
  tail gets the lowest eigenvalues of the reference's eigensolver
  (``jnp.linalg.eigvalsh``) on the port's own step-length matrices.
- Six steps (the port's own eigensolver) agree at rel 1e-13, abs 1e-18.
- JAX f64 states (initial states at nw 2, 4, 5, and the iterate after
  three steps) enter through state_from_numpy word for word; one port
  step from the third JAX iterate agrees with the fourth JAX step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clrs_tpu as jc
import clrs_tpu_torch as ct
from clrs_tpu.solver import step as JS
from clrs_tpu_torch.solver import step as TS
from clrs_tpu_torch.state import state_from_numpy, state_to_numpy
from torch_helpers import delsarte, xla_subnormals  # noqa: F401

STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)
INFO_KEYS = ("mu", "d_obj", "p_obj", "alpha_d", "alpha_p")
F64 = torch.float64


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                            tree))


def _bits_equal(a, b):
    """Same shape, dtype and bits (f64 compared as int64 patterns)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.float64:
        a, b = a.view(np.int64), b.view(np.int64)
    return np.array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX package's six default CPU steps on delsarte(3,5): the host
    states before each step and the infos."""
    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(delsarte(jc, 5)))
    step = JS.make_step(dj, **STEP_KW)
    state = JS.initial_state(dj, 100.0, 100.0)
    states, rows, feas = [], [], False
    for _ in range(6):
        states.append(jax.tree_util.tree_map(np.asarray, state))
        state, info = step(state, feas)
        rows.append((feas, tuple(float(info[k]) for k in INFO_KEYS)))
        feas = bool(info["pd_feas"])
    states.append(jax.tree_util.tree_map(np.asarray, state))
    return dj, states, rows


def _port(nw=2):
    return TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 5)), nw=nw,
                        device="cpu", dtype=F64)


_WORDS = ("C", "V", "lam", "Ul", "Ur", "Ulw", "Urw", "A")
_ARRAYS = ("maskd", "maskdiag", "li", "ri", "tmask")


def test_device_sdp_f64_bit_identical_to_jax():
    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(delsarte(jc, 5)), nw=2)
    dt = _port()
    assert (dj.total_size, dj.nfree, dj.sign) == \
        (dt.total_size, dt.nfree, dt.sign)
    pairs = [(dj.b, dt.b), (dj.constant, dt.constant)]
    for cj, ctt in zip(dj.clusters, dt.clusters):
        assert cj.layout == ctt.layout and cj.s_nb == ctt.s_nb
        pairs += [(getattr(cj, k), getattr(ctt, k))
                  for k in ("c", "B", "sa", "sC")]
        pairs.append(((cj.smask,), (ctt.smask,)))
        for kj, kt in zip(cj.classes, ctt.classes):
            assert (kj.kind, kj.L, kj.n, kj.use_pairs) == \
                (kt.kind, kt.L, kt.n, kt.use_pairs)
            assert kt.Vpre_r is None and kt.U2pre_l is None
            pairs += [(getattr(kj, k), getattr(kt, k)) for k in _WORDS
                      if getattr(kj, k) is not None]
            pairs += [((getattr(kj, k),), (getattr(kt, k),))
                      for k in _ARRAYS]
    for wj, wt in pairs:
        assert len(wj) == len(wt)
        for a, b in zip(wj, wt):
            b = b.numpy()
            if b.dtype == np.int64:                # torch's index dtype
                b = b.astype(np.asarray(a).dtype)
            assert _bits_equal(a, b)


def test_first_step_word_for_word(xla_subnormals):
    _, states, _ = _jax_run()
    dt = _port()
    head, tail = TS.make_step_parts(dt, **STEP_KW)
    st = TS.initial_state(dt, 100.0, 100.0)
    assert all(_bits_equal(a, b) for a, b in zip(
        _leaves(states[0]), _leaves(state_to_numpy(st))))
    mid, mats = head(st, torch.tensor(False))
    lows = [torch.from_numpy(np.asarray(jnp.linalg.eigvalsh(
        jnp.asarray(A.numpy())))[:, 0]) for A in mats]
    new, _ = tail(st, mid, lows)
    want, got = _leaves(states[1]), _leaves(state_to_numpy(new))
    assert len(want) == len(got)
    assert all(_bits_equal(a, b) for a, b in zip(want, got))


def _agree(ref, got):
    for a, b in zip(ref, got):
        assert b == pytest.approx(a, rel=1e-13, abs=1e-18), (ref, got)


def test_six_steps_agree_with_jax():
    _, _, rows = _jax_run()
    dt = _port()
    step = TS.make_step_body(dt, **STEP_KW)
    state, feas = TS.initial_state(dt, 100.0, 100.0), False
    for feas_j, ref in rows:
        assert feas == feas_j
        state, info = step(state, feas)
        assert bool(info["ok"])
        feas = bool(info["pd_feas"])
        _agree(ref, [float(info[k]) for k in INFO_KEYS])


@pytest.mark.parametrize("nw", [2, 4, 5])
def test_jax_f64_initial_state_enters_word_for_word(nw):
    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(delsarte(jc, 5)), nw=nw)
    sj = jax.tree_util.tree_map(np.asarray,
                                JS.initial_state(dj, 100.0, 100.0))
    got = state_to_numpy(state_from_numpy(_port(nw), sj))
    want = _leaves(sj)
    assert len(want) == len(_leaves(got))
    assert all(_bits_equal(a, b) for a, b in zip(want, _leaves(got)))


def test_jax_iterate_enters_and_steps_on():
    """The JAX iterate after three steps enters word for word; the port's
    step from it agrees with the JAX fourth step. A state of another word
    count or dtype is refused."""
    _, states, rows = _jax_run()
    dt = _port()
    st = state_from_numpy(dt, states[3])
    assert all(_bits_equal(a, b) for a, b in zip(
        _leaves(states[3]), _leaves(state_to_numpy(st))))
    feas3, ref4 = rows[3]
    _, info = TS.make_step_body(dt, **STEP_KW)(st, feas3)
    _agree(ref4, [float(info[k]) for k in INFO_KEYS])
    with pytest.raises(ValueError):
        state_from_numpy(_port(4), states[3])
