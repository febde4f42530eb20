"""The port's IPM iteration (clrs_tpu_torch.solver) against the JAX
package's, on the CPU.

- DeviceSDP: every word array and limb precompute of the port is
  bit-identical to clrs_tpu.solver.step.DeviceSDP(nw=5, float32): both run
  the same host rule on the same compiled SDP.
- The slice as a whole: the port's f32 nw=5 steps against the JAX package's
  default CPU steps (IEEE f64 double words). Both substrates carry about 106
  bits, so their (mu, d_obj, p_obj, alpha_d, alpha_p) trajectories agree at
  rel 1e-13, abs 1e-18, the contract of tests/test_substrate_equiv.py.
- A full port solve on the CPU reaches the polyopt oracle.

Each problem is built through each package's own API by one function that
takes the API module (a clrs_tpu Problem is not an instance of the port's
Problem class).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clrs_tpu as jc
import clrs_tpu_torch as ct
from clrs_tpu.solver import step as JS
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.solver import step as TS
from clrs_tpu_torch.state import state_from_numpy, state_to_numpy
from torch_helpers import delsarte, dense2, polyopt

STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)
INFO_KEYS = ("mu", "d_obj", "p_obj", "alpha_d", "alpha_p")


def _same(a, b, what):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b.astype(a.dtype)), what


def _same_words(wj, wt, what):
    assert len(wj) == len(wt), what
    for i, (a, b) in enumerate(zip(wj, wt)):
        _same(a, b, f"{what}[{i}]")


_CLASS_WORDS = ("C", "V", "lam", "Ul", "Ur", "Ulw", "Urw", "A")
_CLASS_ARRAYS = ("maskd", "maskdiag", "li", "ri", "tmask")
_CLASS_PRE = ("Vpre_r", "Vtpre_l", "V2pre_r", "V2tpre_l", "Urpre_r",
              "U2pre_l", "U2tpre_r", "Ulpre_l")


@pytest.mark.parametrize("budget", [None, 0], ids=["pairs", "t1loop"])
@pytest.mark.parametrize("build", [delsarte, dense2],
                         ids=["delsarte3_3", "dense2"])
def test_device_sdp_bit_identical_to_jax_f32(build, budget, monkeypatch):
    """Word arrays and limb precomputes at nw=5; budget 0 forces the t1-loop
    Schur path, whose V panels are precomputed too."""
    if budget is not None:
        monkeypatch.setattr(JS, "_SCHUR_T1_BATCH_BUDGET", budget)
        monkeypatch.setattr(TS, "_SCHUR_T1_BATCH_BUDGET", budget)
    args = (3,) if build is delsarte else ()
    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(build(jc, *args)), nw=5,
                      dtype=jnp.float32)
    dt = TS.DeviceSDP(ct.ClusteredLowRankSDP(build(ct, *args)), nw=5,
                      device="cpu")
    assert (dj.total_size, dj.total_rows, dj.nfree, dj.sign) == \
        (dt.total_size, dt.total_rows, dt.nfree, dt.sign)
    _same_words(dj.b, dt.b, "b")
    _same_words(dj.constant, dt.constant, "constant")
    assert len(dj.clusters) == len(dt.clusters)
    for cj, ctt in zip(dj.clusters, dt.clusters):
        assert (cj.J, cj.nrows, cj.members_j, cj.s_nb, cj.s_nreal) == \
            (ctt.J, ctt.nrows, ctt.members_j, ctt.s_nb, ctt.s_nreal)
        assert cj.layout == ctt.layout
        for key in ("c", "B", "sa", "sC"):
            if getattr(cj, key) is not None:
                _same_words(getattr(cj, key), getattr(ctt, key), key)
        if cj.smask is not None:
            _same(cj.smask, ctt.smask, "smask")
        assert len(cj.classes) == len(ctt.classes)
        for kj, kt in zip(cj.classes, ctt.classes):
            assert (kj.kind, kj.L, kj.n, kj.Lc, kj.members, kj.use_pairs) == \
                (kt.kind, kt.L, kt.n, kt.Lc, kt.members, kt.use_pairs)
            for key in _CLASS_WORDS:
                if getattr(kj, key) is not None:
                    _same_words(getattr(kj, key), getattr(kt, key), key)
            for key in _CLASS_ARRAYS:
                if getattr(kj, key) is not None:
                    _same(getattr(kj, key), getattr(kt, key), key)
            for key in _CLASS_PRE:
                pj, pt = getattr(kj, key), getattr(kt, key)
                assert (pj is None) == (pt is None), key
                if pj is not None:
                    _same(pj[0], pt[0], key + " limbs")
                    _same(pj[1], pt[1], key + " exps")


def test_state_round_trip():
    """state_to_numpy / state_from_numpy give back the port's words as they
    were, and the JAX package's initial states, f64 two-word and f32
    five-word, become the port's own initial state word for word."""
    flat = lambda s: jax.tree_util.tree_leaves(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, s))
    dt = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 3)), nw=5,
                      device="cpu")
    st, _ = TS.make_step_body(dt, **STEP_KW)(
        TS.initial_state(dt, 100.0, 100.0), False)   # words all in use
    back = state_from_numpy(dt, state_to_numpy(st))
    for a, b in zip(flat(state_to_numpy(st)), flat(state_to_numpy(back))):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    ref = flat(state_to_numpy(TS.initial_state(dt, 100.0, 100.0)))
    sdp_j = jc.ClusteredLowRankSDP(delsarte(jc, 3))
    for nw, dtype in ((2, jnp.float64), (5, jnp.float32)):
        dj = JS.DeviceSDP(sdp_j, nw=nw, dtype=dtype)
        sj = jax.tree_util.tree_map(np.asarray,
                                    JS.initial_state(dj, 100.0, 100.0))
        got = flat(state_to_numpy(state_from_numpy(dt, sj)))
        assert len(got) == len(ref)
        for a, b in zip(ref, got):
            assert b.dtype == np.float32 and np.array_equal(a, b)


def _trajectory(step, state, n):
    rows, feas = [], False
    for _ in range(n):
        state, info = step(state, feas)
        feas = bool(info["pd_feas"])
        assert bool(info["ok"])
        rows.append(tuple(float(info[k]) for k in INFO_KEYS))
    return rows, state


def _agree(r_ref, r_port):
    for a, b in zip(r_ref, r_port):
        for x, y in zip(a, b):
            assert x == pytest.approx(y, rel=1e-13, abs=1e-18), (a, b)


def test_slice_matches_jax_f64_steps():
    """Six port steps (f32 nw=5, plain versions of the kernels) against the
    JAX package's default CPU steps on delsarte(3,5); then one port step
    from the JAX iterate after three steps (state_from_numpy) against the
    JAX fourth step."""
    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(delsarte(jc, 5)))
    stepj = JS.make_step(dj, **STEP_KW)
    rows_j, feas, states_j = [], False, []
    sj = JS.initial_state(dj, 100.0, 100.0)
    for _ in range(6):
        states_j.append(jax.tree_util.tree_map(np.asarray, sj))
        sj, info = stepj(sj, feas)
        rows_j.append((feas, tuple(float(info[k]) for k in INFO_KEYS)))
        feas = bool(info["pd_feas"])
        assert bool(info["ok"])

    K.reset_counts()
    dt = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 5)), nw=5,
                      device="cpu")
    step = TS.make_step_body(dt, **STEP_KW)
    rows_t, _ = _trajectory(step, TS.initial_state(dt, 100.0, 100.0), 6)
    _agree([r for _, r in rows_j], rows_t)
    counts = K.counts()
    assert all(counts[f.__name__] == 0 for f in K._COUNTED)
    assert all(counts[f.__name__] > 0 for f in K._PLAIN)

    feas3, ref4 = rows_j[3]
    _, info = step(state_from_numpy(dt, states_j[3]), feas3)
    _agree([ref4], [tuple(float(info[k]) for k in INFO_KEYS)])


def test_dense_block_step_matches_jax_f64():
    """The dense-class Schur, trace and weighted-A paths: three steps of a
    dense 2x2 problem against the JAX default CPU steps."""
    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(dense2(jc)))
    rows_j, _ = _trajectory(JS.make_step(dj, **STEP_KW),
                            JS.initial_state(dj, 10.0, 10.0), 3)
    dt = TS.DeviceSDP(ct.ClusteredLowRankSDP(dense2(ct)), nw=5, device="cpu")
    rows_t, _ = _trajectory(TS.make_step_body(dt, **STEP_KW),
                            TS.initial_state(dt, 10.0, 10.0), 3)
    _agree(rows_j, rows_t)


def test_t1_loop_schur_matches_pair_path(monkeypatch):
    """The t1-loop Schur path (taken above the pair budget) against the
    pair path inside the port: two steps of delsarte(3,3) agree to rel
    1e-13 (the two paths sum the same products in different orders)."""
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, 3))
    rows = []
    for budget in (TS._SCHUR_T1_BATCH_BUDGET, 0):
        monkeypatch.setattr(TS, "_SCHUR_T1_BATCH_BUDGET", budget)
        ds = TS.DeviceSDP(sdp, nw=5, device="cpu")
        assert all(k.use_pairs == (budget > 0) for cl in ds.clusters
                   for k in cl.classes)
        r, _ = _trajectory(TS.make_step_body(ds, **STEP_KW),
                           TS.initial_state(ds, 100.0, 100.0), 2)
        rows.append(r)
    _agree(rows[0], rows[1])


def test_solvesdp_polyopt_on_cpu():
    """A full port solve on the CPU reaches the polyopt oracle 1.0
    (tests/test_solver_examples.py:16-28)."""
    problem = polyopt(ct)
    status, dualsol, primalsol, t, code = ct.solvesdp(
        problem, device="cpu", omega_p=100.0, omega_d=100.0, verbose=False,
        dual_error_threshold=1e-12, primal_error_threshold=1e-12)
    assert code == 0
    assert ct.optimal(status)
    assert abs(float(ct.objvalue(problem, primalsol)) - 1.0) < 1e-10


def test_solvesdp_refuses_unported_routes():
    problem = polyopt(ct)
    with pytest.raises(NotImplementedError):
        ct.solvesdp(problem, device="cpu", substrate="f64", verbose=False)
    with pytest.raises(NotImplementedError):
        ct.solvesdp(problem, device="cpu", mesh=object(), verbose=False)
    with pytest.raises(ValueError):
        ct.solvesdp(problem, device=None, verbose=False)


@pytest.mark.slow
def test_slice_matches_jax_f32_steps():
    """The same comparison against the JAX f32 nw=5 step (the substrate the
    Pallas kernels compute; about two minutes of XLA compile here)."""
    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(delsarte(jc, 5)), nw=5,
                      dtype=jnp.float32)
    rows_j, _ = _trajectory(JS.make_step(dj, **STEP_KW),
                            JS.initial_state(dj, 100.0, 100.0), 6)
    dt = TS.DeviceSDP(ct.ClusteredLowRankSDP(delsarte(ct, 5)), nw=5,
                      device="cpu")
    rows_t, _ = _trajectory(TS.make_step_body(dt, **STEP_KW),
                            TS.initial_state(dt, 100.0, 100.0), 6)
    _agree(rows_j, rows_t)
