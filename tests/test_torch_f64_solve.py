"""solvesdp on the f64 substrate, on the CPU (no JAX in this file).

- solvesdp(substrate="f64", device="cpu") reaches the polyopt oracle 1.0
  (tests/test_solver_examples.py:16-28); on the default device, with no
  card, it raises.
- The f64 word ladder of the reference (clrs_tpu/solver/ipm.py:135-140).
- The port's two substrates, f64 nw 2 and f32 nw 5, agree over 8 steps of
  delsarte(3,5) at rel 1e-13, abs 1e-18: both carry at least 105 bits
  (tests/test_substrate_equiv.py:29-53).
"""

import pytest
import torch

import clrs_tpu_torch as ct
from clrs_tpu_torch.examples import polyopt
from clrs_tpu_torch.solver import step as TS
from clrs_tpu_torch.solver.ipm import word_count, word_count_f64
from torch_helpers import delsarte

STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)


def test_solvesdp_f64_polyopt_on_cpu():
    R, x = ct.polynomial_ring("x")
    problem, status, dualsol, primalsol, code = polyopt(
        x ** 2 + 1, 1, device="cpu", substrate="f64", omega_p=100.0,
        omega_d=100.0, verbose=False, dual_error_threshold=1e-12,
        primal_error_threshold=1e-12)
    assert code == 0 and ct.optimal(status)
    assert abs(float(ct.objvalue(problem, primalsol)) - 1.0) < 1e-10
    assert abs(float(ct.freevar(primalsol, "lambda")) - 1.0) < 1e-10


def test_solvesdp_f64_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    R, x = ct.polynomial_ring("x")
    with pytest.raises(RuntimeError):
        polyopt(x ** 2 + 1, 1, substrate="f64", verbose=False)


@pytest.mark.parametrize("prec, nw", [(None, 2), (106, 2), (107, 4),
                                      (150, 4), (212, 4), (213, 5),
                                      (256, 5), (600, 12)])
def test_f64_word_ladder(prec, nw):
    assert word_count_f64(prec) == nw


def test_f32_word_ladder_unchanged():
    assert [word_count(p) for p in (None, 106, 150, 192)] == [5, 5, 7, 8]


def test_f64_and_f32_substrates_agree():
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, 5))
    traj = {}
    for nw, dtype in ((2, torch.float64), (5, torch.float32)):
        ds = TS.DeviceSDP(sdp, nw=nw, device="cpu", dtype=dtype)
        step = TS.make_step_body(ds, **STEP_KW)
        state, feas, rows = TS.initial_state(ds, 100.0, 100.0), False, []
        for _ in range(8):
            state, info = step(state, feas)
            feas = bool(info["pd_feas"])
            assert bool(info["ok"])
            rows.append([float(info[k]) for k in
                         ("mu", "d_obj", "p_obj", "alpha_d", "alpha_p")])
        traj[dtype] = rows
    for r64, r32 in zip(traj[torch.float64], traj[torch.float32]):
        for a, b in zip(r64, r32):
            assert a == pytest.approx(b, rel=1e-13, abs=1e-18), (r64, r32)
