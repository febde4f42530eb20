"""The correctness check on the CPU, at sizes a test run holds:
- the plain reference accepts the port's answers (solved here on the CPU
  in f64 words) within each cell's limits;
- the control, the reference's own float64 solver in the port's place,
  fails them;
- an answer with a block outside the cone, or a certificate X whose
  objective is not the one reported, fails;
- a whole run of a cell, the chip's look skipped, comes out not correct
  when the timed path is broken underneath: a step that returns its state
  unchanged, and an answer altered where the port produces it.
"""

import copy
import functools
import time
from fractions import Fraction
from pathlib import Path

import pytest
import torch

from perfbench.harness import manifest
from perfbench.harness.answers import plain
from perfbench.harness.cell import run_cell
from perfbench.reference import delsarte, ipm64, threepoint

ROOT = Path(__file__).resolve().parents[2]
BENCH = manifest.load_bench(ROOT)


def limits(cell):
    return manifest.cell(ROOT, BENCH, cell).traffic["limits"]


def fails(readings, lim):
    return sorted(k for k in lim if readings[k] > lim[k])


@functools.lru_cache(maxsize=None)
def solved(family, **p):
    """The port's answer to a problem of the benchmark's families, solved
    once a test session on the CPU in f64 words."""
    from perfbench.harness import manifest as m
    kw = DELSARTE_KW if family == "delsarte" else THREEPOINT_KW
    p = {k: Fraction(v) if isinstance(v, str) else v for k, v in p.items()}
    return port_answer(m.family(family).build(p), **kw)


def port_answer(problem, **kw):
    import clrs_tpu_torch as ct
    _, dual, primal, _, code = ct.solvesdp(problem, device="cpu",
                                           substrate="f64", verbose=False,
                                           **kw)
    assert code == 0
    return plain(dual, primal)


DELSARTE_KW = dict(omega_p=100.0, omega_d=100.0, dual_error_threshold=1e-12,
                   primal_error_threshold=1e-12, duality_gap_threshold=1e-15)
THREEPOINT_KW = dict(omega_p=1000.0, omega_d=1000.0,
                     dual_error_threshold=1e-15,
                     primal_error_threshold=1e-15,
                     duality_gap_threshold=1e-18)


@pytest.mark.parametrize("costheta", ["1/2", "13/25"])
def test_reference_accepts_the_ports_delsarte_answer(costheta):
    p = {"n": 3, "d": 4, "costheta": Fraction(costheta)}
    r = delsarte.check(p, solved("delsarte", n=3, d=4, costheta=costheta))
    assert fails(r, limits("delsarte-3.d10")) == [], r
    assert r["cone"] == 0


THREEPOINT_P = {"n": 4, "costheta": Fraction(1, 6), "d2": -1, "d3": 3}


def test_reference_accepts_the_ports_threepoint_answer():
    r = threepoint.check(THREEPOINT_P,
                         solved("threepoint", n=4, costheta="1/6", d2=-1,
                                d3=3))
    assert fails(r, limits("threepoint-4.d6")) == [], r
    assert r["cone"] == 0


@pytest.mark.parametrize("side, block", [("Y", ("a", 1)), ("X", "slack"),
                                         ("Y", ("SOS", 1)),
                                         ("X", ("SOS", 2))])
def test_a_block_outside_the_cone_fails(side, block):
    p = {"n": 3, "d": 4, "costheta": Fraction(1, 2)}
    ans = copy.deepcopy(solved("delsarte", n=3, d=4, costheta="1/2"))
    m = ans[side][block]
    m[0][0] -= 2 * max(abs(v) for r in m for v in r) + Fraction(1, 2 ** 60)
    r = delsarte.check(p, ans)
    assert r["cone"] == 1
    assert "cone" in fails(r, limits("delsarte-3.d10"))


@pytest.mark.parametrize("rows", [
    [[2, 1], [1, 2]], [[1, 1], [1, 1]], [[0, 0], [0, 0]], [[5]],
    [[1, 3], [-1, 1]],                    # symmetric part diag(1, 1)
    [[Fraction(1, 2 ** 200), 0], [0, 1]]])
def test_psd_exact_yes(rows):
    from perfbench.reference.common import psd
    assert psd(rows)


@pytest.mark.parametrize("rows", [
    [[1, 2], [2, 1]], [[-Fraction(1, 2 ** 200)]], [[0, 1], [1, 0]],
    [[1, 1, 0], [1, 1, 0], [0, 0, -Fraction(1, 10 ** 40)]],
    # a rank-one matrix less 1e-30 times the identity
    [[Fraction(a * b) - (Fraction(1, 10 ** 30) if i == j else 0)
      for j, b in enumerate((1, 2, 3))] for i, a in enumerate((1, 2, 3))]])
def test_psd_exact_no(rows):
    from perfbench.reference.common import psd
    assert not psd(rows)


def test_a_certificate_whose_objective_is_not_the_ones_fails():
    # X - C scaled by 1 - 2^-30 stays in the constraint matrices' span
    # and in the cone (C is 0 or the all-ones matrix), and the answer's
    # own x is unchanged: only the objective fitted to X sees that X
    # certifies another bound
    ans = copy.deepcopy(solved("threepoint", n=4, costheta="1/6", d2=-1,
                               d3=3))
    prob = threepoint.Problem(4, Fraction(1, 6), -1, 3)
    s = 1 - Fraction(1, 2 ** 30)
    for k, X in ans["X"].items():
        C = prob.objective.get(k)
        ans["X"][k] = [[(C[i][j] if C else 0) + s * (v - (C[i][j] if C
                                                          else 0))
                        for j, v in enumerate(r)] for i, r in enumerate(X)]
    r = threepoint.check(THREEPOINT_P, ans)
    lim = limits("threepoint-4.d6")
    assert r["dual_error"] <= lim["dual_error"] and r["cone"] == 0
    assert r["gap"] > lim["gap"]


@pytest.mark.parametrize("costheta", ["1/2", "12/25", "13/25"])
def test_control_fails_delsarte(costheta):
    p = {"n": 3, "d": 8, "costheta": Fraction(costheta)}
    ans = ipm64.solve(delsarte.dense(p), 100.0, 100.0, gap_threshold=1e-15,
                      error_threshold=1e-12)
    assert 10 < float(ans["y"]["M"]) < 16              # it did solve
    assert fails(delsarte.check(p, ans), limits("delsarte-3.d10"))


@pytest.mark.parametrize("costheta", ["1/6", "4/25", "9/50"])
def test_control_fails_threepoint(costheta):
    p = {"n": 4, "costheta": Fraction(costheta), "d2": -1, "d3": 3}
    ans = ipm64.solve(threepoint.dense(p), 1000.0, 1000.0,
                      gap_threshold=1e-18, error_threshold=1e-15)
    assert fails(threepoint.check(p, ans), limits("threepoint-4.d6"))


def small_cell(**solve):
    c = manifest.cell(ROOT, BENCH, "delsarte-3.d10")
    c.traffic = dict(c.traffic, problem={"d": 2}, instances=1)
    c.config = dict(c.config, solve=dict(c.config["solve"], **solve))
    return c


def test_step_that_returns_its_state_unchanged(monkeypatch):
    from clrs_tpu_torch.solver import step
    real = step.make_run_chunk

    def broken(ds, **kw):
        run = real(ds, **kw)

        def frozen(state, pd_feas, info, nmax):
            # the loop's own buffers, loaded but not stepped; one
            # iteration reported committed
            out = run(state, pd_feas, info, 0)
            out[3].fill_(1)
            return out

        frozen.loop = run.loop
        return frozen

    monkeypatch.setattr(step, "make_run_chunk", broken)
    res, _ = run_cell(small_cell(maxiterations=20), 7, 0.01, False, "cpu",
                      time.perf_counter())
    assert res["failed"] == res["attempted"] >= 1
    assert res["correct"] is False


def test_answer_altered_where_produced(monkeypatch):
    from clrs_tpu_torch.solver import ipm
    from clrs_tpu_torch.utils.hp import DDScalar
    real = ipm._extract

    def altered(*a, **kw):
        dual, primal = real(*a, **kw)
        v = dual.x[0][0]
        dual.x[0][0] = DDScalar(v.hi * (1 + 2.0 ** -40), v.lo)
        return dual, primal

    torch.manual_seed(0)
    res, _ = run_cell(small_cell(), 7, 0.01, False, "cpu",
                      time.perf_counter())
    assert res["correct"] is True and res["failed"] == 0
    monkeypatch.setattr(ipm, "_extract", altered)
    res, _ = run_cell(small_cell(), 7, 0.01, False, "cpu",
                      time.perf_counter())
    assert res["failed"] == 0 and res["correct"] is False
    assert res["checks"]["gap"]["value"] > res["checks"]["gap"]["limit"]
