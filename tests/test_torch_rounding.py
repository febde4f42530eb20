"""The port's rounding (clrs_tpu_torch.round) against the JAX package's
on one solution: the JAX package solves the Goemans-Williamson 3-cycle on
the CPU (tests/test_rounding.py:15's settings), the solution crosses as
plain data (clrs_tpu_torch.state.solution_from_data) into the port's
classes, and both rounders must give the same exact solution, 9/4."""

import sys
from fractions import Fraction
from pathlib import Path

import clrs_tpu_torch as ct
from clrs_tpu.round.rounding import exact_solution as exact_solution_j
from clrs_tpu.solver.status import objvalue as objvalue_j
from clrs_tpu_torch.examples import goemans_williamson
from clrs_tpu_torch.state import solution_from_data
from torch_helpers import (built_problem, exact_entries, problem_data,
                           solution_data)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

L3 = [[2, -1, -1], [-1, 2, -1], [-1, -1, 2]]


def test_maxcut_rounds_as_jax_does():
    from maxcut import goemans_williamson as gw_j

    problem_j, status, ds_j, ps_j, code = gw_j(
        L3, omega_p=100.0, omega_d=100.0, verbose=False, eps=1e-18,
        dual_error_threshold=1e-15, primal_error_threshold=1e-15)
    assert code == 0
    ds_t = solution_from_data(solution_data(ds_j))
    ps_t = solution_from_data(solution_data(ps_j))
    assert isinstance(ds_t, ct.solver.status.DualSolution)
    assert isinstance(ps_t, ct.PrimalSolution)
    assert solution_data(ds_t) == solution_data(ds_j)
    assert solution_data(ps_t) == solution_data(ps_j)

    # the port's own problem from its builder, equal to the JAX one as
    # exact data
    problem_t = built_problem(ct, goemans_williamson, L3)
    assert problem_data(problem_t) == problem_data(problem_j)

    ok_t, esol_t = ct.exact_solution(problem_t, ds_t, ps_t, verbose=False)
    ok_j, esol_j = exact_solution_j(problem_j, ds_j, ps_j, verbose=False)
    assert ok_t and ok_j
    assert exact_entries(esol_t) == exact_entries(esol_j)
    assert ct.objvalue(problem_t, esol_t) == Fraction(9, 4)
    assert objvalue_j(problem_j, esol_j) == Fraction(9, 4)
    assert ct.matrixvar(esol_t, "X")[0, 1] == Fraction(-1, 2)
