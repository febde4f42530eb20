"""The port's rounding against the JAX package's on delsarte(8, 3, 1/2)
(tests/test_rounding.py:30's settings): the JAX package solves on the CPU,
the solution crosses as plain data into the port's classes, and both
rounders, with the monomial basis of delsarte_round, must give the same
exact solution, 240. Its own file: one JAX compile per file."""

import sys
from fractions import Fraction
from pathlib import Path

import clrs_tpu_torch as ct
from clrs_tpu.round.rounding import (RoundingSettings as RoundingSettings_j,
                                     exact_solution as exact_solution_j)
from clrs_tpu.solver.status import objvalue as objvalue_j
from clrs_tpu_torch.examples import delsarte_exact_problem
from clrs_tpu_torch.state import solution_from_data
from torch_helpers import exact_entries, problem_data, solution_data

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))


def test_delsarte_8_3_rounds_as_jax_does():
    from clrs_tpu import polynomial_ring as polynomial_ring_j
    from delsarte_exact import delsarte_exact as delsarte_exact_j

    obj, problem_j, ds_j, ps_j, code = delsarte_exact_j(
        8, 3, Fraction(1, 2), omega_p=100.0, omega_d=100.0, verbose=False,
        dual_error_threshold=1e-15, primal_error_threshold=1e-15)
    assert code == 0
    problem_t = delsarte_exact_problem(8, 3, Fraction(1, 2))
    assert problem_data(problem_t) == problem_data(problem_j)
    ds_t = solution_from_data(solution_data(ds_j))
    ps_t = solution_from_data(solution_data(ps_j))

    _, x_t = ct.polynomial_ring("x")
    _, x_j = polynomial_ring_j("x")
    ok_t, esol_t = ct.exact_solution(
        problem_t, ds_t, ps_t, settings=ct.RoundingSettings(),
        monomial_bases=[[x_t ** k for k in range(7)]], verbose=False)
    ok_j, esol_j = exact_solution_j(
        problem_j, ds_j, ps_j, settings=RoundingSettings_j(),
        monomial_bases=[[x_j ** k for k in range(7)]], verbose=False)
    assert ok_t and ok_j
    assert exact_entries(esol_t) == exact_entries(esol_j)
    assert ct.objvalue(problem_t, esol_t) == 240
    assert objvalue_j(problem_j, esol_j) == 240
