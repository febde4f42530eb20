"""The port's problem builders (clrs_tpu_torch/examples.py) against the
JAX package's example scripts (examples/*.py): each builds the same
problem, compared as exact data. The builders that solve are stopped at
their call of solvesdp; no JAX computation runs."""

import sys
from fractions import Fraction
from pathlib import Path

import pytest

import clrs_tpu_torch as ct
import clrs_tpu_torch.examples as examples_t
from torch_helpers import built_problem, problem_data

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

L3 = [[2, -1, -1], [-1, 2, -1], [-1, -1, 2]]
THREE_POINT = (4, Fraction(1, 6), -1, 4)


def _maxcut():
    import maxcut

    return (built_problem(ct, examples_t.goemans_williamson, L3),
            built_problem(maxcut, maxcut.goemans_williamson, L3))


def _three_point():
    import threepoint

    return (examples_t.three_point_problem(*THREE_POINT),
            threepoint.three_point_problem(*THREE_POINT))


def _three_point_codes():
    import threepoint

    return (built_problem(ct, examples_t.three_point_spherical_codes,
                          *THREE_POINT),
            built_problem(threepoint, threepoint.three_point_spherical_codes,
                          *THREE_POINT))


@pytest.mark.parametrize("build", [_maxcut, _three_point, _three_point_codes],
                         ids=["goemans_williamson", "three_point_problem",
                              "three_point_spherical_codes"])
def test_builder_matches_jax_script(build):
    p_t, p_j = build()
    assert isinstance(p_t, ct.Problem)
    assert problem_data(p_t) == problem_data(p_j)
