"""The port's sphere-packing builders and its delsarte wrapper
(clrs_tpu_torch/examples.py) against the JAX package's example scripts
(examples/spherepacking.py, examples/delsarte.py): each builds the same
problem, compared as exact data; the solving ones are stopped at their call
of solvesdp. No JAX computation runs."""

import sys
from fractions import Fraction
from pathlib import Path

import pytest

import clrs_tpu_torch as ct
import clrs_tpu_torch.examples as examples_t
from torch_helpers import built_problem, problem_data

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

HALF = [Fraction(1, 2), Fraction(1, 2)]


def _cohnelkies(d):
    import spherepacking

    return (examples_t.cohnelkies_problem(8, d),
            spherepacking.cohnelkies_problem(8, d))


def _cohnelkies_solving():
    import spherepacking

    return (built_problem(ct, examples_t.cohnelkies, 8, 3),
            built_problem(spherepacking, spherepacking.cohnelkies, 8, 3))


def _nsphere():
    import spherepacking

    return (built_problem(ct, examples_t.Nsphere_packing, 8, 15, HALF, 2),
            built_problem(spherepacking, spherepacking.Nsphere_packing, 8,
                          15, HALF, 2))


def _delsarte():
    import delsarte

    return (built_problem(ct, examples_t.delsarte, 3, 10, Fraction(1, 2)),
            built_problem(delsarte, delsarte.delsarte, 3, 10,
                          Fraction(1, 2)))


@pytest.mark.parametrize("build", [lambda: _cohnelkies(3),
                                   lambda: _cohnelkies(15),
                                   _cohnelkies_solving, _nsphere, _delsarte],
                         ids=["cohnelkies_problem_8_3",
                              "cohnelkies_problem_8_15", "cohnelkies_8_3",
                              "Nsphere_packing_8_15", "delsarte_3_10"])
def test_builder_matches_jax_script(build):
    p_t, p_j = build()
    assert isinstance(p_t, ct.Problem)
    assert problem_data(p_t) == problem_data(p_j)


@pytest.mark.parametrize("n, r", [(8, Fraction(1, 2)), (8, 1), (3, 2),
                                  (24, Fraction(3, 7))])
def test_spherevolume_matches_jax(n, r):
    import spherepacking

    v_t, v_j = examples_t.spherevolume(n, r), spherepacking.spherevolume(n, r)
    assert type(v_t) is type(v_j) and v_t == v_j and str(v_t) == str(v_j)
