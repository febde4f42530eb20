"""The port's frontend Model (clrs_tpu_torch/frontend/model.py) against the
JAX package's: the same models build the same problem, compared as exact
data; then the port's theta(C5) end to end on the CPU."""

import math
import sys
from fractions import Fraction
from pathlib import Path

import pytest

import clrs_tpu.frontend.model as model_j
import clrs_tpu_torch as ct
import clrs_tpu_torch.examples as examples_t
import clrs_tpu_torch.frontend.model as model_t
from torch_helpers import problem_data

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))


def _free_variable_model(fe):
    """tests/test_frontend.py:48-60: min t s.t. t - x = 1, x >= 0."""
    m = fe.Model()
    t = m.free_variable("t")
    x = m.nonneg_variable("s")
    m.add_constraint(t - x == 1)
    m.minimize(t)
    return m


def _duplicate_term_model(fe):
    """Terms on one entry through both of its aliases, a term repeated in
    one expression, and a constraint given twice (kept once)."""
    m = fe.Model()
    X = m.psd_variable("X", 3)
    y = m.free_variable("y")
    m.add_constraint(X[0, 1] + X[1, 0] + X[0, 1] - y == Fraction(1, 3))
    m.add_constraint(X[0, 0] + X[2, 2] + X[0, 0] == 2)
    m.add_constraint(X[0, 0] + X[2, 2] + X[0, 0] == 2)
    m.maximize(X[1, 2] * 3 + X[2, 1] - y * Fraction(1, 2) + 5)
    return m


def _example_model(name, fe, monkeypatch):
    """theta(C5) or the POVM, built by each package's own example function
    with Model.solve stopped at build_problem."""
    monkeypatch.setattr(fe.Model, "solve",
                        lambda self, **kw: self.build_problem())
    if fe is model_t:
        return getattr(examples_t, name)()
    import theta_povm
    return getattr(theta_povm, name)()


@pytest.mark.parametrize("name", ["lovasz_theta_c5", "povm", "free_variable",
                                  "duplicate_term"])
def test_model_builds_the_jax_problem(name, monkeypatch):
    if name in ("lovasz_theta_c5", "povm"):
        m_t = _example_model(name, model_t, monkeypatch)
        m_j = _example_model(name, model_j, monkeypatch)
    else:
        build = {"free_variable": _free_variable_model,
                 "duplicate_term": _duplicate_term_model}[name]
        m_t, m_j = build(model_t), build(model_j)
    p_t, p_j = m_t.build_problem(), m_j.build_problem()
    assert isinstance(p_t, ct.Problem)
    assert problem_data(p_t) == problem_data(p_j)
    assert len(p_t.constraints) > 0


def test_model_solve_needs_the_card_unless_told():
    """Model.solve defaults to the card, as solvesdp does: without one it
    raises, and nothing drifts to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        _free_variable_model(model_t).solve(verbose=False)


def test_theta_c5_end_to_end_on_cpu():
    """The port's theta(C5) through Model, find_field and exact_solution on
    the CPU at the JAX package's CPU substrate (f64 words; the f32
    substrate's plain versions need 250 iterations and minutes here):
    sqrt(5) within 1e-12, a degree-2 field, an exact value whose square is
    5 (tests/test_frontend.py:18-29)."""
    m = examples_t.lovasz_theta_c5(maxiterations=250, device="cpu",
                                   substrate="f64")
    assert abs(float(m.objective_value()) - math.sqrt(5)) < 1e-12
    FF, g = ct.frontend.find_field(m)
    assert FF.degree == 2
    ok, prob, esol = ct.frontend.exact_solution(m, FF=FF, g=g, verbose=False)
    assert ok
    ev = ct.objvalue(prob, esol)
    assert ev * ev == 5
