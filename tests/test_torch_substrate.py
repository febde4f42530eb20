"""solvesdp(substrate=None), the pick by platform (clrs_tpu_torch/solver/
ipm.py::pick_substrate), on the CPU (no JAX in this file): the CPU takes
the f64 words, as the JAX package does off the TPU, word for word the
solve at substrate="f64"; the card takes f32, the substrate
torch_bench.py measured faster there (decided without a card: the pick
reads only the device's type)."""

from fractions import Fraction

import pytest

import clrs_tpu_torch as ct
from clrs_tpu_torch.examples import delsarte_problem
from clrs_tpu_torch.solver.ipm import pick_substrate
from torch_helpers import solution_data


def _three_iterations(substrate):
    problem = delsarte_problem(3, 10, Fraction(1, 2))
    status, dual, primal, _, code = ct.solvesdp(
        problem, device="cpu", substrate=substrate, maxiterations=3,
        omega_p=100.0, omega_d=100.0, verbose=False)
    return (type(status).__name__, code, solution_data(dual),
            solution_data(primal))


def test_none_on_the_cpu_is_f64_word_for_word():
    assert _three_iterations(None) == _three_iterations("f64")


@pytest.mark.parametrize("device, want", [
    ("cpu", "f64"), ("cuda", "f32"), ("cuda:0", "f32")])
def test_pick_by_platform(device, want):
    assert pick_substrate(None, device) == want


@pytest.mark.parametrize("substrate", ["f32", "f64"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_a_named_substrate_is_kept(substrate, device):
    assert pick_substrate(substrate, device) == substrate
