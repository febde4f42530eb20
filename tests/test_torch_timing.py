"""The port's per-phase timing (clrs_tpu_torch/solver/timing.py) and
``solvesdp(testing=True)`` on the CPU: the JAX module's eight keys, each
phase run and timed on delsarte(3,4) on both substrates, and the table
printed after a solve. Imports nothing of JAX (the keys are read from the
JAX module's source)."""

import ast
from fractions import Fraction
from pathlib import Path

import pytest

import clrs_tpu_torch as ct
from clrs_tpu_torch.examples import delsarte_problem
from clrs_tpu_torch.solver import step as TS
from clrs_tpu_torch.solver.ipm import word_count, word_count_f64
from clrs_tpu_torch.solver.timing import phase_breakdown

ROOT = Path(__file__).resolve().parent.parent
SUBSTRATES = {"f32": (TS.F32, word_count(None)),
              "f64": (TS.F64, word_count_f64(None))}


def _jax_keys():
    """The keys of the dict clrs_tpu/solver/timing.py::phase_breakdown
    returns, in order."""
    tree = ast.parse((ROOT / "clrs_tpu/solver/timing.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "phase_breakdown")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return [k.value for k in ret.value.keys]


@pytest.fixture(scope="module")
def problem():
    return delsarte_problem(3, 4, Fraction(1, 2))


@pytest.mark.parametrize("substrate", sorted(SUBSTRATES))
def test_phase_breakdown(problem, substrate):
    dtype, nw = SUBSTRATES[substrate]
    ds = TS.DeviceSDP(ct.ClusteredLowRankSDP(problem), nw=nw, device="cpu",
                      dtype=dtype)
    state = TS.initial_state(ds, 100.0, 100.0)
    bd = phase_breakdown(ds, state, reps=1)
    assert list(bd) == _jax_keys() and len(bd) == 8
    assert all(v > 0 for v in bd.values()), bd


def test_solvesdp_testing_prints_the_table(problem, capsys):
    ct.solvesdp(problem, device="cpu", verbose=False, testing=True,
                maxiterations=2, omega_p=100.0, omega_d=100.0)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("timing: total ") and "over 2 iterations" \
        in out[0]
    assert out[1].split() == ["phase", "ms/call", "share"]
    rows = {ln[:30].strip() for ln in out[2:10]}
    assert rows == set(_jax_keys())
    assert out[10].startswith("sum of phases")
