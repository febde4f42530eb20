"""The sphere-packing oracles at d 15 of tests/test_solver_examples.py
(:69-104) on the card, with those tests' settings: f64 words at prec 212
(nw 4). Each takes minutes there (the f64 substrate at nw 4 is PyTorch
expansion ops, ROADMAP A item 10), so chip_smoke.py leaves them to this
file. They skip without a card; this file imports nothing of JAX. On a
machine with a card, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_examples.py -q -s

The objective is held to pi^4/384 within 1e-4, the reference's own
contract (test/runtests_solver.jl:19-22). The end is held to the JAX
package's own: on the CPU, clrs_tpu at these settings ends both solves
with code 1 and the dual feasible (chol(S) fails once mu is near 1e-16 to
1e-20, the primal error stalled far above its 1e-20 threshold;
cohnelkies(8, 15) after 69 iterations, Nsphere_packing after 61, the
objectives 7.09e-5 from pi^4/384), as PARITY.md's literal-defaults table
describes for cohnelkies. So code 0 with Optimal, or code 1 with the dual
feasible, passes.
"""

import math
import time
from fractions import Fraction

import pytest
import torch

import clrs_tpu_torch as ct
from clrs_tpu_torch.examples import Nsphere_packing, cohnelkies

PI4_384 = math.pi ** 4 / 384
SETTINGS = dict(prec=212, substrate="f64", omega_p=100.0, omega_d=100.0,
                duality_gap_threshold=1e-7, dual_error_threshold=1e-20,
                primal_error_threshold=1e-20, verbose=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("solve", [
    lambda **kw: cohnelkies(8, 15, **kw),
    lambda **kw: Nsphere_packing(8, 15, [Fraction(1, 2), Fraction(1, 2)], 2,
                                 **kw)],
    ids=["cohnelkies_8_15", "Nsphere_packing_8_15"])
def test_sphere_packing_d15_on_card(solve, cuda):
    its = []
    t0 = time.time()
    problem, status, _, primalsol, code = solve(
        callback=lambda it, info: its.append((it, time.time())), **SETTINGS)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    v = float(ct.objvalue(problem, primalsol))
    n_it = its[-1][0] if its else 0
    later = ((its[-1][1] - its[0][1]) / max(its[-1][0] - its[0][0], 1)
             if len(its) > 1 else float("nan"))
    print(f"\n{torch.cuda.get_device_name(0)}: code {code}, status {status},"
          f" iterations {n_it}, {seconds:.2f} s with the host build and the "
          f"capture, {later:.4f} s/iteration after the first, objective "
          f"{v!r}, |objective - pi^4/384| {abs(v - PI4_384):.3e}")
    assert abs(v - PI4_384) < 1e-4
    assert (code, str(status)) in ((0, "pdOpt"), (1, "dFeas"))
