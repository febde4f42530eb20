"""The port's device loop (clrs_tpu_torch.solver.step.make_run_chunk)
against the JAX package's (clrs_tpu.solver.step.make_run_chunk) on the
CPU: polyopt, the JAX package's default CPU substrate (IEEE f64 double
words) against the port's f32 nw=5 words, both carrying about 106 bits.

Per chunk, it_done, the code, done and pd_feas are equal exactly, and
(mu, d_obj, p_obj, alpha_d, alpha_p) of the last committed step agree at
rel 1e-13, abs 1e-18 (the contract of test_slice_matches_jax_f64_steps).
One set of thresholds (one JAX compile, about 45 s) and three starting
points give chunks that end each way: a chunk of one, then termination
in the middle of a chunk of three; a failing Cholesky (X = -I) in the
first step (code 1); mu above ``max_complementary_gap`` after one
committed step (code 3). Starting points whose steps reach a Cholesky
pivot near zero (X or Y at 1e-6 I with the other at 100 I) fail at
different steps in the two substrates, so they are not compared here.
tests/test_torch_chunk_codes.py holds code 4 (a second compile).
"""

import pytest

import clrs_tpu as jc
from clrs_tpu.solver import step as JS
from torch_helpers import assert_chunks_match_jax, polyopt

STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)
CHUNK_KW = dict(STEP_KW, duality_gap_threshold=0.5,
                max_complementary_gap=1e3)

# (omega_p, omega_d), the chunks' nmax, and per chunk (it_done, code, done)
CASES = {
    "nmax1_then_3_terminates_mid_chunk":
        ((1.0, 1.0), (1, 3), [(1, 0, False), (1, 0, True)]),
    "code1_first_step": ((-1.0, 100.0), (3,), [(0, 1, True)]),
    "code3_after_one_step": ((100.0, 100.0), (3,), [(1, 3, True)]),
}


@pytest.fixture(scope="module")
def jax_chunk():
    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(polyopt(jc)))
    return dj, JS.make_run_chunk(dj, **CHUNK_KW)


@pytest.mark.parametrize("case", list(CASES))
def test_run_chunk_matches_jax_f64(case, jax_chunk):
    assert_chunks_match_jax(JS, *jax_chunk, CHUNK_KW, *CASES[case])
