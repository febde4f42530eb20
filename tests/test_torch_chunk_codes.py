"""The port's make_run_chunk against the JAX package's where a step is too
short (code 4), with a second set of thresholds (a second JAX compile,
kept apart from tests/test_torch_chunk.py so that the two compiles run on
different workers). ``step_length_threshold`` lies between the step
lengths 1 and 0.9999999999978888 that polyopt's steps take, so a chunk
from (1, 1) commits one step and stops at the second; from (100, 100) the
first step (0.909...) is already too short.
"""

import pytest

import clrs_tpu as jc
from clrs_tpu.solver import step as JS
from torch_helpers import assert_chunks_match_jax, polyopt

STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)
CHUNK_KW = dict(STEP_KW, duality_gap_threshold=1e-15,
                step_length_threshold=0.99999999999999)

CASES = {
    "code4_first_step": ((100.0, 100.0), (3,), [(0, 4, True)]),
    "code4_after_one_step": ((1.0, 1.0), (3,), [(1, 4, True)]),
}


@pytest.fixture(scope="module")
def jax_chunk():
    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(polyopt(jc)))
    return dj, JS.make_run_chunk(dj, **CHUNK_KW)


@pytest.mark.parametrize("case", list(CASES))
def test_run_chunk_code4_matches_jax_f64(case, jax_chunk):
    assert_chunks_match_jax(JS, *jax_chunk, CHUNK_KW, *CASES[case])
