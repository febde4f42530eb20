"""The port's SDPA reader (clrs_tpu_torch/model/sdpa.py) against the JAX
package's on tests/fixtures/example.dat-s: the same parsed data and the
same problem; then the port's CPU solve of it."""

import warnings
from pathlib import Path

import numpy as np
import pytest

import clrs_tpu.model.sdpa as sdpa_j
import clrs_tpu_torch as ct
import clrs_tpu_torch.model.sdpa as sdpa_t
from torch_helpers import problem_data

FIXTURE = str(Path(__file__).parent / "fixtures" / "example.dat-s")


def _problem(mod, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return mod.sdpa_sparse_to_problem(FIXTURE, **kw)


def test_sdpa_reader_parses_as_jax():
    m_t, sizes_t, c_t, blocks_t = sdpa_t.read_sdpa_sparse_file(FIXTURE)
    m_j, sizes_j, c_j, blocks_j = sdpa_j.read_sdpa_sparse_file(FIXTURE)
    assert (m_t, list(sizes_t), list(c_t)) == (m_j, list(sizes_j), list(c_j))

    def flat(blocks):
        return [[np.asarray(b, dtype=object).tolist() for b in row]
                for row in blocks]
    assert flat(blocks_t) == flat(blocks_j)


@pytest.mark.parametrize("obj_shift", [0, 3])
def test_sdpa_problem_equals_jax(obj_shift):
    p_t = _problem(sdpa_t, obj_shift=obj_shift)
    p_j = _problem(sdpa_j, obj_shift=obj_shift)
    assert isinstance(p_t, ct.Problem)
    assert problem_data(p_t) == problem_data(p_j)
    assert len(p_t.constraints) == 2 and p_t.maximize
    assert ct.check_problem(p_t)
    assert ct.check_sdp(ct.ClusteredLowRankSDP(p_t))


def test_sdpa_solves_on_cpu():
    """tests/test_sdpa_checks.py:30's solve, on the port's CPU path."""
    st, ds, ps, t, code = ct.solvesdp(
        _problem(sdpa_t), device="cpu", verbose=False, omega_p=100.,
        omega_d=100., dual_error_threshold=1e-12, primal_error_threshold=1e-12)
    assert code == 0 and ct.optimal(st)
    assert np.isfinite(float(ct.objvalue(_problem(sdpa_t), ps)))
