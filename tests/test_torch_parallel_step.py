"""The port's sharded IPM step over 2 and 4 gloo rank processes on the
CPU (tests/torch_helpers.py::run_ranks: one thread each, a FileStore in
tmp_path), against the one-process port step on the same DeviceSDP.

- The cluster axis (multi_cluster_test_problem(8, 4): one group of J = 8
  clusters) and the class and scalar-pack axes (delsarte(3,4) padded with
  mesh_divisor): every rank's first step, its info and the whole state
  gathered from the ranks, equals the one-process step word for word. The
  step all-gathers the per-block terms of every contracted axis and
  reduces them in the one-process order, so nothing less is expected.
- Row panels (one big cluster, parallel/bigcluster.py): two steps of
  delsarte(3,15) (P = 32, 8 rows a rank) on f32 nw 5 within rel 1e-8, and
  of delsarte(3,31) (P = 64) on f64 nw 2 within rel 1e-10, of the
  one-process step: the blocked distributed Cholesky differs from the
  one-process factorization by per-GEMM roundings, and these are the JAX
  package's own tolerances (tests/test_sharding.py:169-212).
"""

import numpy as np
import pytest
import torch

import clrs_tpu_torch as ct
from clrs_tpu_torch.parallel import api as TA
from clrs_tpu_torch.solver import step as TS
from torch_helpers import delsarte, run_ranks, steps

INFO_KEYS = ("mu", "dual_error", "primal_error", "dual_gap", "alpha_d",
             "alpha_p", "d_obj", "p_obj")


def _one_process(*args, **kw):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # as in the ranks
    try:
        return steps(*args, **kw)
    finally:
        torch.set_num_threads(threads)


def _problem(name):
    if name == "cluster":
        return ct.ClusteredLowRankSDP(TA.multi_cluster_test_problem(8, 4))
    return ct.ClusteredLowRankSDP(delsarte(ct, 4))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name,axes", [
    ("cluster", [(True, False, [True])]),
    ("class_scalar", [(False, True, [True])])])
def test_first_step_word_for_word_on_every_rank(name, axes, world,
                                                tmp_path):
    sdp = _problem(name)
    ds = TS.DeviceSDP(sdp, nw=5, device="cpu", mesh_divisor=world)
    assert TA.shard_plan(ds, world) == axes
    info0, words0 = _one_process(sdp, 5, torch.float32, world, False, 0)
    ranks = run_ranks(tmp_path, world, "steps", sdp, 5, torch.float32,
                      world, False, world)
    for r, (info, words) in enumerate(ranks):
        assert info == info0, r
        assert len(words) == len(words0)
        for i, (a, b) in enumerate(zip(words0, words)):
            assert a.shape == b.shape and np.array_equal(
                a.view(np.uint32), b.view(np.uint32)), (r, i)


@pytest.mark.parametrize("d,nw,dtype,tol", [
    (15, 5, torch.float32, 1e-8), (31, 2, torch.float64, 1e-10)],
    ids=["f32_P32", "f64_P64"])
def test_row_panels_within_jax_tolerance(d, nw, dtype, tol, tmp_path):
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, d))
    ds = TS.DeviceSDP(sdp, nw=nw, device="cpu", dtype=dtype)
    assert ds.clusters[0].J == 1 and ds.clusters[0].nrows == d * 2 + 2
    infos0, _ = _one_process(sdp, nw, dtype, 1, False, 0, n=2)
    ranks = run_ranks(tmp_path, 4, "steps", sdp, nw, dtype, 1, True, 4, 2)
    for r, (infos, _) in enumerate(ranks):
        assert infos == ranks[0][0], r       # the ranks agree exactly
        for i0, i1 in zip(infos0, infos):
            assert i1["ok"]
            for k in INFO_KEYS:
                assert abs(i1[k] - i0[k]) <= tol * max(1.0, abs(i0[k])), \
                    (r, k, i0[k], i1[k])
