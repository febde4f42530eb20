"""Sharded steps on the card (clrs_tpu_torch.parallel); they skip without
one. No JAX import. On a machine with a card, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_parallel.py -q

- One NCCL rank (world size 1) runs delsarte(3,31)'s big cluster (P = 64)
  by row panels: two steps within rel 1e-8 of the one-process card step
  (the JAX package's f32 tolerance for row panels).
- Two gloo rank processes on the one card (words staged through host
  memory) against two gloo rank processes on the CPU, delsarte(3,4)'s
  class and scalar-pack axes: the ranks agree exactly among themselves,
  and with the CPU ranks at rel 1e-13 (the card's eigensolver is not the
  CPU's; tests/test_torch_gpu.py::test_step_on_card_matches_cpu).
"""

import pytest
import torch
import torch.distributed as dist

import clrs_tpu_torch as ct
from torch_helpers import delsarte, run_ranks, steps

INFO_KEYS = ("mu", "d_obj", "p_obj", "alpha_d", "alpha_p")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_nccl_row_panel_steps_match_one_process(cuda, tmp_path):
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, 31))
    ref, _ = steps(sdp, 5, torch.float32, 1, False, 0, n=2, device="cuda")
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        got, _ = steps(sdp, 5, torch.float32, 1, True, 1, n=2,
                       device="cuda")
    finally:
        dist.destroy_process_group()
    for i0, i1 in zip(ref, got):
        assert i1["ok"]
        for k in INFO_KEYS:
            assert i1[k] == pytest.approx(i0[k], rel=1e-8, abs=1e-8), k


@pytest.mark.gpu
def test_gloo_ranks_on_card_match_cpu_ranks(cuda, tmp_path):
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, 4))
    out = {}
    for dev in ("cuda", "cpu"):
        (tmp_path / dev).mkdir()
        out[dev] = run_ranks(tmp_path / dev, 2, "steps", sdp, 5,
                             torch.float32, 2, False, 2, 1, dev)
    for dev, ranks in out.items():
        assert all(r[0] == ranks[0][0] for r in ranks), dev
    for k in INFO_KEYS:
        assert out["cuda"][0][0][0][k] == pytest.approx(
            out["cpu"][0][0][0][k], rel=1e-13, abs=1e-18), k
