"""The port's benchmark script (torch_bench.py) on the CPU, against the JAX
package's bench.py where both count.

- count_step_macs: the int8 ops of one delsarte(3,10) step at f32 nw 5
  equal bench.count_step_macs on the JAX package's DeviceSDP (every GEMM
  there takes the split route in both packages, so to the op).
- The MAC counter of fx_matmul on the fused route: the closed form over
  the limb pairs of the kept diagonals, times the explicit batch, and the
  JAX package's count for the same shape traced with its fused route on
  (jax.eval_shape; clrs_tpu.dd.limb_gemm._USE_PLFUSED set and restored).
- bench_problem commits every timed iteration with code 0 on both
  substrates; main() refuses to run without a card. The counters are
  None after every call.
"""

import sys
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clrs_tpu as jc
import clrs_tpu_torch as ct
from clrs_tpu.dd import limb_gemm as JLG
from clrs_tpu.solver import step as JS
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.dd import limb_gemm as TLG
from clrs_tpu_torch.dd import slice_gemm as TSG
from clrs_tpu_torch.examples import delsarte_problem
from clrs_tpu_torch.solver import step as TS
from torch_helpers import delsarte, split_words

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import bench  # noqa: E402  (the JAX package's benchmark)
import torch_bench  # noqa: E402


@pytest.fixture(autouse=True)
def counters_off_after():
    yield
    assert TLG._MAC_COUNTER is None and TSG._OP_COUNTER is None
    assert JLG._MAC_COUNTER is None


def test_count_step_macs_matches_jax():
    dj = JS.DeviceSDP(jc.ClusteredLowRankSDP(delsarte(jc, 10)), nw=5,
                      dtype=jnp.float32)
    want = bench.count_step_macs(dj, **torch_bench.STEP_KW)
    dt = TS.DeviceSDP(ct.ClusteredLowRankSDP(
        delsarte_problem(3, 10, Fraction(1, 2))), nw=5, device="cpu")
    got = torch_bench.count_step_macs(dt, **torch_bench.STEP_KW)
    assert got == want > 0


def _fused_pairs(L, ndiag):
    """Limb pairs (i, j), 0 <= i, j < L, on the diagonals i + j < ndiag."""
    return sum(1 for i in range(L) for j in range(L) if i + j < ndiag)


@pytest.mark.parametrize("nw", [5, 8])
def test_fused_route_count_closed_form_and_jax(nw, monkeypatch):
    B, m, k, n = 2, 128, 8, 128
    L, ndiag = K.limb_params(nw)
    assert TLG.gemm_route(m, k, n, nw) == "fused"
    rng = np.random.default_rng(nw)
    a = split_words(rng.standard_normal((B, m, k)), nw)
    b = split_words(rng.standard_normal((B, k, n)), nw)
    TLG._MAC_COUNTER = []
    try:
        TLG.fx_matmul(tuple(torch.from_numpy(w) for w in a),
                      tuple(torch.from_numpy(w) for w in b))
        got = TLG._MAC_COUNTER
    finally:
        TLG._MAC_COUNTER = None
    assert got == [2 * _fused_pairs(L, ndiag) * B * m * n * k]

    monkeypatch.setattr(JLG, "_USE_PLFUSED", True)
    JLG._MAC_COUNTER = []
    try:
        with JLG.mac_scale(B):
            jax.eval_shape(lambda x, y: JLG.fx_matmul(x, y),
                           tuple(jnp.asarray(w[0]) for w in a),
                           tuple(jnp.asarray(w[0]) for w in b))
        want = JLG._MAC_COUNTER
    finally:
        JLG._MAC_COUNTER = None
    assert got == want


@pytest.mark.parametrize("substrate", ["f32", "f64"])
def test_bench_problem_commits_every_iteration(substrate):
    r = torch_bench.bench_problem(delsarte_problem(3, 4, Fraction(1, 2)),
                                  n_iters=2, substrate=substrate,
                                  device="cpu", reps=1, report_mfu=True)
    assert (r["device"], r["substrate"], r["nw"], r["n_iters"]) == \
        ("cpu", substrate, 5 if substrate == "f32" else 2, 2)
    kind = "int8" if substrate == "f32" else "f64"
    assert r[f"{kind}_ops_per_iter"] > 0
    assert r["iterations_per_s"] > 0 and r["capture_s"] > 0
    # the MFU is a rate of the card: never computed from a CPU run
    assert not any(key.startswith("mfu") for key in r)


def test_main_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_bench.main()
