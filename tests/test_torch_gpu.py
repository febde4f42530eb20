"""Tests of the port that need a CUDA card; they skip without one.

This file imports nothing of JAX, so it also runs where JAX is not
installed. On a machine with a card, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest`` skips tests/conftest.py, which sets JAX up for the other
test files.) ``chip_smoke.py`` runs the same kernel comparisons at the
solver's shapes.
"""

import numpy as np
import pytest
import torch

import clrs_tpu_torch as ct
from clrs_tpu_torch import device as D
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.solver import step as TS
from torch_helpers import delsarte, spd_words, split_words

STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)


def _t(ws, dev):
    return tuple(torch.from_numpy(w).to(dev) for w in ws)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cuda_request_without_card_raises(monkeypatch):
    """device="cuda" without a card raises; nothing drifts to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        D.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        ct.solvesdp(None, device="cuda", verbose=False)
    assert D.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("nw", [5, 6, 7, 8])
def test_kernels_match_plain_on_card(nw, cuda):
    """Every kernel equals its plain version bit for bit on the card, at
    each word count of the f32 ladder."""
    A = _t(spd_words(3, 9, nw, 7), cuda)
    Lk, okk = K.chol_batched(A)
    Lp, okp = K.chol_plain(A)
    assert torch.equal(okk, okp)
    assert all(torch.equal(a, b) for a, b in zip(Lk, Lp))
    Bm = _t(split_words(np.random.default_rng(8).standard_normal((3, 9, 4)),
                        nw), cuda)
    for trans in (False, True):
        xk = K.tri_solve_batched(Lp, Bm, trans)
        xp = K.tri_solve_plain(Lp, Bm, trans)
        assert all(torch.equal(a, b) for a, b in zip(xk, xp))
    L, _ = K.limb_params(nw)
    for side in ("a", "b"):
        lk, ek = K.limb_extract(Bm, L, side)
        lp, ep = K.limb_extract_plain(Bm, L, side)
        assert torch.equal(lk, lp) and torch.equal(ek, ep)
    A3, ea = K.limb_extract_plain(Bm, L, "a")
    B3, eb = K.limb_extract_plain(tuple(c.transpose(1, 2) for c in Bm), L,
                                  "b")
    eab = (ea + eb).expand(3, 9, 9).contiguous()
    gk = K.limb_gemm(A3, B3, eab, nw)
    gp = K.limb_gemm_plain(A3, B3, eab, nw)
    assert all(torch.equal(a, b) for a, b in zip(gk, gp))


@pytest.mark.gpu
def test_wrappers_raise_instead_of_falling_back(cuda):
    """A CUDA operand the kernels do not take raises; it never runs the
    plain version."""
    K.reset_counts()
    with pytest.raises(ValueError):
        K.chol_batched(_t(spd_words(1, 4, 3, 0), cuda))    # nw=3: not built
    with pytest.raises(ValueError):
        K.tri_solve_batched(_t(spd_words(1, 4, 5, 0), cuda),
                            _t(split_words(np.ones((1, 4, 2)), 5), "cpu"))
    assert all(v == 0 for v in K.counts().values())


@pytest.mark.gpu
def test_step_on_card_matches_cpu(cuda):
    """Two steps of delsarte(3,3) on the card (kernels) and on the CPU
    (plain versions) agree at rel 1e-13: the expansion words agree bit for
    bit, the step lengths come from two f64 eigensolvers."""
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, 3))
    rows = {}
    for dev in ("cpu", cuda):
        ds = TS.DeviceSDP(sdp, nw=5, device=dev)
        step = TS.make_step_body(ds, **STEP_KW)
        state, feas, r = TS.initial_state(ds, 100.0, 100.0), False, []
        K.reset_counts()
        for _ in range(2):
            state, info = step(state, feas)
            feas = bool(info["pd_feas"])
            r.append([float(info[k]) for k in ("mu", "d_obj", "p_obj",
                                               "alpha_d", "alpha_p")])
        counts = K.counts()
        on_card = dev != "cpu"
        assert all((counts[f.__name__] > 0) == on_card for f in K._COUNTED)
        assert all((counts[f.__name__] > 0) != on_card for f in K._PLAIN)
        rows[on_card] = r
    for a, b in zip(rows[False], rows[True]):
        assert a == pytest.approx(b, rel=1e-13, abs=1e-18)
