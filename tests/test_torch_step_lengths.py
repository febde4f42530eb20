"""The step lengths alpha = -gamma / lambda_min (solver/step.py
::_step_lengths) round once, as the reference's -gamma / min_d
(clrs_tpu/solver/step.py:1211-1212): equal to numpy's IEEE division bit
for bit on both substrates. A host float over a tensor is
reciprocal() * float in PyTorch, two roundings."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from clrs_tpu_torch.solver.step import _step_lengths

F64 = torch.float64


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("gamma", [0.9, 0.1])
def test_step_lengths_divide_once(gamma, dtype):
    # one class of two members (L 1): lambda_min of the X member gives
    # alpha_d, of the Y member alpha_p; eig_safety 0 keeps lambda itself
    ds = SimpleNamespace(dtype=dtype, comm=None, clusters=[SimpleNamespace(
        classes=[SimpleNamespace(n=2, L=1)], s_nb=0)])
    inf = torch.full((), float("inf"), dtype=F64)
    one = torch.full((), 1.0, dtype=F64)
    rng = np.random.default_rng(int(gamma * 10) + dtype.itemsize)
    mins = -np.exp(rng.uniform(np.log(gamma), np.log(1e6), (2000, 2)))
    got = np.empty_like(mins)
    for i, (md, mp) in enumerate(mins):
        lam = torch.tensor([md, mp], dtype=F64)
        a_d, a_p = _step_lengths(ds, None, None, None, None, None, [lam],
                                 [torch.zeros(2, dtype=torch.bool)], gamma,
                                 0.0, inf, one)
        got[i] = (a_d.item(), a_p.item())
    want = np.where(mins > -gamma, 1.0, np.float64(-gamma) / mins)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
