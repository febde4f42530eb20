"""Shared helpers of the port's tests (tests/test_torch_*.py).

The problem functions take the API module (``clrs_tpu`` or
``clrs_tpu_torch``): a clrs_tpu Problem is not an instance of the port's
Problem class, so both packages build their own from the same function.
This module imports nothing of JAX.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch


def split_words(v, nw):
    """f64 values -> nw f32 word arrays by successive rounding."""
    h = np.asarray(v, np.float64)
    ws = []
    for _ in range(nw):
        w = h.astype(np.float32)
        ws.append(w)
        h = h - w.astype(np.float64)
    return ws


def spd_words(B, n, nw, seed):
    """nw f32 words of B random symmetric positive definite n x n matrices."""
    a = np.random.default_rng(seed).standard_normal((B, n, n))
    return split_words(a @ a.transpose(0, 2, 1) + n * np.eye(n), nw)


@pytest.fixture
def xla_subnormals():
    """Run the port in XLA:CPU's flush-to-zero mode: XLA:CPU flushes f32
    subnormals, eager PyTorch keeps them (as the CUDA kernels do), so
    comparisons of the op sequence with the JAX package flush on both sides.
    Small tensors: one thread, whose MXCSR this sets."""
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def delsarte(api, d):
    """delsarte(3, d, 1/2) (examples/delsarte.py:15-35): SOS blocks of
    sizes d+1 and d, and 2d 1x1 blocks (the scalar pack)."""
    costheta = Fraction(1, 2)
    obj = api.Objective(0, {}, {"M": 1})
    R, x = api.polynomial_ring("x")
    samples = api.sample_points_chebyshev(2 * d, -1, costheta)
    basis = api.basis_chebyshev(2 * d, x)
    sosbasis, samples = api.approximatefekete(basis, samples)
    gp = api.basis_gegenbauer(2 * d, 3, x)
    psd1 = {("a", k): [[gp[k]]] for k in range(1, 2 * d + 1)}
    psd1[("SOS", 1)] = api.LowRankMatPol([1], [sosbasis[: d + 1]])
    psd1[("SOS", 2)] = api.LowRankMatPol([(1 + x) * (costheta - x)],
                                         [sosbasis[:d]])
    psd2 = {("a", k): [[1]] for k in range(1, 2 * d + 1)}
    psd2["slack"] = [[1]]
    return api.Problem(api.Minimize(obj), [
        api.Constraint(-1, psd1, {}, samples),
        api.Constraint(-1, psd2, {"M": -1})])


def dense2(api):
    """max <I/2, X> s.t. X11 = 1, X22 = 2: one dense 2x2 block."""
    half = Fraction(1, 2)
    obj = api.Objective(0, {"X": [[half, 0], [0, half]]}, {})
    return api.Problem(api.Maximize(obj), [
        api.Constraint(1, {"X": [[1, 0], [0, 0]]}),
        api.Constraint(2, {"X": [[0, 0], [0, 1]]})])


def polyopt(api):
    """max lambda s.t. x^2 + 1 - lambda is SOS on [-1, 1] samples
    (examples/polyopt.py); oracle 1."""
    R, x = api.polynomial_ring("x")
    sosbasis = api.basis_chebyshev(1, x)
    samples = api.sample_points_chebyshev(2, -1, 1)
    c = {("sos", 1): api.LowRankMatPol([1], [sosbasis[:2]])}
    return api.Problem(api.Maximize(api.Objective(0, {}, {"lambda": 1})),
                       [api.Constraint(x ** 2 + 1, c, {"lambda": 1},
                                       samples)])
