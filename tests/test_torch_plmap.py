"""The port's three chain kernels (clrs_tpu_torch.dd.kernels.plmap_*) against
the JAX package's pl_map of the same functions, on the CPU.

The JAX side is ``clrs_tpu.dd.pallas_linalg.pl_map`` run in the Pallas
interpreter (as tests/test_plmap.py runs it) on the functions of its three
call sites in clrs_tpu/solver/step.py; the port side is each kernel's plain
version. Both are the same IEEE f32 op sequence, so the tolerance is bit
identity, with the port in XLA:CPU's subnormal flush mode. At nw = 8 the
interpreter needs minutes to compile the axpy chain and the corrector
residual (its exp_mul and two exp_sub at eight words), so those two cases
hold the plain version against the same function compiled by XLA, which
pl_map runs unchanged inside its kernel (tests/test_plmap.py:55-69). The
step-level check holds four port steps in the chain-kernel form against
four in the plain form at rel 1e-13, the JAX package's own bound for its
fused and unfused steps (tests/test_plmap.py:115-117).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clrs_tpu_torch as ct
from clrs_tpu.dd import expops as E
from clrs_tpu.dd import pallas_linalg as P
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.solver import step as TS
from torch_helpers import delsarte, split_words, xla_subnormals  # noqa: F401

L, N = 2, 5


def _jax_axpy(nw):
    # clrs_tpu/solver/step.py:1251-1253
    def f(x, d, a):
        z = a[0] * np.float32(0.0)
        return E.exp_add(x, E.exp_mul(d, a + (z,) * (nw - len(a))))
    return f


def _jax_residual(mu, eye, mask, xy, *dxdy):
    # clrs_tpu/solver/step.py:1396-1401
    muI = tuple(mw * eye[0] for mw in mu)
    r = E.exp_sub(muI, xy)
    if dxdy:
        r = E.exp_sub(r, dxdy[0])
    return tuple(c * mask[0] for c in r)


def _operands(nw, seed):
    rng = np.random.default_rng(seed)
    x = split_words(rng.standard_normal((L, N, N))
                    * 10.0 ** rng.integers(-3, 3, (L, N, N)), nw)
    d = split_words(rng.standard_normal((L, N, N)) * 1e-2, nw)
    mu = split_words(rng.standard_normal((L, 1, 1)) * 1e3, nw)
    alpha = split_words(np.full((L, 1, 1), 0.9130357142857143), 3)
    mask = np.ones((L, N, N), np.float32)
    mask[1, -1, :] = mask[1, :, -1] = 0.0          # a padded member
    return x, d, mu, alpha, mask


def _j(ws):
    return tuple(jnp.asarray(w) for w in ws)


def _t(ws):
    return tuple(torch.from_numpy(np.array(w)) for w in ws)


def _same(rj, rt):
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape, (a.shape, b.shape)
        assert np.array_equal(a, b), np.max(np.abs(a.astype(np.float64)
                                                   - b.astype(np.float64)))


def _run(fn, nw, args, interpret):
    if interpret:
        return P.pl_map(fn, nw, args)
    return jax.jit(fn)(*args)


@pytest.mark.parametrize("nw", [5, 8])
@pytest.mark.parametrize("chain", ["add", "axpy", "residual",
                                   "residual_corr"])
def test_chain_plain_bit_identical_to_pl_map(chain, nw, xla_subnormals):
    x, d, mu, alpha, mask = _operands(nw, seed=nw)
    interpret = not (nw == 8 and chain in ("axpy", "residual_corr"))
    if chain == "add":
        rj = P.pl_map(lambda a, b: E.exp_add(a, b), nw, [_j(x), _j(d)])
        _same(rj, K.plmap_add_plain(_t(x), _t(d)))
        # a [L, 1, 1] scalar first: the output takes the broadcast shape
        rj = P.pl_map(lambda a, b: E.exp_add(a, b), nw, [_j(mu), _j(x)])
        _same(rj, K.plmap_add_plain(_t(mu), _t(x)))
    elif chain == "axpy":
        rj = _run(_jax_axpy(nw), nw, [_j(x), _j(d), _j(alpha)], interpret)
        _same(rj, K.plmap_axpy_plain(_t(x), _t(d), _t(alpha)))
    else:
        eye = (jnp.broadcast_to(jnp.eye(N, dtype=jnp.float32), (L, N, N)),)
        args = [_j(mu), eye, (jnp.asarray(mask),), _j(x)]
        corr = None
        if chain == "residual_corr":
            args.append(_j(d))
            corr = _t(d)
        rj = _run(_jax_residual, nw, args, interpret)
        _same(rj, K.plmap_residual_plain(_t(mu), torch.from_numpy(mask),
                                         _t(x), corr))


def test_steps_in_chain_form_match_plain_form():
    """Four port steps with the chain kernels (the default) against four
    with the plain expansion ops, delsarte(3,3), at rel 1e-13; the chain
    form really ran its kernels' plain versions."""
    sdp = ct.ClusteredLowRankSDP(delsarte(ct, 3))
    kw = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
              dual_error_threshold=1e-12, primal_error_threshold=1e-12)
    rows = {}
    for plmap in (True, False):
        ds = TS.DeviceSDP(sdp, nw=5, device="cpu")
        step = TS.make_step_body(ds, plmap=plmap, **kw)
        state, feas, r = TS.initial_state(ds, 100.0, 100.0), False, []
        K.reset_counts()
        for _ in range(4):
            state, info = step(state, feas)
            feas = bool(info["pd_feas"])
            assert bool(info["ok"])
            r.append([float(info[k]) for k in ("mu", "d_obj", "p_obj",
                                               "alpha_d", "alpha_p")])
        rows[plmap] = r
        chains = [K.counts()[f.__name__] for f in (
            K.plmap_add_plain, K.plmap_axpy_plain, K.plmap_residual_plain)]
        assert all((c > 0) == plmap for c in chains), chains
    for a, b in zip(rows[True], rows[False]):
        assert a == pytest.approx(b, rel=1e-13, abs=1e-18), (a, b)
