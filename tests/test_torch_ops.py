"""The port's expansion ops (clrs_tpu_torch.dd.ops) against the JAX
package's barrier-free forms (clrs_tpu.dd.expops), on the CPU.

add/sub/mul/mul_f32/mul_pow2/div must be bit-identical: both sides are
the same IEEE f32 op sequence. rsqrt/sqrt are held to 2^-(24*nw-8)
relative (no finer than the f32 floor allows), because the JAX Newton seed
is lax.rsqrt and the port's is the IEEE 1/sqrt(x) that its CUDA kernels
also compute.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clrs_tpu.dd import expops as E
from clrs_tpu_torch.dd import ops as T
from torch_helpers import split_words, xla_subnormals  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _operands(nw, seed, n=96):
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.choice([-30, -8, -1, 0, 3, 12, 30], n)
    x = rng.standard_normal(n) * mags
    y = rng.standard_normal(n) * 10.0 ** rng.choice([-30, -3, 0, 5, 30], n)
    # exact ties and cancellations
    x[:4] = [1.0, -2.5, 3.0, 1e-30]
    y[:4] = [-1.0, 2.5, 3.0, -1e-30]
    return split_words(x, nw), split_words(y, nw)


def _j(ws):
    return tuple(jnp.asarray(w) for w in ws)


def _t(ws):
    return tuple(torch.from_numpy(np.array(w)) for w in ws)


def _same(rj, rt):
    assert len(rj) == len(rt)
    for a, b in zip(rj, rt):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b, equal_nan=True), np.nanmax(np.abs(a - b))


@pytest.mark.parametrize("nw", [3, 5, 8])
def test_ops_bit_identical_to_expops(nw, xla_subnormals):
    xs, ys = _operands(nw, seed=nw)
    X, Y = _j(xs), _j(ys)
    tX, tY = _t(xs), _t(ys)
    _same(E.exp_add(X, Y), T.exp_add(tX, tY))
    _same(E.exp_sub(X, Y), T.exp_sub(tX, tY))
    _same(E.exp_mul(X, Y), T.exp_mul(tX, tY))
    _same(E.exp_mul_f32(X, Y[0]), T.exp_mul_f32(tX, tY[0]))
    _same(E.exp_mul_f32(X, np.float32(-0.5)), T.exp_mul_f32(tX, -0.5))
    e = np.random.default_rng(7).integers(-300, 300, xs[0].shape)
    e = e.astype(np.int32)
    _same(E.exp_mul_pow2(X, jnp.asarray(e)),
          T.exp_mul_pow2(tX, torch.from_numpy(e)))
    # divisor away from zero in its leading word
    _same(E.exp_div(X, Y), T.exp_div(tX, tY))
    _same(E.exp_scale_f64(X, 1.0 / 3.0), T.exp_scale_f64(tX, 1.0 / 3.0))
    _same(E.quick_two_sum(X[0], X[1]), T.quick_two_sum(tX[0], tX[1]))
    _same(E.two_prod(X[0], Y[0]), T.two_prod(tX[0], tY[0]))


def test_port_keeps_subnormals_reference_flushes():
    """The subnormal hazard: the port keeps IEEE subnormals by default, so
    two_prod stays error-free below 2^-126, where the JAX CPU reference
    flushes the error word to zero."""
    a = np.float32(3.1234567e-16)       # p ~ 1e-31 normal, e subnormal
    b = np.float32(3.7654321e-16)
    p, e = T.two_prod(torch.tensor([a]), torch.tensor([b]))
    assert e.item() != 0.0
    assert abs(float(e.item())) < 1.18e-38            # a subnormal word
    exact = np.float64(a) * np.float64(b)
    assert np.float64(p.item()) + np.float64(e.item()) == exact
    pj, ej = E.two_prod(jnp.asarray([a]), jnp.asarray([b]))
    assert float(ej[0]) == 0.0


@pytest.mark.parametrize("nw", [3, 5, 8])
def test_rsqrt_sqrt_within_seed_tolerance(nw, xla_subnormals):
    rng = np.random.default_rng(11 + nw)
    v = np.abs(rng.standard_normal(64)) * 10.0 ** rng.integers(-30, 30, 64)
    xs = split_words(v, nw)
    # 2^-(24 nw - 8), but no finer than 2^-118: Newton runs on values
    # scaled to ~1, whose words cannot go below the f32 floor 2^-126
    tol = 2.0 ** -min(24 * nw - 8, 118)
    for fj, ft in ((E.exp_rsqrt, T.exp_rsqrt), (E.exp_sqrt, T.exp_sqrt)):
        rj = fj(_j(xs))
        rt = ft(_t(xs))
        a = sum(np.asarray(c, np.float64) for c in rj)
        # a sum of words in f64 drops bits below 2^-53: compare the full
        # expansions through their expansion difference
        d = T.exp_sub(_t([np.asarray(c) for c in rj]), rt)
        dv = sum(c.numpy().astype(np.float64) for c in d)
        assert np.all(np.abs(dv) <= tol * np.abs(a)), \
            np.max(np.abs(dv) / np.abs(a))


def test_port_imports_no_jax():
    """`import clrs_tpu_torch`, one CPU IPM step on each substrate (f32
    and f64 words), the exact-certificate path (the GW max-cut solved on
    the CPU and rounded to 9/4 by exact_solution), `clrs_tpu_torch.parallel`
    with a mesh of one gloo rank, and the per-phase timing with the
    certified step-length route on a Cohn-Elkies problem, and the port's
    benchmark script torch_bench.py, with sympy blocked, load
    no JAX module, no sympy module, no clrs_tpu module under its own name,
    and no module whose file lies in the clrs_tpu/ source directory under
    any name: the port keeps its own copies of the host layers."""
    code = r"""
import sys
sys.modules["sympy"] = None
from fractions import Fraction
from pathlib import Path
import clrs_tpu_torch as ct
from clrs_tpu_torch.solver.step import DeviceSDP, initial_state, make_step_body
obj = ct.Objective(0, {"X": [[Fraction(1, 2), 0], [0, Fraction(1, 2)]]}, {})
cons = [ct.Constraint(1, {"X": [[1, 0], [0, 0]]}),
        ct.Constraint(2, {"X": [[0, 0], [0, 1]]})]
sdp = ct.ClusteredLowRankSDP(ct.Problem(ct.Maximize(obj), cons))
ds = DeviceSDP(sdp, nw=5, device="cpu")
step = make_step_body(ds, gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
                      dual_error_threshold=1e-12, primal_error_threshold=1e-12)
state, info = step(initial_state(ds, 10.0, 10.0), False)
assert bool(info["ok"])
import torch
ds = DeviceSDP(sdp, nw=2, device="cpu", dtype=torch.float64)
step = make_step_body(ds, gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
                      dual_error_threshold=1e-12, primal_error_threshold=1e-12)
state, info = step(initial_state(ds, 10.0, 10.0), False)
assert bool(info["ok"]) and state["y"][0].dtype == torch.float64
from clrs_tpu_torch.examples import goemans_williamson
problem, status, ds, ps, code = goemans_williamson(
    [[2, -1, -1], [-1, 2, -1], [-1, -1, 2]], omega_p=100.0, omega_d=100.0,
    verbose=False, eps=1e-18, dual_error_threshold=1e-15,
    primal_error_threshold=1e-15, device="cpu")
ok, esol = ct.exact_solution(problem, ds, ps, verbose=False)
assert code == 0 and ok and ct.objvalue(problem, esol) == Fraction(9, 4)
import tempfile
import torch.distributed as dist
from clrs_tpu_torch import parallel
from clrs_tpu_torch.parallel import bigcluster, comm
with tempfile.TemporaryDirectory() as tmp:
    dist.init_process_group("gloo", store=dist.FileStore(tmp + "/store", 1),
                            rank=0, world_size=1)
    assert parallel.make_mesh(1).size() == 1
    dist.destroy_process_group()
from clrs_tpu_torch.examples import cohnelkies_problem
from clrs_tpu_torch.solver import step as TS, timing
TS._STEPLEN_VERIFIED = True
ds = DeviceSDP(ct.ClusteredLowRankSDP(cohnelkies_problem(8, 1)), nw=5,
               device="cpu")
assert len(timing.phase_breakdown(ds, initial_state(ds, 10.0, 10.0),
                                  reps=1)) == 8
import torch_bench
assert torch_bench.count_step_macs(ds, **torch_bench.STEP_KW) > 0
jax_src = (Path.cwd() / "clrs_tpu").resolve()
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "clrs_tpu", "sympy")))
bad += sorted(m for m, mod in list(sys.modules.items())
              if getattr(mod, "__file__", None)
              and jax_src in Path(mod.__file__).resolve().parents)
print("LOADED", bad)
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout
