"""Per-phase timing breakdown (port of ``clrs_tpu/solver/timing.py``; the
reference's ``testing=true`` table, ClusteredLowRankSolver.jl
src/solver.jl:664-718).

An iteration replays one CUDA graph on the card, whose phases the graph's
own timing events measure as it runs (:mod:`clrs_tpu_torch.tracing`;
:func:`sampled_phases`). This module also runs each phase
of the step on its own, built from what :func:`.step.make_step_parts`'
head and tail call on the same state, and times it: with CUDA events on
the card, with the host clock on the CPU. Each phase runs eagerly, its
kernels launched one by one, so a phase's time includes the host's
launches where they outlast the device's work.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from ..dd import kernels as dk
from ..dd import linalg as dl
from ..dd.arith import dd_add, dd_div, dd_mul, dd_sub
from . import step as _st

__all__ = ["phase_breakdown", "print_breakdown", "sampled_phases",
           "print_sampled"]


def _time_it(fn, *args, dev, reps=3):
    """Seconds per call of ``fn(*args)`` after one warm-up call."""
    fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return (time.perf_counter() - t0) / reps
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    t0.record()
    for _ in range(reps):
        fn(*args)
    t1.record()
    torch.cuda.synchronize(dev)
    return 1e-3 * t0.elapsed_time(t1) / reps


def phase_breakdown(ds, state, reps: int = 3) -> Dict[str, float]:
    """Time each IPM phase separately (seconds per call), with the JAX
    module's keys. ``state`` is a state of ``ds`` (any iterate)."""
    nw, dt, dev = ds.nw, ds.dtype, ds.device
    plmap = dt == _st.F32

    def chol_x(state):
        # chol(X) and chol(Y) as one [2L] batch, then X^-1, as the head
        out = []
        for j, cl in enumerate(ds.clusters):
            for ki, k in enumerate(cl.classes):
                L2, _ = dl.b_cholesky(_st._cat(state["X"][j][ki],
                                               state["Y"][j][ki]))
                eye_b = tuple(c.expand(k.L, k.n, k.n)
                              for c in dl.dd_eye(k.n, nw, dev, dt))
                inv = dl.b_solve_cholesky(tuple(c[:k.L] for c in L2), eye_b)
                out.append(dl.dd_symmetrize(inv))
        return out

    it = iter(chol_x(state))
    Xinv = [[next(it) for _ in cl.classes] for cl in ds.clusters]
    Xinv_s = []
    for j, cl in enumerate(ds.clusters):
        if cl.s_nb:
            ones = torch.ones((cl.J, cl.s_nb), dtype=dt, device=dev)
            Xinv_s.append(dd_div(_st._scalar(ones, nw), state["Xs"][j]))
        else:
            Xinv_s.append(dl.dd_zeros((cl.J, 0), nw, dev, dt))

    def schur(Xinv, state):
        return [_st._schur_cluster(cl, Xinv[j], state["Y"][j], Xinv_s[j],
                                   state["Ys"][j])
                for j, cl in enumerate(ds.clusters)]

    Ss = schur(Xinv, state)

    def kkt(Ss):
        cholSs, LinvBs = [], []
        for j, cl in enumerate(ds.clusters):
            L, _ = dl.b_cholesky(Ss[j])
            cholSs.append(L)
            LinvBs.append(dl.b_solve_tril(L, cl.B))
        Q = dl.dd_zeros((ds.nfree, ds.nfree), nw, dev, dt)
        for LinvB in LinvBs:
            Bf = tuple(c.reshape(c.shape[0] * c.shape[1], c.shape[2])
                       for c in LinvB)
            Q = dd_add(Q, dl.dd_matmul(dl.dd_transpose(Bf), Bf))
        cholQ, _ = dl.s_cholesky(Q)
        return cholSs, LinvBs, cholQ

    def residuals(state):
        return _st._residuals(ds, state)

    Kt = torch.full((), float(ds.total_size), dtype=dt, device=dev)

    def resid_R(state):
        mu = dd_div(_st._dot_state(ds, state, state), _st._scalar(Kt, nw))
        Rs = []
        for j, cl in enumerate(ds.clusters):
            for ki, k in enumerate(cl.classes):
                XY = _st._bmm(state["X"][j][ki], state["Y"][j][ki])
                if plmap:
                    Rs.append(dk.plmap_residual(_st._bcast_words(mu, k.L),
                                                k.maskd, XY))
                    continue
                eye_b = tuple(c.expand(k.L, k.n, k.n)
                              for c in dl.dd_eye(k.n, nw, dev, dt))
                Rs.append(_st._dd_scale(dd_sub(dd_mul(mu, eye_b), XY),
                                        k.maskd))
        return Rs

    def trace_A(Xinv):
        return [_st._trace_A_cluster(cl, Xinv[j], Xinv_s[j])
                for j, cl in enumerate(ds.clusters)]

    def weighted_A(state):
        return [_st._weighted_A_cluster(cl, state["x"][j])[0]
                for j, cl in enumerate(ds.clusters)]

    inf = torch.full((), float("inf"), dtype=_st.F64, device=dev)
    one = torch.full((), 1.0, dtype=_st.F64, device=dev)

    def steplen(state):
        # the head's step-length matrices, the eigensolver, the tail's
        # step lengths, on the directions 0.01 X and 0.01 Y
        def scaled(key):
            return [[_st._dd_scale(b, 0.01) for b in cls]
                    for cls in state[key]]

        dX, dY = scaled("X"), scaled("Y")
        dXs = [_st._dd_scale(w, 0.01) for w in state["Xs"]]
        dYs = [_st._dd_scale(w, 0.01) for w in state["Ys"]]
        cholX, cholY = [], []
        for j, cl in enumerate(ds.clusters):
            cx, cy = [], []
            for ki, k in enumerate(cl.classes):
                L2, _ = dl.b_cholesky(_st._cat(state["X"][j][ki],
                                               state["Y"][j][ki]))
                cx.append(tuple(c[:k.L] for c in L2))
                cy.append(tuple(c[k.L:] for c in L2))
            cholX.append(cx)
            cholY.append(cy)
        mats, bads, words = _st._step_mats(ds, dX, dY, cholX, cholY)
        lows, safety = _st._certify(words, _st.step_eig(mats), 1e-12)
        return _st._step_lengths(ds, state, dX, dXs, dY, dYs, lows, bads,
                                 0.9, safety, inf, one)

    return {
        "chol_X + X^-1": _time_it(chol_x, state, dev=dev, reps=reps),
        "R residual": _time_it(resid_R, state, dev=dev, reps=reps),
        "schur S": _time_it(schur, Xinv, state, dev=dev, reps=reps),
        "chol S + LinvB + Q + chol Q": _time_it(kkt, Ss, dev=dev, reps=reps),
        "residuals P,p,d": _time_it(residuals, state, dev=dev, reps=reps),
        "trace_A": _time_it(trace_A, Xinv, dev=dev, reps=reps),
        "weighted_A (dX assembly)": _time_it(weighted_A, state, dev=dev,
                                             reps=reps),
        "step length": _time_it(steplen, state, dev=dev, reps=reps),
    }


def print_breakdown(ds, state, reps: int = 3):
    """Print the per-phase table (solver.jl:685-705 analogue)."""
    bd = phase_breakdown(ds, state, reps=reps)
    total = sum(bd.values())
    print(f"{'phase':<30} {'ms/call':>10} {'share':>7}")
    for k, v in sorted(bd.items(), key=lambda kv: -kv[1]):
        print(f"{k:<30} {1e3 * v:>10.2f} {100 * v / total:>6.1f}%")
    print(f"{'sum of phases':<30} {1e3 * total:>10.2f}")
    return bd


def sampled_phases(before, after):
    """{phase: device ms per sampled replay} of the step graph's timing
    events between two :func:`clrs_tpu_torch.tracing.snapshot` readings,
    both buckets together ({} without samples: the CPU, or tracing off)."""
    def totals(snap):
        out = {}
        for b in ("unprofiled", "profiled"):
            for k, v in snap[b]["phases"].items():
                n, t = out.get(k, (0, 0.0))
                out[k] = (n + v["samples"], t + v["total_ms"])
        return out

    t0, t1 = totals(before), totals(after)
    out = {}
    for k, (n, t) in t1.items():
        n0, s0 = t0.get(k, (0, 0.0))
        if n > n0:
            out[k] = (t - s0) / (n - n0)
    return out


def print_sampled(before, after):
    """Print :func:`sampled_phases` as a table (nothing without samples)."""
    ph = sampled_phases(before, after)
    if not ph:
        return ph
    total = sum(ph.values())
    print(f"{'graph phase (sampled)':<30} {'ms/iter':>10} {'share':>7}")
    for k, v in sorted(ph.items(), key=lambda kv: -kv[1]):
        print(f"{k:<30} {v:>10.3f} {100 * v / total:>6.1f}%")
    print(f"{'graph (first to last event)':<30} {total:>10.3f}")
    return ph
