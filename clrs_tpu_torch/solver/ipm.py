"""Host-side IPM loop of the port (``clrs_tpu/solver/ipm.py`` on the f32
substrate, one device step per host iteration).

Kwargs and defaults follow the reference (solver.jl:100-128), as do
termination (:921-950), error codes 0-4, the iteration table,
checkpointing via SaveSettings and warm starts. The precision ladder is
the f32 one: nw = 5 words up to prec 106, then ceil(prec / 24) words, at
most 8 (the f32 exponent floor limits how many non-overlapping words a
value can carry).
"""

from __future__ import annotations

import pickle
import time as _time
import warnings
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..host.compile.sdp import ClusteredLowRankSDP
from ..host.dd.core import dd_add_f64 as _host_dd_add
from ..host.model.problem import Block, Problem
from ..host.solver.status import (DualFeasible, DualSolution, Feasible,
                                  NearOptimal, NotConverged, Optimal,
                                  PrimalFeasible, PrimalSolution)
from ..host.utils.hp import DDScalar
from ..state import state_to_numpy
from .step import DeviceSDP, _w, initial_state, make_assess, make_step_body

__all__ = ["solvesdp", "SolverFailure", "SaveSettings", "word_count"]


class SolverFailure(Exception):
    pass


class SaveSettings:
    """Checkpoint settings (solver.jl:14-40)."""

    def __init__(self, iter_interval=None, time_interval=None, only_last=True,
                 save_name=None, callback=None):
        if save_name is None:
            save_name = "solution" if only_last else "solution#"
        if (not only_last and "#" not in save_name
                and (iter_interval or time_interval or callback)):
            save_name += "#"
        self.iter_interval = iter_interval
        self.time_interval = time_interval
        self.only_last = only_last
        self.save_name = save_name
        self.callback = callback


def word_count(prec):
    """f32 words for a precision in bits: 5 up to 106, else ceil(prec/24)
    clamped to [5, 8]."""
    if prec is None or prec <= 106:
        return 5
    if prec > 8 * 24:
        warnings.warn(
            f"prec={prec} exceeds the f32 substrate's 8-word ceiling "
            "(~192 bits; the f32 exponent floor); running at nw=8.")
    return min(8, max(5, -(-int(prec) // 24)))


def _info_to_host(info):
    """One device->host transfer for all scalar info entries."""
    keys = list(info)
    vals = torch.stack([info[k].to(torch.float64) for k in keys]).cpu()
    out = {k: float(v) for k, v in zip(keys, vals)}
    for k in ("ok", "ok_X", "ok_S", "ok_Q", "pd_feas"):
        if k in out:
            out[k] = bool(out[k])
    return out


def solvesdp(problem, *, device, prec=None, maxiterations=500,
             beta_infeasible=0.3, beta_feasible=0.1, gamma=0.9,
             omega_p=1e10, omega_d=1e10,
             duality_gap_threshold=1e-15,
             dual_error_threshold=1e-30, primal_error_threshold=1e-30,
             max_complementary_gap=1e100,
             need_dual_feasible=False, need_primal_feasible=False,
             verbose=True, step_length_threshold=1e-7,
             dualsol: Optional[DualSolution] = None,
             primalsol: Optional[PrimalSolution] = None,
             safe_step=True, correctoronly=False,
             save_settings: Optional[SaveSettings] = None,
             preprocess=True, substrate="f32", mesh=None,
             callback=None):
    """Solve on ``device`` ("cuda" or "cpu"); returns (status, dualsol,
    primalsol, solve_time, errorcode).

    Runs the f32-expansion substrate with nw words (see :func:`word_count`).
    ``substrate="f64"`` and ``mesh=`` are later slices of the port and
    raise NotImplementedError. ``callback(it, info)``, if given, is called
    after every committed iteration with the host copy of its info."""
    if substrate != "f32":
        raise NotImplementedError("only substrate='f32' is ported")
    if mesh is not None:
        raise NotImplementedError("mesh= (sharded solves) is not ported")
    dev = resolve_device(device)
    if isinstance(problem, Problem):
        sdp = ClusteredLowRankSDP(problem)
    else:
        sdp = problem
    from ..host.model.checks import remove_empty_blocks
    remove_empty_blocks(sdp, verbose=verbose)
    if prec is None:
        prec = getattr(sdp, "prec", None)
    if preprocess:
        from ..host.compile.preprocess import preprocess_sdp
        sdp, post = preprocess_sdp(sdp, verbose=verbose)
    else:
        post = None

    ds = DeviceSDP(sdp, nw=word_count(prec), device=dev)
    step = make_step_body(ds, gamma=gamma, beta_feasible=beta_feasible,
                          beta_infeasible=beta_infeasible,
                          dual_error_threshold=dual_error_threshold,
                          primal_error_threshold=primal_error_threshold,
                          safe_step=safe_step, correctoronly=correctoronly)
    assess = make_assess(ds)

    state = initial_state(ds, float(omega_p), float(omega_d))
    if dualsol is not None and primalsol is not None:
        state = _warm_start(ds, sdp, state, dualsol, primalsol)

    info0 = _info_to_host(assess(state))
    dual_error = info0["dual_error"]
    primal_error = info0["primal_error"]
    dual_gap = info0["dual_gap"]
    mu = info0["mu"]
    d_obj, p_obj = info0["d_obj"], info0["p_obj"]
    pd_feas = (dual_error < dual_error_threshold
               and primal_error < primal_error_threshold)

    if verbose:
        print(f"{'iter':>5} {'time(s)':>8} {'mu':>11} {'D-obj':>11} "
              f"{'P-obj':>11} {'gap':>10} {'P-error':>10} {'p-error':>10} "
              f"{'d-error':>10} {'a_d':>10} {'a_p':>10} {'beta':>10}")

    error_code = 0
    it = 1
    t0 = _time.time()
    save_count = 0
    last_save_iter = 0
    save_t0 = _time.time()

    def terminate():
        if need_dual_feasible and dual_error < dual_error_threshold:
            if verbose:
                print("Dual feasible solution found")
            return True
        if need_primal_feasible and primal_error < primal_error_threshold:
            if verbose:
                print("Primal feasible solution found")
            return True
        if (not correctoronly and dual_error < dual_error_threshold
                and primal_error < primal_error_threshold
                and dual_gap < duality_gap_threshold):
            if verbose:
                print("Optimal solution found")
            return True
        return False

    while not terminate():
        if it > maxiterations:
            if verbose:
                print("The maximum number of iterations has been reached.")
            error_code = 2
            break
        if mu > max_complementary_gap:
            if verbose:
                print(f"The maximum complementary gap has been exceeded (mu = {mu}).")
            error_code = 3
            break

        new_state, info = step(state, pd_feas)
        info = _info_to_host(info)
        if not info["ok"] or not np.isfinite(info["mu"]):
            if verbose:
                which = [nm for nm, key in (("X", "ok_X"), ("S", "ok_S"),
                                            ("Q", "ok_Q")) if not info[key]]
                print(f"A Cholesky decomposition failed "
                      f"({'/'.join(which) or 'non-finite values'}); "
                      "returning the current solution. The problem may "
                      "need preprocessing or more precision.")
            error_code = 1
            break
        if min(info["alpha_d"], info["alpha_p"]) < step_length_threshold:
            if verbose:
                print(f"The step length ({min(info['alpha_d'], info['alpha_p']):.2e}) "
                      "was too short; possible precision issues or infeasibility.")
            error_code = 4
            break

        state = new_state
        mu = info["mu"]
        dual_error = info["dual_error"]
        primal_error = info["primal_error"]
        pd_feas = info["pd_feas"]
        d_obj, p_obj = info["d_obj"], info["p_obj"]
        dual_gap = info["dual_gap"]
        if callback is not None:
            callback(it, info)

        if verbose:
            print(f"{it:5d} {_time.time()-t0:8.1f} {mu:11.3e} {d_obj:11.3e} "
                  f"{p_obj:11.3e} {dual_gap:10.2e} {info['P_error']:10.2e} "
                  f"{info['p_error']:10.2e} {primal_error:10.2e} "
                  f"{info['alpha_d']:10.2e} {info['alpha_p']:10.2e} "
                  f"{info['beta_c']:10.2e}")

        if save_settings is not None:
            save_now = False
            ss = save_settings
            if ss.callback is not None:
                save_now = ss.callback(it, _time.time() - t0,
                                       it - last_save_iter,
                                       _time.time() - save_t0)
                if save_now:
                    last_save_iter = it
                    save_t0 = _time.time()
            else:
                if ss.iter_interval and it - last_save_iter >= ss.iter_interval:
                    save_now = True
                    last_save_iter = it
                if ss.time_interval and _time.time() - save_t0 >= ss.time_interval:
                    save_now = True
                    save_t0 = _time.time()
            if save_now:
                save_count += 1
                _save(ss, save_count, _extract(ds, sdp, state, post))
        it += 1

    solve_time = _time.time() - t0
    dualsol_out, primalsol_out = _extract(ds, sdp, state, post)

    if save_settings is not None and (save_settings.time_interval
                                      or (save_settings.iter_interval
                                          and last_save_iter != it - 1)):
        save_count += 1
        _save(save_settings, save_count, (dualsol_out, primalsol_out))

    if verbose:
        print(f"\nPrimal objective: {p_obj}")
        print(f"Dual objective: {d_obj}")
        print(f"duality gap: {dual_gap}")

    if pd_feas and dual_gap < duality_gap_threshold:
        status = Optimal()
    elif (pd_feas and dual_gap < 1e-8) or (dual_error < 1e-15
                                           and primal_error < 1e-15
                                           and dual_gap < 1e-8):
        status = NearOptimal()
    elif pd_feas:
        status = Feasible()
    elif primal_error < primal_error_threshold:
        status = PrimalFeasible()
    elif dual_error < dual_error_threshold:
        status = DualFeasible()
    else:
        status = NotConverged()

    return status, dualsol_out, primalsol_out, solve_time, error_code


def _save(ss: SaveSettings, count, sols):
    if ss.only_last:
        name = ss.save_name + ".jls"
    else:
        name = ss.save_name.replace("#", str(count)) + ".jls"
    with open(name, "wb") as f:
        pickle.dump(sols, f)


def _dd_scalar_array(hi, lo):
    out = np.empty(hi.shape, dtype=object)
    for idx in np.ndindex(*hi.shape):
        out[idx] = DDScalar(float(hi[idx]), float(lo[idx]))
    return out


def _two(ws):
    """nw f32 word arrays -> (hi, lo) float64, accumulated with host
    double-word adds so the full ~106-bit content survives."""
    h = np.asarray(ws[0], dtype=np.float64)
    l = np.zeros_like(h)
    for w in ws[1:]:
        h, l = _host_dd_add((h, l), np.asarray(w, dtype=np.float64))
    return h, l


def _extract(ds, sdp: ClusteredLowRankSDP, state, post=None):
    """Device state -> (DualSolution, PrimalSolution) (solver.jl:746-790)."""
    state = state_to_numpy(state)
    xg = [_two(ws) for ws in state["x"]]
    x = []
    for j in range(len(sdp.clusters)):
        g, jslot = ds.cluster_of[j]
        x.append((np.asarray(xg[g][0][jslot]), np.asarray(xg[g][1][jslot])))
    yh, yl = _two(state["y"])
    if post is not None:
        x, (yh, yl) = post(x, (yh, yl))
    scale = getattr(sdp, "free_scale", None)
    if scale is not None and yh.size:
        yh = yh / scale
        yl = yl / scale

    matrixvars = {}
    matrixvars_dual = {}
    for j, cl in enumerate(sdp.clusters):
        g, jslot = ds.cluster_of[j]
        if cl.scalars is not None:
            Xsh, Xsl = _two(tuple(c[jslot] for c in state["Xs"][g]))
            Ysh, Ysl = _two(tuple(c[jslot] for c in state["Ys"][g]))
            ts = cl.scalars.scale
            Xsh, Xsl = Xsh[:ts.size], Xsl[:ts.size]
            Ysh, Ysl = Ysh[:ts.size], Ysl[:ts.size]
            Ysh, Ysl = Ysh / ts, Ysl / ts
            Xsh, Xsl = Xsh * ts, Xsl * ts
            for bidx, (name, use_block) in enumerate(cl.scalars.names):
                key = Block(name, 1, 1) if use_block else name
                matrixvars[key] = _dd_scalar_array(
                    Ysh[bidx:bidx + 1, None], Ysl[bidx:bidx + 1, None])
                matrixvars_dual[key] = _dd_scalar_array(
                    Xsh[bidx:bidx + 1, None], Xsl[bidx:bidx + 1, None])
        for l, bd in enumerate(cl.blocks):
            ki, slot = ds.clusters[g].layout[jslot][l]
            n_real = bd.n
            Yh, Yl = _two(tuple(c[slot, :n_real, :n_real]
                                for c in state["Y"][g][ki]))
            Xh, Xl = _two(tuple(c[slot, :n_real, :n_real]
                                for c in state["X"][g][ki]))
            use_block, nsub = sdp.matrix_coeff_blocks[j][l]
            delta = bd.delta
            for r in range(nsub):
                for s in range(nsub):
                    sl = (slice(r * delta, (r + 1) * delta),
                          slice(s * delta, (s + 1) * delta))
                    key = Block(bd.name, r + 1, s + 1) if use_block else bd.name
                    matrixvars[key] = _dd_scalar_array(Yh[sl], Yl[sl])
                    matrixvars_dual[key] = _dd_scalar_array(Xh[sl], Xl[sl])

    freevars = {}
    for i, k in enumerate(sdp.free_names):
        freevars[k] = DDScalar(float(yh[i]), float(yl[i]))

    order_c = getattr(sdp, "_original_order_c", sdp.order_c)
    ncons = max((ci for (ci, si) in order_c), default=-1) + 1
    x_orig = [[] for _ in range(ncons)]
    for (ci, si) in sorted(order_c.keys()):
        j, row = order_c[(ci, si)]
        x_orig[ci].append(DDScalar(float(x[j][0][row]), float(x[j][1][row])))

    return (DualSolution(x_orig, matrixvars_dual),
            PrimalSolution(matrixvars, freevars))


def _warm_start(ds, sdp, state, dualsol: DualSolution, primalsol: PrimalSolution):
    """Scatter a previous solution back into x, X, y, Y (solver.jl:202-239)."""
    from ..host.utils.hp import to_dd

    x = [[np.zeros((cl.J, cl.nrows)), np.zeros((cl.J, cl.nrows))]
         for cl in ds.clusters]
    for (ci, si), (j, row) in sdp.order_c.items():
        try:
            v = dualsol.x[ci][si]
        except (IndexError, KeyError):
            continue
        h, l = to_dd(v)
        g, jslot = ds.cluster_of[j]
        x[g][0][jslot, row] = h
        x[g][1][jslot, row] = l

    def read_block(mv, j, l, bd):
        use_block, nsub = sdp.matrix_coeff_blocks[j][l]
        n = bd.n
        delta = bd.delta
        hi = np.zeros((n, n))
        lo = np.zeros((n, n))
        for r in range(nsub):
            for s in range(nsub):
                key = Block(bd.name, r + 1, s + 1) if use_block else bd.name
                if key not in mv and not use_block:
                    key = Block(bd.name, r + 1, s + 1)
                sub = mv[key]
                for a in range(delta):
                    for bcol in range(delta):
                        h, l2 = to_dd(sub[a, bcol])
                        hi[r * delta + a, s * delta + bcol] = h
                        lo[r * delta + a, s * delta + bcol] = l2
        return (hi, lo)

    def pad(ws):
        return _w(tuple(np.asarray(w) for w in ws), ds.nw, ds.device)

    def group_classes(dcl, mv):
        arrs = []
        for k in dcl.classes:
            hi = np.zeros((k.L, k.n, k.n))
            hi[:, np.arange(k.n), np.arange(k.n)] = 1.0
            arrs.append([hi, np.zeros((k.L, k.n, k.n))])
        for jslot, j in enumerate(dcl.members_j):
            cl = sdp.clusters[j]
            for l, bd in enumerate(cl.blocks):
                ki, slot = dcl.layout[jslot][l]
                hi, lo = read_block(mv, j, l, bd)
                n_real = bd.n
                arrs[ki][0][slot, :, :] = 0.0
                for a in range(n_real, dcl.classes[ki].n):
                    arrs[ki][0][slot, a, a] = 1.0
                arrs[ki][0][slot, :n_real, :n_real] = hi
                arrs[ki][1][slot, :n_real, :n_real] = lo
        return [pad((h, l2)) for h, l2 in arrs]

    X, Y, Xs, Ys = [], [], [], []
    for g, dcl in enumerate(ds.clusters):
        X.append(group_classes(dcl, dualsol.matrixvars))
        Y.append(group_classes(dcl, primalsol.matrixvars))
        nb = dcl.s_nb
        xsh = np.ones((dcl.J, nb))
        xsl = np.zeros((dcl.J, nb))
        ysh = np.ones((dcl.J, nb))
        ysl = np.zeros((dcl.J, nb))
        for jslot, j in enumerate(dcl.members_j):
            sc = sdp.clusters[j].scalars
            if sc is None:
                continue
            for bidx, (name, use_block) in enumerate(sc.names):
                key = Block(name, 1, 1) if use_block else name
                t = sc.scale[bidx]
                h, l = to_dd(dualsol.matrixvars[key][0, 0])
                xsh[jslot, bidx], xsl[jslot, bidx] = h / t, l / t
                h, l = to_dd(primalsol.matrixvars[key][0, 0])
                ysh[jslot, bidx], ysl[jslot, bidx] = h * t, l * t
        Xs.append((xsh, xsl))
        Ys.append((ysh, ysl))

    names = getattr(sdp, "free_names_reduced", sdp.free_names)
    scale = getattr(sdp, "free_scale", None)
    full_index = {str(k): i for i, k in enumerate(sdp.free_names)}
    yh = np.zeros(len(names))
    yl = np.zeros(len(names))
    for i, k in enumerate(names):
        if k in primalsol.freevars:
            yh[i], yl[i] = to_dd(primalsol.freevars[k])
            if scale is not None:
                sk = scale[full_index[str(k)]]
                yh[i] *= sk
                yl[i] *= sk

    return {"x": [pad(hl) for hl in x], "y": pad((yh, yl)), "X": X, "Y": Y,
            "Xs": [pad(p) for p in Xs], "Ys": [pad(p) for p in Ys]}
