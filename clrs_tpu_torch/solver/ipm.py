"""Host-side IPM loop of the port (``clrs_tpu/solver/ipm.py``): chunks of
``sync_every`` iterations through :func:`.step.make_run_chunk`, whose
steps replay captured CUDA graphs on the card and run eagerly on the CPU.

Kwargs and defaults follow the reference (solver.jl:100-128), as do
termination (:921-950), error codes 0-4, the iteration table,
checkpointing via SaveSettings and warm starts. Two substrates, each with
its precision ladder: f32 words (the default; :func:`word_count`: nw = 5
up to prec 106, then ceil(prec / 24), at most 8, since the f32 exponent
floor limits how many non-overlapping words a value can carry) and f64
words (:func:`word_count_f64`: 2 up to prec 106, 4 up to 212, then
ceil(prec / 53), no cap).
"""

from __future__ import annotations

import pickle
import time as _time
import warnings
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..compile.sdp import ClusteredLowRankSDP
from ..dd.core import dd_add_f64 as _host_dd_add
from ..device import DEFAULT_DEVICE, resolve_device
from ..model.problem import Block, Problem
from ..parallel.api import gather_state
from ..state import state_to_numpy
from ..utils.hp import DDScalar
from .status import (DualFeasible, DualSolution, Feasible, NearOptimal,
                     NotConverged, Optimal, PrimalFeasible, PrimalSolution)
from .step import (F32, F64, DeviceSDP, _w, initial_state, make_assess,
                   make_run_chunk, sharded, zero_info)

__all__ = ["solvesdp", "SolverFailure", "SaveSettings", "word_count",
           "word_count_f64", "pick_substrate"]


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


def word_count_f64(prec):
    """f64 words for a precision in bits (clrs_tpu/solver/ipm.py:135-140):
    2 up to 106, 4 up to 212, else ceil(prec/53) with no cap."""
    if prec is None or prec <= 106:
        return 2
    if prec <= 212:
        return 4
    return -(-int(prec) // 53)


def pick_substrate(substrate, device):
    """The substrate a solve on ``device`` runs: ``substrate`` itself unless
    it is None, the pick by platform (the JAX package's rule,
    clrs_tpu/solver/ipm.py:104-105, put on this platform).

    - On the CPU: "f64", as the JAX package picks off the TPU.
    - On the card: "f32", the substrate torch_bench.py measures faster at
      both of its problems on an NVIDIA H100 80GB HBM3 at 700.00 W (f32
      nw 5 against f64 nw 2, graph iterations, medians of three chunks:
      delsarte(3,10) 14.560 against 14.220 it/s, within the f64 chunks'
      spread of 11.28-14.72; delsarte(3,127) 99.68 against 678.84 ms an
      iteration, 6.8 times faster; PERF.md §5). It is also the path of
      the hand-written kernels."""
    if substrate is not None:
        return substrate
    return "f32" if torch.device(device).type == "cuda" else "f64"


def _to_host(info, **extra):
    """One device->host transfer for all scalar info entries (and any
    ``extra`` device scalars: a chunk's it_done, code and done); after
    its wait, the step graph's sampled phase times are read
    (:func:`clrs_tpu_torch.tracing.read_sample`)."""
    with tracing.span("host_read"):
        vals = dict(info, **extra)
        keys = list(vals)
        stacked = torch.stack([torch.as_tensor(vals[k]).to(torch.float64)
                               for k in keys])
        with tracing.span("host_read.wait"):
            host = stacked.cpu()
        tracing.read_sample()
        out = {k: float(v) for k, v in zip(keys, host)}
        for k in ("ok", "ok_X", "ok_S", "ok_Q", "pd_feas", "done"):
            if k in out:
                out[k] = bool(out[k])
    return out


def solvesdp(problem, *, device=DEFAULT_DEVICE, prec=None,
             maxiterations=500, beta_infeasible=0.3, beta_feasible=0.1, gamma=0.9,
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
             preprocess=True, testing=False, substrate="f32", mesh=None,
             callback=None, sync_every=None):
    """Solve on ``device`` (the card by default; "cpu" runs the kernels'
    plain versions); returns (status, dualsol, primalsol, solve_time,
    errorcode). Without a card, the default raises: nothing falls back to
    the CPU.

    ``substrate="f32"`` (the default) runs f32 expansions with nw words
    (:func:`word_count`): the path of the hand-written kernels.
    ``substrate="f64"`` runs f64 words (:func:`word_count_f64`), the JAX
    package's substrate off the TPU, whose f64 the card has as IEEE:
    slice GEMMs over one f64 GEMM each and PyTorch expansion ops, captured
    in the same CUDA graphs. ``substrate=None`` picks by platform
    (:func:`pick_substrate`: "f32" on the card, "f64" on the CPU). Any
    other substrate raises ValueError.

    ``mesh``, a 1-D ``torch.distributed`` DeviceMesh
    (:func:`clrs_tpu_torch.parallel.make_mesh`; any other object raises
    TypeError), runs a sharded solve, SPMD: every rank of the mesh's
    process group calls ``solvesdp`` with the same arguments, on its own
    ``device``. The axes are padded to the mesh (``DeviceSDP(mesh_divisor=
    n)``); eligible single big clusters distribute by row panels
    (``enable_row_sharding``) and the rest shard on the cluster, class and
    scalar-pack axes (``shard_device_sdp``), which raises ValueError where
    nothing shards at all (clrs_tpu/solver/ipm.py:142-155, 181-183). The
    sharded step runs eagerly on every rank (:class:`.graph.EagerSplit`,
    also on the card): its collectives are not captured in CUDA graphs.
    Every rank returns the same results, the time being the slowest
    rank's; only rank 0 writes ``save_settings`` files.

    ``sync_every`` (default 1) iterations run as one chunk of
    :func:`.step.make_run_chunk`: on the card each iteration replays the
    step's captured CUDA graphs around the eager eigensolver, and the host
    reads the chunk's info, committed count and code once at its end; the
    iteration log prints one row per chunk. On the CPU the same loop runs
    eagerly. A failed capture raises; nothing carries on eagerly on the
    card. ``callback(it, info)``, if given, is called once per chunk that
    committed an iteration, with the number of iterations committed so far
    and the host copy of the last committed iteration's info (with
    ``sync_every=1``: after every committed iteration).

    ``testing=True`` prints, after the solve, the time of the first chunk
    (which captures the graphs on the card) against the later ones, from
    the ``chunk`` spans (:mod:`clrs_tpu_torch.tracing`), on the card the
    graph's sampled device ms per phase (:func:`.timing.print_sampled`),
    and the per-phase table of :func:`.timing.print_breakdown` on the
    final state (clrs_tpu/solver/ipm.py:366-374)."""
    dev = resolve_device(device)
    tracing.open_solve()
    substrate = pick_substrate(substrate, dev)
    if substrate not in ("f32", "f64"):
        raise ValueError(f"substrate must be 'f32' or 'f64', got "
                         f"{substrate!r}")
    mesh_div = 1
    if mesh is not None:
        from ..parallel.api import mesh_size
        mesh_div = mesh_size(mesh)
    if isinstance(problem, Problem):
        sdp = ClusteredLowRankSDP(problem)
    else:
        sdp = problem
    from ..model.checks import remove_empty_blocks
    remove_empty_blocks(sdp, verbose=verbose)
    if prec is None:
        prec = getattr(sdp, "prec", None)
    if preprocess:
        from ..compile.preprocess import preprocess_sdp
        sdp, post = preprocess_sdp(sdp, verbose=verbose)
    else:
        post = None

    if sync_every is None:
        sync_every = 1
    sync_every = int(sync_every)
    if sync_every < 1:
        raise ValueError(f"sync_every must be at least 1, got {sync_every}")
    if substrate == "f64":
        ds = DeviceSDP(sdp, nw=word_count_f64(prec), device=dev, dtype=F64,
                       mesh_divisor=mesh_div)
    else:
        ds = DeviceSDP(sdp, nw=word_count(prec), device=dev, dtype=F32,
                       mesh_divisor=mesh_div)
    state = initial_state(ds, float(omega_p), float(omega_d))
    if dualsol is not None and primalsol is not None:
        state = _warm_start(ds, sdp, state, dualsol, primalsol)
    if mesh is not None:
        from ..parallel.api import (enable_row_sharding, shard_device_sdp,
                                    shard_state)
        # single big clusters distribute by row panels; the remaining
        # groups shard on their cluster, class and scalar-pack axes
        n_rows = enable_row_sharding(ds, mesh)
        try:
            shard_device_sdp(ds, mesh)
        except ValueError:
            if n_rows == 0:     # nothing sharded at all: keep the loud
                raise           # failure (no silent replication)
        state = shard_state(ds, state, mesh)
    run_chunk = make_run_chunk(
        ds, duality_gap_threshold=duality_gap_threshold,
        need_dual_feasible=need_dual_feasible,
        need_primal_feasible=need_primal_feasible,
        step_length_threshold=step_length_threshold,
        max_complementary_gap=max_complementary_gap, gamma=gamma,
        beta_feasible=beta_feasible, beta_infeasible=beta_infeasible,
        dual_error_threshold=dual_error_threshold,
        primal_error_threshold=primal_error_threshold,
        safe_step=safe_step, correctoronly=correctoronly)
    assess = make_assess(ds)

    info0 = _to_host(assess(state))
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
    chunks = [tracing.span_totals("chunk")]  # before, after the first chunk
    phases0 = tracing.snapshot() if testing else None
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

        if it == 1:
            feas_dev, info_dev = pd_feas, zero_info(info0, dev)
        n = min(sync_every, maxiterations - it + 1)
        state, feas_dev, info_dev, itd, code, done = run_chunk(
            state, feas_dev, info_dev, n)
        info = _to_host(info_dev, it_done=itd, code=code)
        if len(chunks) == 1:
            chunks.append(tracing.span_totals("chunk"))
        itd, code = int(info.pop("it_done")), int(info.pop("code"))
        if itd:
            it += itd
            mu = info["mu"]
            dual_error = info["dual_error"]
            primal_error = info["primal_error"]
            pd_feas = info["pd_feas"]
            d_obj, p_obj = info["d_obj"], info["p_obj"]
            dual_gap = info["dual_gap"]
            if callback is not None:
                callback(it - 1, info)
            if verbose:
                print(f"{it - 1:5d} {_time.time()-t0:8.1f} {mu:11.3e} "
                      f"{d_obj:11.3e} {p_obj:11.3e} {dual_gap:10.2e} "
                      f"{info['P_error']:10.2e} {info['p_error']:10.2e} "
                      f"{primal_error:10.2e} {info['alpha_d']:10.2e} "
                      f"{info['alpha_p']:10.2e} {info['beta_c']:10.2e}")
        if code == 1:
            if verbose:
                print("A Cholesky decomposition failed (or non-finite "
                      "values appeared); returning the current solution. "
                      "The problem may need preprocessing or more "
                      "precision.")
            error_code = 1
            break
        if code == 4:
            if verbose:
                print("The step length was too short; possible precision "
                      "issues or infeasibility.")
            error_code = 4
            break
        if code == 3:
            if verbose:
                print(f"The maximum complementary gap has been exceeded "
                      f"(mu = {mu}).")
            error_code = 3
            break

        if save_settings is not None and itd:
            done_it = it - 1
            save_now = False
            ss = save_settings
            if ss.callback is not None:
                save_now = ss.callback(done_it, _time.time() - t0,
                                       done_it - last_save_iter,
                                       _time.time() - save_t0)
                if save_now:
                    last_save_iter = done_it
                    save_t0 = _time.time()
            else:
                if (ss.iter_interval
                        and done_it - last_save_iter >= ss.iter_interval):
                    save_now = True
                    last_save_iter = done_it
                if ss.time_interval and _time.time() - save_t0 >= ss.time_interval:
                    save_now = True
                    save_t0 = _time.time()
            if sharded(ds):
                # the ranks' clocks differ: save where any rank would, so
                # that every rank joins the gather below
                save_now = bool(_comm(ds).all_max(torch.full(
                    (), float(save_now), dtype=torch.float64, device=dev)))
            if save_now:
                save_count += 1
                sols = _extract(ds, sdp, gather_state(ds, state), post)
                if _rank(ds) == 0:
                    _save(ss, save_count, sols)
        if itd == 0:
            break

    solve_time = _time.time() - t0
    dualsol_out, primalsol_out = _extract(ds, sdp, gather_state(ds, state),
                                          post)
    if sharded(ds):
        solve_time = float(_comm(ds).all_max(torch.full(
            (), solve_time, dtype=torch.float64, device=dev)))

    if save_settings is not None and _rank(ds) == 0 and (
            save_settings.time_interval
            or (save_settings.iter_interval and last_save_iter != it - 1)):
        save_count += 1
        _save(save_settings, save_count, (dualsol_out, primalsol_out))

    if verbose:
        print(f"\nPrimal objective: {p_obj}")
        print(f"Dual objective: {d_obj}")
        print(f"duality gap: {dual_gap}")
    if testing and len(chunks) == 2:
        # the reference's `testing=true` phase table (solver.jl:664-718):
        # the first chunk (graph capture) against the steady state, from
        # the `chunk` spans; the graph's sampled phases, then each phase
        # timed on its own
        from .timing import print_breakdown, print_sampled
        (n0, ns0), (n1, ns1) = chunks
        n2, ns2 = tracing.span_totals("chunk")
        rest = (ns2 - ns1) / (n2 - n1) if n2 > n1 else ns1 - ns0
        print(f"timing: total {solve_time:.2f}s over {n2 - n0} "
              f"iterations; first call (incl. capture) "
              f"{(ns1 - ns0) / 1e9:.2f}s; steady-state "
              f"{rest / 1e6:.2f} ms/iter")
        print_sampled(phases0, tracing.snapshot())
        print_breakdown(ds, state)

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


def _comm(ds):
    """The collectives of a sharded solve (None without a mesh)."""
    return ds.comm or ds.row_comm


def _rank(ds):
    """This process's rank in a sharded solve (0 without a mesh)."""
    return 0 if _comm(ds) is None else _comm(ds).rank


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
    """nw word arrays -> (hi, lo) float64 (clrs_tpu/solver/ipm.py:410-430).
    f64 words decrease by at least 2^-53 per position, so the tail summed
    into lo loses nothing a double word holds; f32 words are accumulated
    with host double-word adds so the full ~106-bit content survives."""
    if np.asarray(ws[0]).dtype == np.float64:
        lo = np.asarray(ws[1], dtype=np.float64).copy()
        for w in ws[2:]:
            lo = lo + np.asarray(w, dtype=np.float64)
        return np.asarray(ws[0], dtype=np.float64), lo
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
    from ..utils.hp import to_dd

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
        return _w(tuple(np.asarray(w) for w in ws), ds.nw, ds.device,
                  ds.dtype)

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
