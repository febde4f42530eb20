"""Benchmark of the PyTorch/CUDA port: IPM iterations/s on the Delsarte LP
bound, the port's counterpart of bench.py (same tiers, same metric names).

Run from the repository root on a machine with one CUDA card:

    python3 torch_bench.py

Prints ONE JSON line on stdout, the headline tier:
{"metric": "ipm_iterations_per_s_delsarte_3_10", "value", "unit",
"vs_baseline", "mfu", ...}: delsarte(3,10) at f32 nw 5, 20 iterations a
chunk. Baseline as in bench.py: the reference's only timing datapoint,
~18 ms/iteration (~55.6 it/s) for its polyopt example; vs_baseline = ours /
55.6 (a proxy: a different problem of comparable scale).

On stderr, one JSON line each:
- ipm_ms_per_iter_delsarte_3_127_schur_dominated: f32 nw 5, 10 iterations
  (SOS blocks 128 and 127: the Schur assembly and chol(S) at scale);
- ipm_iterations_per_s_delsarte_3_10_hi_nw8: f32 nw 8 (~192 bits);
- ipm_iterations_per_s_delsarte_3_10_f64_nw2 and
  ipm_ms_per_iter_delsarte_3_127_f64_nw2: the f64 substrate at nw 2, the
  tier bench.py runs off the TPU (delsarte(3,127) is compiled once for
  both substrates);
then the per-phase table of solver/timing.py::print_breakdown at
delsarte(3,10), f32 nw 5.

Every tier times chunks of ``n_iters`` iterations of make_run_chunk, each
iteration replaying the step's CUDA graphs, on the host clock ending in
torch.cuda.synchronize(): a chunk of 1 first (it captures the graphs),
then three timed chunks, each from the state after that first iteration
(iterations 2 to n_iters + 1, as bench.py times); the value is the
median, with the min and max beside it. Thresholds are set so no termination test can fire, so every
chunk commits ``n_iters`` iterations with code 0 (asserted). Each line
carries the card's name and power limit (nvidia-smi), the host-build and
capture seconds, and the MFU: the tensor-core operations of one iteration
(count_step_macs: int8 ops on f32 words, f64 ops of the slice GEMMs' DGEMMs
on f64 words) times iterations/s over the H100 SXM's published dense peak
at 700 W: 1,979 int8 TOP/s, 67 FP64 tensor-core TFLOP/s.

Needs a card: without one it raises; nothing falls back to the CPU.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
from fractions import Fraction

import torch

from clrs_tpu_torch.compile.sdp import ClusteredLowRankSDP
from clrs_tpu_torch.device import resolve_device
from clrs_tpu_torch.examples import delsarte_problem
from clrs_tpu_torch.solver.step import (F32, F64, DeviceSDP, initial_state,
                                        make_run_chunk, make_step_body,
                                        zero_info)

BASELINE_ITERS_PER_S = 1000.0 / 18.0  # reference: ~18 ms/iter (bench.py:44)

# H100 SXM, NVIDIA's data sheet, dense, at 700 W
H100_INT8_PEAK_OPS = 1979e12
H100_FP64_TC_PEAK_FLOPS = 67e12

# bench.py:82-87: no termination test can fire inside a chunk
STEP_KW = dict(gamma=0.9, beta_feasible=0.1, beta_infeasible=0.3,
               dual_error_threshold=1e-12, primal_error_threshold=1e-12)
CHUNK_KW = dict(STEP_KW, duality_gap_threshold=0.0,
                step_length_threshold=0.0,
                max_complementary_gap=float("inf"))


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    name, limit = (p.strip() for p in
                   r.stdout.strip().splitlines()[0].split(","))
    return {"name": name, "power.limit": limit}


def count_step_macs(ds, **step_kw):
    """Tensor-core operations of one IPM iteration (2 per multiply-add):
    int8 ops of the limb GEMMs on f32 words (limb blowup included), f64
    ops of the slice GEMMs' DGEMMs on f64 words. Runs make_step_body once,
    eagerly, from initial_state(ds, 100, 100) with the counters on."""
    from clrs_tpu_torch.dd import limb_gemm as lg
    from clrs_tpu_torch.dd import slice_gemm as sg

    body = make_step_body(ds, **step_kw)
    state = initial_state(ds, 100.0, 100.0)
    lg._MAC_COUNTER, sg._OP_COUNTER = [], []
    try:
        body(state, False)
        return sum(sg._OP_COUNTER if ds.dtype == F64 else lg._MAC_COUNTER)
    finally:
        lg._MAC_COUNTER = sg._OP_COUNTER = None


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_problem(problem, n_iters=20, nw=None, substrate="f32",
                  device="cuda", report_mfu=False, reps=3):
    """Time ``reps`` chunks of ``n_iters`` committed IPM iterations of
    ``problem`` (a Problem, or its ClusteredLowRankSDP to reuse one host
    build) on ``substrate`` ("f32": nw 5 by default; "f64": nw 2), after a
    chunk of 1 that captures the graphs. Returns a dict: iterations/s
    (median, min, max over the chunks), the host build, DeviceSDP and
    capture seconds and, with ``report_mfu``, the tensor-core operations
    per iteration and, on the card, the MFU against the H100's peak for
    the substrate."""
    if substrate not in ("f32", "f64"):
        raise ValueError(f"substrate must be 'f32' or 'f64', got "
                         f"{substrate!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    sdp = (problem if isinstance(problem, ClusteredLowRankSDP)
           else ClusteredLowRankSDP(problem))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if substrate == "f64":
        ds = DeviceSDP(sdp, nw=nw or 2, device=dev, dtype=F64)
    else:
        ds = DeviceSDP(sdp, nw=nw or 5, device=dev, dtype=F32)
    device_sdp_s = time.perf_counter() - t0
    run = make_run_chunk(ds, **CHUNK_KW)
    start = (initial_state(ds, 100.0, 100.0), False, zero_info(None, dev))

    def chunk(n):
        """n iterations from ``start``: (wall s, iterations committed, the
        loop's state, pd_feas and info after them)."""
        t0 = time.perf_counter()
        state, pd, info, itd, code, _ = run(*start, n)
        _sync(dev)
        dt = time.perf_counter() - t0
        if int(itd) != n or int(code) != 0:
            raise AssertionError(f"benchmark chunk stopped early (it="
                                 f"{int(itd)} of {n}, code={int(code)})")
        return dt, int(itd), (state, pd, info)

    capture_s, _, after = chunk(1)
    # every timed chunk runs the same iterations, 2 to n_iters + 1, from
    # the state after the first (a solve ends near 30 iterations, so the
    # chunks cannot run on from each other)
    start = copy.deepcopy(after)
    timed = [chunk(n_iters)[:2] for _ in range(reps)]
    rates = sorted(n_iters / w for w, _ in timed)
    out = {"device": str(dev), "substrate": substrate, "nw": ds.nw,
           "n_iters": n_iters, "reps": reps,
           "committed": sum(c for _, c in timed),
           "iterations_per_s": statistics.median(rates),
           "iterations_per_s_min": rates[0],
           "iterations_per_s_max": rates[-1],
           "host_build_s": build_s, "device_sdp_s": device_sdp_s,
           "capture_s": capture_s}
    if report_mfu:
        ops = count_step_macs(ds, **STEP_KW)
        kind = "f64" if substrate == "f64" else "int8"
        out[f"{kind}_ops_per_iter"] = ops
        if dev.type == "cuda":          # a rate of the card, never the CPU's
            its = out["iterations_per_s"]
            peak = (H100_FP64_TC_PEAK_FLOPS if kind == "f64"
                    else H100_INT8_PEAK_OPS)
            key = ("mfu_vs_h100_fp64_tc_peak" if kind == "f64"
                   else "mfu_vs_h100_int8_peak")
            out.update({"achieved_tera_ops_per_s": ops * its / 1e12,
                        key: ops * its / peak})
    return out


def _line(metric, r, per_iter_ms, crd):
    rate = r["iterations_per_s"]
    line = {"metric": metric}
    if per_iter_ms:
        line.update(value=1000.0 / rate, unit="ms/iteration",
                    ms_min=1000.0 / r["iterations_per_s_max"],
                    ms_max=1000.0 / r["iterations_per_s_min"])
    else:
        line.update(value=rate, unit="iterations/s")
    line.update(r, card=crd)
    return line


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch_bench.py measures the card: CUDA is not "
                           "available")
    crd = card()
    from clrs_tpu_torch.dd import build

    t0 = time.perf_counter()
    build.library()         # the CUDA kernels, before any tier's capture
    print(json.dumps({"kernel build s": time.perf_counter() - t0}),
          file=sys.stderr, flush=True)
    p10 = delsarte_problem(3, 10, Fraction(1, 2))
    head = bench_problem(p10, n_iters=20, report_mfu=True)
    result = _line("ipm_iterations_per_s_delsarte_3_10", head, False, crd)
    result["vs_baseline"] = head["iterations_per_s"] / BASELINE_ITERS_PER_S
    result["mfu"] = head["mfu_vs_h100_int8_peak"]

    def tier(metric, per_iter_ms, problem, host_build_s=None, **kw):
        r = bench_problem(problem, **kw)
        if host_build_s is not None:        # compiled once, before the tier
            r["host_build_s"] = host_build_s
        print(json.dumps(_line(metric, r, per_iter_ms, crd)),
              file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    sdp127 = ClusteredLowRankSDP(delsarte_problem(3, 127, Fraction(1, 2)))
    build127 = time.perf_counter() - t0
    tier("ipm_ms_per_iter_delsarte_3_127_schur_dominated", True, sdp127,
         build127, n_iters=10, report_mfu=True)
    tier("ipm_iterations_per_s_delsarte_3_10_hi_nw8", False, p10, n_iters=10,
         nw=8, report_mfu=True)
    tier("ipm_iterations_per_s_delsarte_3_10_f64_nw2", False, p10,
         n_iters=20, substrate="f64", report_mfu=True)
    tier("ipm_ms_per_iter_delsarte_3_127_f64_nw2", True, sdp127, build127,
         n_iters=10, substrate="f64", report_mfu=True)

    from clrs_tpu_torch.solver.timing import print_breakdown

    ds = DeviceSDP(ClusteredLowRankSDP(p10), nw=5, device="cuda")
    print("print_breakdown, delsarte(3,10) f32 nw 5, initial state:",
          file=sys.stderr, flush=True)
    with contextlib.redirect_stdout(sys.stderr):
        print_breakdown(ds, initial_state(ds, 100.0, 100.0))
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
