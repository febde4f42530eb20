"""Profile steady IPM iterations of the PyTorch/CUDA port on one card.

Solves delsarte(3, d) (clrs_tpu_torch.examples, as chip_smoke.py does) from
omega 100 I on the f32 substrate (nw 5; ``--substrate f64``: f64 words,
nw 2 unless ``--nw`` says otherwise), either by the eager step
(``--mode eager``: make_step_body, every kernel launched by the host) or
through the step's CUDA graphs (``--mode graph``: make_run_chunk with
chunks of one, as solvesdp runs by default), each iteration ending in the
one host read of its info that solvesdp makes (chip_smoke.drive). The
first iteration warms up (and captures the graphs); the next ``--iters``
are timed on the host clock, synchronised, and ``--iters`` more run under
torch.profiler.
Prints one JSON line: wall ms per iteration (unprofiled and profiled),
device kernels per iteration, device busy ms and share per iteration
(kernels run on one stream, so their times add), host launch calls per
iteration (the CUDA runtime and driver calls that launch a kernel or a
graph or copy memory), peak device memory, the capture seconds, the
port's kernel launches per iteration (clrs_tpu_torch.dd.kernels counters,
the two forms of the triangular solve apart), the calls and device ms per
iteration of each of the port's CUDA kernels (by template instance), the
same summed over the step's expansion arithmetic (the expmap, tree_sum,
expfuse and expselect instances of csrc/expmap.cu, exptree.cu and
expfuse.cu) and over PyTorch's own kernels, the step-length eigensolver's
kernels apart (the port's eig_lowest, eig_pairs and eig_pairs_vec
kernels of csrc/eig.cu, and every kernel that ran inside the step's
eigensolver call where it runs eagerly, as cuSOLVER's did), the shapes
of the eigensolver's inputs with the time of one torch.linalg.eigvalsh (f64) or eigh (f32) call on a
random symmetric input of each (cuSOLVER, CUDA events around calls that
each wait on the host for cuSOLVER's info; ``--no-library`` skips them),
and the largest device times by kernel name. With ``--sites`` it profiles one eager chunk iteration
(the step and the commit, make_run_chunk without graphs) instead and
prints the kernels that are not the port's by call site: every PyTorch op
runs inside a ``torch.profiler.record_function`` named after the
innermost line of clrs_tpu_torch that called it (and the line of
solver/step.py above it), and each site's device kernels and ms are
summed from the profiler's op tree. Run it from the root of a
checkout (the package is imported from beside the script, so a copy of
the script in another checkout profiles that checkout) on a machine with
a card:

    python3 torch_step_profile.py --d 10 --iters 3 --mode graph
    python3 torch_step_profile.py --d 95 --iters 1 --mode eager
    python3 torch_step_profile.py --d 10 --iters 3 --substrate f64
    python3 torch_step_profile.py --d 10 --sites
    python3 torch_step_profile.py --d 95 --iters 2 --mode graph --certified

Run one profile per process: torch.profiler loses device records in a
process after a session with hundreds of thousands of them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--mode", choices=("eager", "graph"), default="graph")
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--substrate", choices=("f32", "f64"), default="f32")
    ap.add_argument("--nw", type=int, default=None,
                    help="words (default 5 on f32, 2 on f64)")
    ap.add_argument("--no-library", action="store_true",
                    help="skip the cuSOLVER times at the eigensolver's "
                    "input shapes")
    ap.add_argument("--certified", action="store_true",
                    help="the certified step-length route (solver.step."
                    "_STEPLEN_VERIFIED = True: f32 eigenpairs, certified)")
    ap.add_argument("--sites", action="store_true",
                    help="the kernels that are not the port's, by call "
                    "site, in one eager chunk iteration")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import device_sdp, drive
    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.examples import delsarte_problem
    from clrs_tpu_torch.solver import step as TS

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    N = args.iters
    f64 = args.substrate == "f64"
    nw = args.nw or (2 if f64 else 5)
    ds = device_sdp(delsarte_problem(3, args.d, Fraction(1, 2)), nw=nw,
                    dtype=torch.float64 if f64 else torch.float32)
    if args.sites:
        print(json.dumps(dict(card=card, problem=f"delsarte(3,{args.d})",
                              substrate=args.substrate, nw=nw,
                              **sites(ds, args.top))), flush=True)
        return
    eig_inputs = set()
    step_eig = TS.step_eig

    def traced_eig(mats):
        eig_inputs.update((tuple(A.shape), str(A.dtype)) for A in mats)
        with record_function("eigensolver"):
            return step_eig(mats)

    TS.step_eig = traced_eig     # the loop takes it up when it is set up
    if args.certified:
        TS._STEPLEN_VERIFIED = True
    stats, _, one = drive(ds, args.mode, N)
    K.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(N):
            one()
        torch.cuda.synchronize()
        wall_prof = 1e3 * (time.perf_counter() - t0) / N
    plain = {f.__name__ for f in K._PLAIN}
    launches = {k: v / N for k, v in K.counts().items() if k not in plain}
    dev, host = [], 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(e)
        elif e.name.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                                "cudaMemcpy", "cudaMemset")):
            host += 1
    by_name = {}
    for e in dev:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us() / 1e3)
    busy = sum(t for _, t in by_name.values()) / N
    # the port's own kernels (each source of csrc/ keeps them in a top-level
    # anonymous namespace; PyTorch's lie under at::), by name and template
    # arguments
    port = {}
    for nm, (c, t) in by_name.items():
        head, sep, rest = nm.partition("(anonymous namespace)::")
        if sep and head in ("", "void "):
            key = rest.split("(", 1)[0]
            pc, pt = port.get(key, (0, 0.0))
            port[key] = (pc + c, pt + t)
    expansion = [sum(v[i] for k, v in port.items()
                     if k.startswith(("expmap<", "tree_sum<", "expfuse<",
                                      "expselect<")))
                 for i in (0, 1)]
    ported = [sum(v[i] for v in port.values()) for i in (0, 1)]
    torch_own = [len(dev) - ported[0],
                 sum(t for _, t in by_name.values()) - ported[1]]
    eig = eigensolver_kernels(prof, port)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
    print(json.dumps({
        "card": card, "checkout": str(Path(__file__).resolve().parent),
        "problem": f"delsarte(3,{args.d})", "substrate": args.substrate,
        "nw": nw, "mode": args.mode, "certified": args.certified,
        "iters": N,
        "wall_ms_per_iteration": stats["wall_ms"],
        "wall_ms_per_iteration_profiled": wall_prof,
        "device_kernels_per_iteration": len(dev) / N,
        "device_busy_ms_per_iteration": busy if dev else None,
        "device_busy_share": busy / stats["wall_ms"] if dev else None,
        "host_launch_calls_per_iteration": host / N,
        "host_calls_per_iteration": stats.get("host_calls"),
        "peak_device_mib": stats["peak_mib"],
        "peak_device_mib_above_held": stats["peak_above_held_mib"],
        "capture_s": stats.get("capture_s"),
        "port_launches_per_iteration": launches,
        "port_kernel_calls_and_device_ms_per_iteration": {
            k: [c / N, t / N] for k, (c, t) in sorted(port.items())},
        "expansion_kernel_calls_and_device_ms_per_iteration":
            [v / N for v in expansion],
        "pytorch_kernel_calls_and_device_ms_per_iteration":
            [v / N for v in torch_own],
        "eigensolver_kernel_calls_and_device_ms_per_iteration":
            [v / N for v in eig],
        "eigensolver_inputs": sorted(eig_inputs),
        "library_eig_ms": None if args.no_library else {
            f"{dt} {list(sh)}": library_eig_ms(sh, dt)
            for sh, dt in sorted(eig_inputs)},
        "top_device_ms_per_iteration": {
            nm[:90]: [c / N, t / N] for nm, (c, t) in top},
    }), flush=True)


def eigensolver_kernels(prof, port):
    """[calls, device ms] of the step-length eigensolver in a profile: the
    port's eig_* kernels (captured in the step's graph or launched
    eagerly) and every other kernel launched inside an eager eigensolver
    call (the ``eigensolver`` range of main's wrapper)."""
    calls = sum(c for k, (c, _) in port.items() if k.startswith("eig_"))
    ms = sum(t for k, (_, t) in port.items() if k.startswith("eig_"))

    def kernels(e):
        return [k for k in e.kernels
                if "(anonymous namespace)::eig_" not in k.name] + [
                    k for c in e.cpu_children for k in kernels(c)]

    for e in prof.events():
        if e.name == "eigensolver":
            ks = kernels(e)
            calls += len(ks)
            ms += sum(k.duration for k in ks) / 1e3
    return calls, ms


def library_eig_ms(shape, dtype):
    """ms of one cuSOLVER call (torch.linalg.eigvalsh for float64 input,
    eigh for float32) on a random symmetric batch of ``shape``, by CUDA
    events (chip_smoke.time_ms)."""
    import numpy as np
    import torch

    from chip_smoke import time_ms

    a = np.random.default_rng(0).standard_normal(shape)
    dt = torch.float64 if dtype == "torch.float64" else torch.float32
    A = torch.tensor(a + np.swapaxes(a, -1, -2), dtype=dt, device="cuda")
    fn = torch.linalg.eigvalsh if dt == torch.float64 else torch.linalg.eigh
    return time_ms(lambda: fn(A), reps=5)


def _site():
    """'file:line' of the innermost frame of clrs_tpu_torch calling, and
    ' < solver/step.py:line' of the innermost step frame above it."""
    f = sys._getframe(2)
    inner = step = None
    while f is not None:
        name = f.f_code.co_filename
        if "clrs_tpu_torch" in name:
            rel = name.split("clrs_tpu_torch/", 1)[1]
            if inner is None:
                inner = f"{rel}:{f.f_lineno}"
            if rel == "solver/step.py":
                step = f"{rel}:{f.f_lineno}"
                break
        f = f.f_back
    if inner is None:
        return "outside clrs_tpu_torch"
    return inner if step in (None, inner) else f"{inner} < {step}"


def sites(ds, top):
    """{kernels, ms: the kernels that are not the port's in one eager
    chunk iteration; sites: the ``top`` call sites by device ms, each
    [kernels, ms]}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils._python_dispatch import TorchDispatchMode

    from chip_smoke import STEP_KW
    from clrs_tpu_torch.solver import step as TS
    from clrs_tpu_torch.solver.ipm import _to_host

    class BySite(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            with record_function("site " + _site()):
                return func(*a, **(kw or {}))

    TS._CAPTURE = False
    state = TS.initial_state(ds, 100.0, 100.0)
    info = TS.zero_info(_to_host(TS.make_assess(ds)(state)), ds.device)
    run = TS.make_run_chunk(ds, duality_gap_threshold=1e-15, **STEP_KW)
    carry = list(run(state, False, info, 1)[:3])     # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with BySite():
            run(*carry, 1)
        torch.cuda.synchronize()

    def kernels(e):
        n = len(e.kernels) + sum(kernels(c) for c in e.cpu_children)
        return n

    by = {}
    for e in prof.events():
        if e.name.startswith("site ") and (
                e.cpu_parent is None
                or not e.cpu_parent.name.startswith("site ")):
            n, t = by.get(e.name[5:], (0, 0.0))
            by[e.name[5:]] = (n + kernels(e),
                              t + e.device_time_total / 1e3)
    total = [sum(v[0] for v in by.values()), sum(v[1] for v in by.values())]
    ranked = sorted(by.items(), key=lambda kv: -kv[1][1])
    return {"kernels_not_the_ports": total[0], "ms": total[1],
            "sites": len(by),
            "top_sites": {k: [n, t] for k, (n, t) in ranked[:top]}}


if __name__ == "__main__":
    main()
