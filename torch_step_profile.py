"""Profile steady IPM iterations of the PyTorch/CUDA port on one card.

Solves delsarte(3, d) (clrs_tpu_torch.examples, as chip_smoke.py does) with
``clrs_tpu_torch.solvesdp(device="cuda")`` for ``--warmup`` + 2 x
``--iters`` iterations and reads the loop at its iteration boundaries (the
solver's callback, after a device sync): the first ``--iters`` steady
iterations are timed on the host clock, the next ``--iters`` run under
torch.profiler. Prints one JSON line: wall ms per iteration (unprofiled
and profiled), device kernels per iteration, device busy ms and share per
iteration (kernels run on one stream, so their times add), the port's
kernel launches per iteration (clrs_tpu_torch.dd.kernels counters, the two
forms of the triangular solve apart), the calls and device ms per
iteration of each of the port's CUDA kernels (by template instance) and the
largest device times by kernel name. Run it from the root of a checkout
(the package is imported from beside the script, so a copy of the script in
another checkout profiles that checkout) on a machine with a card:

    python3 torch_step_profile.py --d 10 --warmup 3 --iters 3
    python3 torch_step_profile.py --d 95 --warmup 1 --iters 1
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
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import clrs_tpu_torch as ct
    from clrs_tpu_torch.dd import kernels as K
    from clrs_tpu_torch.examples import delsarte_problem

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    W, N = args.warmup, args.iters
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks, launches = {}, {}

    def cb(it, info):
        torch.cuda.synchronize()
        marks[it] = time.time()
        if it == W + N:
            K.reset_counts()
            prof.start()
        elif it == W + 2 * N:
            prof.stop()
            plain = {f.__name__ for f in K._PLAIN}
            launches.update({k: v / N for k, v in K.counts().items()
                             if k not in plain})

    problem = delsarte_problem(3, args.d, Fraction(1, 2))
    ct.solvesdp(problem, device="cuda", omega_p=100, omega_d=100,
                dual_error_threshold=1e-12, primal_error_threshold=1e-12,
                maxiterations=W + 2 * N, verbose=False, callback=cb)
    if len(marks) != W + 2 * N:
        sys.exit(f"the solve stopped after {len(marks)} iterations")
    wall = 1e3 * (marks[W + N] - marks[W]) / N
    wall_prof = 1e3 * (marks[W + 2 * N] - marks[W + N]) / N
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
    print(json.dumps({
        "card": card, "checkout": str(Path(__file__).resolve().parent),
        "problem": f"delsarte(3,{args.d})", "warmup": W, "iters": N,
        "wall_ms_per_iteration": wall,
        "wall_ms_per_iteration_profiled": wall_prof,
        "device_kernels_per_iteration": len(dev) / N,
        "device_busy_ms_per_iteration": busy if dev else None,
        "device_busy_share": busy / wall_prof if dev else None,
        "port_launches_per_iteration": launches,
        "port_kernel_calls_and_device_ms_per_iteration": {
            k: [c / N, t / N] for k, (c, t) in sorted(port.items())},
        "top_device_ms_per_iteration": {
            nm[:90]: [c / N, t / N] for nm, (c, t) in top},
    }), flush=True)


if __name__ == "__main__":
    main()
