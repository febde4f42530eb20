"""What the port's tracing (clrs_tpu_torch/tracing.py) costs end to end on
the card: windows of whole delsarte(3,10) solves, as the benchmark's cell
``delsarte-3.d10`` runs them, in rounds of three, the order rotating:
tracing on (the default); the same graphs with
``tracing.configure(enabled=False)`` (the host's spans and counters
taken away, the graph's timing events kept); instances captured with
tracing off (graphs with no events). Then the same rounds under a
``torch.profiler`` recording host and device activity (with tracing on,
the spans are ranges in its trace). Then the graphs alone: rounds of
back-to-back replays, each followed by a sync as the solve loop's host
read follows it, of one instance's graph captured with tracing on
(events) and with it off. Prints one JSON line per window or round, the
host spans per replay of the windows with tracing on, and a summary
line: medians and quartiles of ``iter_ms`` (and of ms per synced replay)
each way, the ratios of the medians and the median of the ratios within
rounds.

    python3 torch_tracing_cost.py --rounds 12 --seconds 5
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


def card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip()


def instances(cell, on):
    from clrs_tpu_torch import tracing
    from perfbench.harness import manifest
    from perfbench.harness.cell import instance_params
    from perfbench.harness.solve import Instance, default_words, solve_settings
    fam = manifest.family(cell.config["family"])
    tracing.configure(on)
    try:
        return [Instance((lambda p=p: fam.build(p)),
                         solve_settings(cell.config), default_words(), "cuda")
                for p in instance_params(cell.config, cell.traffic, 1)]
    finally:
        tracing.configure(True)


def window(insts, seconds, on, profiler):
    """iter_ms of one window of ``insts`` with tracing ``on`` or off, under
    a profiler recording host and device activity or none."""
    import torch
    from clrs_tpu_torch import tracing
    from perfbench.harness.cell import window as run_window
    tracing.configure(on)
    try:
        torch.cuda.synchronize()
        if profiler:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                wall, solves, _ = run_window(insts, seconds)
        else:
            wall, solves, _ = run_window(insts, seconds)
    finally:
        tracing.configure(True)
    its = sum(s.iterations for s in solves)
    return 1e3 * wall / its


def synced_replays(insts, replays):
    """Host ms per replay of each instance's graph, each followed by a
    sync (the graphs alone: no copy-in, no host read)."""
    import torch
    out = []
    for x in insts:
        graph = x.run.loop["split"].graph.graph
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(replays):
            graph.replay()
            torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / replays)
    return statistics.mean(out)


def summary(v):
    q = statistics.quantiles(v, n=4)
    return {"median": statistics.median(v), "q1": q[0], "q3": q[2],
            "n": len(v)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="delsarte-3.d10")
    ap.add_argument("--rounds", type=int, default=12,
                    help="rounds of three windows without the profiler")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--profiled-rounds", type=int, default=6,
                    help="rounds of three windows under the profiler")
    ap.add_argument("--profiled-seconds", type=float, default=0.5)
    ap.add_argument("--replay-rounds", type=int, default=12,
                    help="rounds of synced replays, both ways")
    ap.add_argument("--replays", type=int, default=100,
                    help="synced replays of each instance's graph a round")
    args = ap.parse_args()
    from clrs_tpu_torch import tracing
    from perfbench.harness import manifest
    bench = manifest.load_bench(ROOT)
    cell = manifest.cell(ROOT, bench, args.cell)
    t0 = time.perf_counter()
    ins = {True: instances(cell, True), False: instances(cell, False)}
    print(json.dumps({"card": card(), "setup_s": time.perf_counter() - t0}),
          flush=True)
    tracing.reset()
    out = {}
    # rounds of three, the order rotating: tracing on; the same graphs with
    # tracing off (the host's spans and counters alone taken away); the
    # graphs captured with tracing off (no events)
    sides = (("on", ins[True], True), ("spans_off", ins[True], False),
             ("captured_off", ins[False], False))
    for profiler, rounds, secs in ((False, args.rounds, args.seconds),
                                   (True, args.profiled_rounds,
                                    args.profiled_seconds)):
        for i in range(rounds):
            for k in range(3):
                name, insts, on = sides[(i + k) % 3]
                ms = window(insts, secs, on, profiler)
                out.setdefault((profiler, name), []).append(ms)
                print(json.dumps({"profiler": profiler, "side": name,
                                  "round": i, "iter_ms": ms}), flush=True)
    # the graphs alone, events against none, the order alternating
    for i in range(args.replay_rounds):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            ms = synced_replays(ins[on], args.replays)
            name = "synced_on" if on else "synced_captured_off"
            out.setdefault((False, name), []).append(ms)
            print(json.dumps({"side": name, "round": i,
                              "ms_per_replay": ms}), flush=True)
    # the host's spans of the windows with tracing on, per graph replay
    snap = tracing.snapshot()["unprofiled"]
    n = snap["counters"]["graph.replays"]
    print(json.dumps({"replays": n, "spans_ms_per_replay": {
        k: {"total": 1e-6 * v["total_ns"] / n, "self": 1e-6 * v["self_ns"] / n,
            "count": v["count"]} for k, v in snap["spans"].items()}}),
        flush=True)
    res = {f"{'profiled' if p else 'plain'}_{name}": summary(v)
           for (p, name), v in out.items()}
    for p in (False, True):
        for a, b in (("on", "captured_off"), ("on", "spans_off"),
                     ("spans_off", "captured_off"),
                     ("synced_on", "synced_captured_off")):
            if (p, a) not in out:
                continue
            x, y = out[(p, a)], out[(p, b)]
            key = f"{'profiled' if p else 'plain'}_{a}_over_{b}"
            res[key + "_pct"] = 100.0 * (statistics.median(x)
                                         / statistics.median(y) - 1.0)
            res[key + "_pair_median"] = statistics.median(
                u / v for u, v in zip(x, y))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
