"""One run of one cell: set-up, the measured window of whole solves, the
traced span (``--trace 1``), the answers judged by the plain reference,
and the result line."""

from __future__ import annotations

import gc
import random
import subprocess
import time
from dataclasses import dataclass, field
from fractions import Fraction

import torch

from . import manifest, trace
from .answers import plain
from .roofline import least_ms
from .solve import Instance, default_words, solve_settings


@dataclass
class Solve:
    instance: int
    seconds: float
    iterations: int
    code: int
    converged: bool

    @property
    def failed(self):
        return self.code != 0 or not self.converged


@dataclass
class Run:
    """What the metric readers read (``perfbench/metrics/<name>.py``)."""
    setup_s: float
    window_s: float
    solves: list
    host_build_s: list
    capture_s: list
    profile: dict = None
    least_ms_per_iter: tuple = None
    card: dict = field(default_factory=dict)


def card():
    """The card's name and power limit, as nvidia-smi gives them
    (``torch_bench.py::card``, copied)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    name, limit = (p.strip() for p in
                   r.stdout.strip().splitlines()[0].split(","))
    return {"name": name, "power.limit": limit}


def instance_params(config: dict, traffic: dict, seed: int) -> list:
    """The cell's instances: the configuration's problem with the mix's
    overrides, the varied key taking the first ``instances`` entries of
    the configuration's list, in an order drawn from ``seed`` (every seed
    gets the same work)."""
    base = dict(config["problem"], **traffic.get("problem", {}))
    key, choices = config["vary"]["key"], config["vary"]["choices"]
    k = int(traffic["instances"])
    if not 1 <= k <= len(choices):
        raise ValueError(f"{k} instances from a list of {len(choices)}")
    order = list(range(k))
    random.Random(seed).shuffle(order)
    return [dict(base, **{key: choices[i]}) for i in order]


def window(instances, seconds):
    """Whole solves, instances in turn, until ``seconds`` have passed; the
    window ends at the end of the last solve. Returns (seconds, solves,
    each solve's final state words)."""
    solves, kept = [], []
    k = len(instances)
    t_start = time.perf_counter()
    i = 0
    while True:
        inst = instances[i % k]
        t0 = time.perf_counter()
        it, code, conv = inst.solve()
        t1 = time.perf_counter()
        kept.append(inst.keep())
        solves.append(Solve(i % k, t1 - t0, it, code, conv))
        i += 1
        if t1 - t_start >= seconds:
            return t1 - t_start, solves, kept


def distinct_answers(instances, solves, kept):
    """Every distinct final state of each instance (equal words: one
    answer), extracted by the port's own ``_extract`` into plain
    rationals. Returns ([(instance index, answer)], {index: distinct})."""
    out, counts = [], {}
    for i, inst in enumerate(instances):
        rows = [kept[j] for j, s in enumerate(solves) if s.instance == i]
        if not rows:
            continue
        words = torch.stack(rows).view(torch.int32)
        uniq = torch.unique(words, dim=0)
        counts[i] = int(uniq.shape[0])
        for row in uniq:
            out.append((i, plain(*inst.answer(row.view(torch.float32)))))
    return out, counts


def judge(ref, params, answers, limits):
    """Each number the reference compares, worst over the answers, beside
    its limit."""
    worst = {}
    for i, ans in answers:
        for name, v in ref.check(params[i], ans).items():
            worst[name] = max(worst.get(name, v), v)
    missing = set(limits) - set(worst)
    if missing:
        raise KeyError(f"limits for numbers the reference does not give: "
                       f"{sorted(missing)}")
    return {name: {"value": worst[name], "limit": limits[name]}
            for name in sorted(limits)}


def run_cell(bench_cell, seed, seconds, trace_on, device, t0):
    """(result line as a dict, lines for standard error)."""
    cfg, mix = bench_cell.config, bench_cell.traffic
    fam = manifest.family(cfg["family"])
    ref = manifest.reference(cfg["family"])
    settings = solve_settings(cfg)
    nw = default_words()
    params = instance_params(cfg, mix, seed)
    on_card = torch.device(device).type == "cuda"

    instances = [Instance((lambda p=p: fam.build(p)), settings, nw, device,
                          spans=trace_on)
                 for p in params]
    setup_s = time.perf_counter() - t0
    window_s, solves, kept = window(instances, seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else None

    run = Run(setup_s=setup_s, window_s=window_s, solves=solves,
              host_build_s=[x.host_build_s for x in instances],
              capture_s=[x.capture_s for x in instances])
    if trace_on:
        run.profile = trace.profile(instances, list(range(len(instances))),
                                    int(mix["profile_solves"]))
        run.least_ms_per_iter = least_ms(ref.shape(params[0]), nw)
    if on_card:
        run.card = card()

    answers, distinct = distinct_answers(instances, solves, kept)
    del instances, kept
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = judge(ref, [_exact(p) for p in params], answers,
                   mix["limits"])
    ref_s = time.perf_counter() - t_ref

    failed = sum(s.failed for s in solves)
    correct = (failed == 0 and bool(solves)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    for m in (bench_cell.per_layer if trace_on else bench_cell.end_to_end):
        v = manifest.metric_reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name() if on_card
                    else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if on_card:
        dev["power_limit"] = run.card.get("power.limit")
    result = {"correct": correct, "attempted": len(solves),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_on:
        prof = run.profile
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["span_s"]
        result["breakdown"] = {
            "device_ops": [[n[:160], t] for n, t in prof["device_ops"]],
            "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    codes = {}
    for s in solves:
        key = f"code {s.code}" + ("" if s.converged else " unconverged")
        codes[key] = codes.get(key, 0) + 1
    notes = [f"instances {[p[cfg['vary']['key']] for p in params]} "
             f"distinct answers {distinct} solves {codes} "
             f"reference {ref_s:.3f} s"]
    notes += [f"check {k} {c['value']!r} limit {c['limit']!r}"
              for k, c in checks.items()]
    return result, notes


def _exact(p):
    """Problem parameters with rationals given as strings made exact."""
    return {k: Fraction(v) if isinstance(v, str) else v
            for k, v in p.items()}
