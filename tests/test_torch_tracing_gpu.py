"""The step graph's timing events and kernel-node counts on the card
(clrs_tpu_torch/tracing.py, solver/graph.py); they skip without one.
Imports nothing of JAX. From the repository root, on a machine with a
card:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing_gpu.py -q -s
"""

import json
import statistics
from pathlib import Path

import pytest
import torch

from clrs_tpu_torch import tracing as T
from clrs_tpu_torch.dd import kernels as K

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def instance(captured_on=True):
    """delsarte(3,10) at 1/2 as the benchmark's cell sets it up (one warm
    solve, which captures the graph), with tracing on or off at capture."""
    from perfbench.harness import manifest
    from perfbench.harness.cell import instance_params
    from perfbench.harness.solve import Instance, default_words, solve_settings
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = manifest.cell(ROOT, bench, "delsarte-3.d10")
    fam = manifest.family(cell.config["family"])
    p = [q for q in instance_params(cell.config, cell.traffic, 0)
         if q["costheta"] == "1/2"][0]
    T.configure(captured_on)
    try:
        return Instance(lambda: fam.build(p), solve_settings(cell.config),
                        default_words(), "cuda")
    finally:
        T.configure(True)


@pytest.fixture(scope="module")
def inst(cuda):
    return instance()


def profiled(fn, cpu=True):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, prof.events()


def reduced(events, iterations=1):
    from perfbench.harness import trace
    return trace.reduce(events, iterations, 1.0, 1)


@pytest.mark.gpu
def test_phases_sum_to_the_graph_time(inst):
    T.reset()
    for _ in range(3):
        inst.solve()
    b = T.snapshot()["unprofiled"]
    assert b["graph_ms_samples"] >= 3
    assert set(b["phases"]) == set(T.PHASES)
    phases = {k: v["total_ms"] / v["samples"] for k, v in b["phases"].items()}
    graph = b["graph_ms_total"] / b["graph_ms_samples"]
    print("phases ms", phases, "graph ms", graph)
    assert sum(phases.values()) == pytest.approx(graph, rel=0.01)
    assert all(v > 0 for v in phases.values())


@pytest.mark.gpu
def test_graph_nodes_and_eager_launches_are_the_traced_kernels(inst):
    split = inst.run.loop["split"]
    info = split.times.info
    nodes = sum(info["kernel_nodes"])
    S, pd, info_buf, it, code, _ = inst.run.loop["carry"]

    def eager():                # a chunk's own launches and its host read
        inst.run(S, pd, info_buf, 0)
        inst._to_host(info_buf, it_done=it, code=code)

    _, ev = profiled(eager, cpu=False)
    eager_k = reduced(ev)["kernels"]
    T.reset()
    (its, _, _), ev = profiled(inst.solve, cpu=False)
    red = reduced(ev, its)
    replays = T.snapshot()["profiled"]["counters"]["graph.replays"]
    want = replays * (nodes + eager_k)
    print(f"phases {info['phases']} kernel nodes {info['kernel_nodes']} "
          f"port {info['port_launches']} eager {eager_k} replays {replays} "
          f"traced kernels {red['kernels']} predicted {want}")
    assert red["kernels"] == pytest.approx(want, rel=0.01)
    # the port's own kernels in the trace are the launches its wrappers
    # counted at capture
    port = sum(1 for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
               and is_port(e.name))
    assert port == pytest.approx(replays * sum(info["port_launches"]),
                                 rel=0.01)


def is_port(name):
    from perfbench.harness.trace import is_port_kernel
    return is_port_kernel(name)


@pytest.mark.gpu
def test_spans_and_events_are_not_device_work(inst):
    """Three solves a side, tracing on (spans, graph events) and off (a
    graph captured without events), in alternating rounds: the first
    recording host activity too (the spans' ranges), the six others the
    device's alone, as the harness's traced solves that give ``busy_s``
    (which spreads by about 2% from one profile to the next on an H100:
    the medians are compared)."""
    off = instance(captured_on=False)
    assert off.run.loop["split"].times is None
    got = {True: [], False: []}
    for rnd in range(7):
        sides = ((inst, True), (off, False))
        for x, on in sides if rnd % 2 == 0 else sides[::-1]:
            T.configure(on)
            try:
                (its, _, _), ev = profiled(
                    lambda: [x.solve() for _ in range(3)][0], cpu=rnd == 0)
            finally:
                T.configure(True)
            dev = [e.name for e in ev
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            assert not any(n.startswith("clrs.") for n in dev)
            if rnd == 0:
                host = [e.name for e in ev
                        if e.device_type != torch.autograd.DeviceType.CUDA]
                assert any(n == "clrs.chunk.launch" for n in host) == on
            else:
                got[on].append(reduced(ev, its))
    print({k: [(r["kernels"], r["busy_s"],
                r["port_kernel_s"] + r["torch_kernel_s"]) for r in v]
           for k, v in got.items()})
    # a device-only profile now and then drops some of a graph's kernel
    # records (seen on an H100 with the graph without events: 61,011 and
    # 61,608 of 61,743), and never adds one: the full count is the work
    full = {on: max(r["kernels"] for r in got[on]) for on in got}
    assert full[True] == full[False]
    # the graph with its timing events ends every solve word for word as
    # the graph captured with tracing off
    assert torch.equal(inst.keep(), off.keep())
    busy = {on: statistics.median(r["busy_s"] for r in got[on]
                                  if r["kernels"] == full[on]) for on in got}
    assert busy[True] == pytest.approx(busy[False], rel=0.01)


@pytest.mark.gpu
def test_replays_count_their_launches_lazily(inst):
    K.reset_counts()
    its, _, _ = inst.solve()
    seg = inst.run.loop["split"].graph
    c = K.counts()
    assert seg.replays >= its
    for name, n in seg.launches.items():
        assert c[name] >= n * seg.replays
