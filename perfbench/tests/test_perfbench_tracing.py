"""The readers of the program's own spans and counters on a synthetic
snapshot of ``clrs_tpu_torch.tracing``: each new metric's arithmetic, and
nothing read without graph replays or without the module. CPU only."""

import statistics
import sys

import pytest

from perfbench.harness import manifest
from perfbench.harness.cell import Run

PHASES = ("chol", "schur", "kkt", "direction", "steplen", "update")
NEW = ("launch_ms_per_iter", "host_wait_ms_per_iter",
       "host_other_ms_per_iter", "graph_ms_per_iter", "graph_ms_spread",
       *(f"phase_{p}_ms_per_iter" for p in PHASES), "torch_nodes_per_iter",
       "preprocess_s", "device_sdp_s")
RUN = Run(setup_s=1.0, window_s=1.0, solves=[], host_build_s=[],
          capture_s=[])


def span(count, total, self_=None):
    return {"count": count, "total_ns": total,
            "self_ns": total if self_ is None else self_, "parent": None,
            "solve": 1}


def bucket(replays=100):
    graph_ms = [2.0, 2.1, 1.9, 2.0, 2.2, 1.8, 2.0, 2.05, 1.95, 2.0]
    return {
        "spans": {
            "compile.preprocess": span(8, 4_000_000_000),
            "compile.device_sdp": span(8, 2_500_000_000),
            "chunk": span(100, 300_000_000, 20_000_000),
            "chunk.copy_in": span(100, 5_000_000),
            "chunk.launch": span(100, 90_000_000, 50_000_000),
            "graph.first_replay": span(2, 40_000_000),
            "host_read": span(101, 150_000_000, 15_000_000),
            "host_read.wait": span(101, 135_000_000),
        },
        "counters": {"graph.replays": replays,
                     "graph.torch_nodes": 41_000 * replays // 100},
        "phases": {p: {"samples": 10, "total_ms": 10 * (i + 1) / 7.0}
                   for i, p in enumerate(PHASES)},
        "graph_ms": graph_ms, "graph_ms_samples": 10,
        "graph_ms_total": 30.0,
    }


@pytest.fixture
def snapshot(monkeypatch):
    from clrs_tpu_torch import tracing
    snap = {"enabled": True, "solve": 3, "graphs": [],
            "unprofiled": bucket(), "profiled": bucket(replays=7)}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    return snap


def read(name):
    return manifest.metric_reader(name).read(RUN)


def test_every_new_metric_is_in_the_benchmark_with_a_reader():
    import json
    from pathlib import Path
    bench = json.loads((Path(__file__).resolve().parents[2]
                        / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-len(NEW):] == list(NEW)
    for m in bench["per_layer"][-len(NEW):]:
        assert "workloads" not in m and m["source"] in ("program_span",
                                                        "program_counter")


def test_host_metrics_read_the_unprofiled_spans(snapshot):
    # launches after each graph's first: 100 - 2
    assert read("launch_ms_per_iter") == pytest.approx(50 / 98)
    assert read("host_wait_ms_per_iter") == pytest.approx(1.35)
    assert read("host_other_ms_per_iter") == pytest.approx(
        (20 + 5 + 15) / 100)
    assert read("torch_nodes_per_iter") == pytest.approx(410)
    assert read("preprocess_s") == pytest.approx(4.0)
    assert read("device_sdp_s") == pytest.approx(2.5)
    # a first run's kernel build inside DeviceSDP is not the problem's
    snapshot["unprofiled"]["spans"]["kernels.build"] = dict(
        span(1, 1_500_000_000), parent="compile.device_sdp")
    assert read("device_sdp_s") == pytest.approx(1.0)


def test_device_metrics_read_the_sampled_graph_times(snapshot):
    b = snapshot["unprofiled"]
    phases = [read(f"phase_{p}_ms_per_iter") for p in PHASES]
    assert phases == pytest.approx([(i + 1) / 7.0 for i in range(6)])
    assert read("graph_ms_per_iter") == pytest.approx(3.0)
    assert sum(phases) == pytest.approx(read("graph_ms_per_iter"))
    q = statistics.quantiles(b["graph_ms"], n=10, method="inclusive")
    assert read("graph_ms_spread") == pytest.approx(
        100 * (q[8] - q[0]) / q[4])


def test_nothing_without_replays_or_samples(snapshot):
    u = snapshot["unprofiled"]
    u["graph_ms_samples"] = 0
    u["graph_ms"] = []
    for name in ("graph_ms_per_iter", "graph_ms_spread",
                 *(f"phase_{p}_ms_per_iter" for p in PHASES)):
        assert read(name) is None, name
    assert read("launch_ms_per_iter") is not None
    u["counters"] = {}
    for name in NEW:
        assert read(name) is None, name


def test_nothing_where_the_program_keeps_no_spans(monkeypatch):
    import clrs_tpu_torch
    monkeypatch.delattr(clrs_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "clrs_tpu_torch.tracing", None)
    for name in NEW:
        assert read(name) is None, name
