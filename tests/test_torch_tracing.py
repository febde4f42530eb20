"""The port's spans and counters (clrs_tpu_torch/tracing.py) on the CPU:
nesting and self time, the profiled and unprofiled buckets, reset and
snapshot, a CPU solve's spans under one solve id, tracing turned off, the
graph's sampled phase times (with stand-in events) and the replay
tallies of the launch counters. No JAX."""

import json

import pytest
import torch

import clrs_tpu_torch as ct
from clrs_tpu_torch import tracing as T
from clrs_tpu_torch.dd import kernels as K
from clrs_tpu_torch.solver import graph as G
from torch_helpers import polyopt


@pytest.fixture(autouse=True)
def fresh():
    T.reset()
    T.configure(True)
    yield
    T.reset()
    T.configure(True)


@pytest.fixture
def clock(monkeypatch):
    """A clock that reads 0, 10, 20, ... ns, one step a read."""
    ticks = iter(range(0, 10 ** 9, 10))
    monkeypatch.setattr(T, "_clock", lambda: next(ticks))


def test_nested_spans_keep_total_and_self_time(clock):
    with T.span("a") as a:                  # reads 0 ... 70
        with T.span("b"):                   # 10 ... 20
            pass
        with T.span("b"):                   # 30 ... 60
            with T.span("c"):               # 40 ... 50
                pass
    s = T.snapshot()
    spans = s["unprofiled"]["spans"]
    assert a.ns == 70
    assert spans["a"] == {"count": 1, "total_ns": 70, "self_ns": 30,
                          "parent": None, "solve": s["solve"]}
    assert (spans["b"]["count"], spans["b"]["total_ns"],
            spans["b"]["self_ns"], spans["b"]["parent"]) == (2, 40, 30, "a")
    assert (spans["c"]["total_ns"], spans["c"]["parent"]) == (10, "b")


def test_timed_decorator_and_counters(clock):
    @T.timed("f")
    def f(x):
        """doc"""
        return x + 1

    assert f(1) == 2 and f.__doc__ == "doc"
    T.count("n")
    T.count("n", 4)
    b = T.snapshot()["unprofiled"]
    assert b["spans"]["f"]["count"] == 1 and b["counters"] == {"n": 5}


def test_profiled_work_goes_to_its_own_bucket():
    with T.span("outside"):
        T.count("k")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with T.span("inside"):
            with T.span("inner"):
                T.count("k", 2)
    s = T.snapshot()
    assert set(s["unprofiled"]["spans"]) == {"outside"}
    assert set(s["profiled"]["spans"]) == {"inside", "inner"}
    assert s["unprofiled"]["counters"] == {"k": 1}
    assert s["profiled"]["counters"] == {"k": 2}
    # the profiled spans are host ranges in the trace, named clrs.<span>
    names = [e.name for e in prof.events()]
    assert "clrs.inside" in names and "clrs.inner" in names


def test_snapshot_is_plain_and_reset_clears_it():
    with T.span("x"):
        T.count("c")
    s = T.snapshot()
    assert json.loads(json.dumps(s)) == s
    assert s["unprofiled"]["spans"]["x"]["count"] == 1
    T.reset()
    s = T.snapshot()
    for b in ("unprofiled", "profiled"):
        assert s[b]["spans"] == {} and s[b]["counters"] == {}
        assert s[b]["phases"] == {} and s[b]["graph_ms"] == []
    assert s["graphs"] == []


def test_turned_off_records_nothing():
    T.configure(enabled=False)
    with T.span("x") as x:
        T.count("c")
        T.open_solve()
    with T.phase_marks() as marks:
        T.phase("chol")
    T.replayed(None, T.SAMPLE_EVERY)
    s = T.snapshot()
    assert x.ns > 0 and marks is None and not s["enabled"]
    for b in ("unprofiled", "profiled"):
        assert s[b]["spans"] == {} and s[b]["counters"] == {}


def test_cpu_solve_fills_the_layers_spans_under_one_id():
    _, _, _, _, code = ct.solvesdp(polyopt(ct), device="cpu",
                                   substrate="f64", verbose=False)
    assert code == 0
    s = T.snapshot()
    b = s["unprofiled"]
    expected = {"compile.sdp", "compile.remove_empty", "compile.preprocess",
                "compile.device_sdp", "chunk", "chunk.copy_in",
                "chunk.launch", "host_read", "host_read.wait"}
    assert expected <= set(b["spans"])
    assert {b["spans"][k]["solve"] for k in expected} == {s["solve"]}
    assert b["spans"]["chunk.launch"]["parent"] == "chunk"
    assert b["spans"]["host_read.wait"]["parent"] == "host_read"
    # one host read a chunk, and the start's
    assert b["spans"]["host_read"]["count"] == b["spans"]["chunk"]["count"] + 1
    # no graph on the CPU
    assert "graph.replays" not in b["counters"] and s["graphs"] == []


def test_a_chunk_on_a_fresh_state_begins_a_solve():
    T.open_solve()                      # a solvesdp: its first chunk joins
    T.chunk_solve(True)
    first = T.snapshot()["solve"]
    T.chunk_solve(False)                # the loop's own carry
    assert T.snapshot()["solve"] == first
    T.chunk_solve(True)                 # a harness's next solve
    assert T.snapshot()["solve"] == first + 1


class FakeEvent:
    """A stand-in timing event at time ``t`` ms."""

    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return other.t - self.t

    def query(self):
        return True

    def record(self):
        self.recorded = getattr(self, "recorded", 0) + 1


def graph_times(times, names):
    marks = [(None, None, 100)]
    for i, name in enumerate(names + ["end"]):
        marks.append((name, None, 100 + 3 * i))
    nodes = [0] + [10 * (i + 1) for i in range(len(names))] + [0]
    return T.GraphTimes(marks, nodes, [FakeEvent(t) for t in times])


def test_sampled_phases_sum_to_the_graph_time():
    names = ["chol", "schur", "kkt", "schur", "kkt", "direction",
             "steplen", "update"]
    g = graph_times([0.0, 0.5, 1.0, 1.25, 1.5, 2.0, 3.0, 3.5, 4.5], names)
    assert g.info["phases"] == names
    assert g.info["kernel_nodes"] == [10 * (i + 1) for i in range(8)]
    assert g.info["port_launches"] == [3] * 8
    assert g.torch_nodes == 360 - 24
    for i in range(2 * T.SAMPLE_EVERY):
        with T.span("chunk"):
            T.replayed(g, i + 1)
        with T.span("host_read"):
            T.read_sample()
    b = T.snapshot()["unprofiled"]
    assert b["counters"]["graph.replays"] == 2 * T.SAMPLE_EVERY
    assert b["graph_ms_samples"] == 2
    assert b["counters"]["graph.torch_nodes"] == 2 * T.SAMPLE_EVERY * 336
    assert b["graph_ms"] == [4.5, 4.5] and b["graph_ms_total"] == 9.0
    per = {k: v["total_ms"] / v["samples"] for k, v in b["phases"].items()}
    assert per == {"chol": 0.5, "schur": 0.75, "kkt": 0.75,
                   "direction": 1.0, "steplen": 0.5, "update": 1.0}
    assert sum(per.values()) == pytest.approx(4.5)
    assert T.snapshot()["graphs"] == [g.info]


def test_segment_replays_are_multiplied_in_when_counts_are_read():
    K.reset_counts()

    class Graph:
        def replay(self):
            pass

    seg = G.Segment(Graph(), {"chol_batched": 2, "tri_solve_batched<true>": 1,
                              "tri_solve_batched": 1})
    for _ in range(5):
        seg.replay()
    c = K.counts()
    assert seg.replays == 5
    assert (c["chol_batched"], c["tri_solve_batched"],
            c["tri_solve_batched<true>"]) == (10, 5, 5)
    K.reset_counts()
    assert seg.replays == 0 and K.counts()["chol_batched"] == 0
    seg.replay()
    del seg                             # a graph that is gone keeps its
    assert K.counts()["chol_batched"] == 2    # replays until the reset
    seg = G.Segment(Graph(), {"chol_batched": 1})    # and its tally goes
    assert len(K._TALLIES) == 1 and K.counts()["chol_batched"] == 2
    K.reset_counts()
    assert all(v == 0 for v in K.counts().values())


def test_warmup_notes_the_marks_and_capture_records_their_events():
    names = ["chol", "schur", "kkt", "direction", "steplen", "update",
             "end"]
    with T.phase_marks() as warm:
        for name in names:
            T.phase(name)
    assert [m[0] for m in warm[1:]] == names
    assert all(m[1] is None for m in warm)
    events = [FakeEvent(0.0) for _ in warm[1:]]
    with T.phase_marks(events) as marks:
        for name in names:
            T.phase(name)
    assert [m[1] for m in marks[1:]] == events
    assert all(e.recorded == 1 for e in events)
    T.phase("chol")                     # outside a step: nothing
    assert all(e.recorded == 1 for e in events)
