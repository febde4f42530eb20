"""Spans and counters of the port, kept in memory for whoever runs it.

A span times a layer's work on the host's clock (``time.perf_counter_ns``)
and is kept as an aggregate per name: how often it ran, its total
nanoseconds, its self nanoseconds (the total less the spans opened inside
it), the span it ran inside and the id of the last solve it ran in.
Counters are integers. Both are kept in one of two buckets, chosen when an
outermost span opens: "profiled" while a ``torch.profiler`` records (the
profiler slows the host), "unprofiled" otherwise, which is the program's
own pace. While a profiler records, each span is also a host range
``clrs.<name>`` in its trace carrying the solve's id; these ranges make no
device records, so a trace's device work is the same with or without them.

The spans, outermost first:

- ``compile.sdp``, ``compile.remove_empty``, ``compile.preprocess``,
  ``compile.device_sdp``: the host build of a problem; ``kernels.build``:
  nvcc building the kernel library (counter ``kernels.builds``).
- ``chunk``: one call of a ``make_run_chunk`` loop, with ``chunk.copy_in``
  (inputs into the loop's buffers), ``chunk.launch`` (the host's time in
  each step launch: on the card, the graph's replay), ``chunk.flag`` (the
  pinned ``done`` flag's copy and read) and, at the first call,
  ``graph.warmup`` and ``graph.capture``; ``graph.first_replay`` (inside
  ``chunk.launch``) is a graph's first replay, which uploads it.
- ``host_read``: the solve loop's one transfer of the info to the host,
  with ``host_read.wait``, the blocking copy.

Counters: ``graph.replays``, ``graph.host_calls`` (what the host issues
to the card in the loop: replays and flag copies), ``graph.torch_nodes``
(the kernel nodes that are not the port's, added at each replay),
``kernels.builds`` (nvcc builds of the kernel library).

On the card the step's capture records a CUDA timing event at each IPM
phase boundary (:func:`phase`), so every replay runs the events; after
every ``SAMPLE_EVERY``-th replay the next host read, after its wait, adds
the replay's intervals to the bucket: device ms per phase (each interval
is credited to the phase its opening event names) and the first-to-last
time, ``graph_ms``, whose last ``GRAPH_MS_KEEP`` values are kept for
percentiles. After the capture the graph's kernel nodes are counted per
phase (:mod:`.solver.graph`), beside the port's own launches in each.

:func:`snapshot` returns all of it as plain dicts and :func:`reset` clears
it. :func:`configure` turns it all off for the process; a graph captured
while it is off holds no events.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time

import torch

__all__ = ["PHASES", "configure", "enabled", "reset", "snapshot", "span",
           "timed", "count", "open_solve", "phase"]

PHASES = ("chol", "schur", "kkt", "direction", "steplen", "update")
SAMPLE_EVERY = 16
GRAPH_MS_KEEP = 8192
MAX_GRAPHS = 256

_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
try:
    # a host range of the profiler that is not mirrored onto the device's
    # timeline, as record_function's ranges are
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:                                   # pragma: no cover
    _Range = None

_on = True
_stack = []             # the open spans, innermost last
_solve = 0              # id of the current solve
_claimed = True         # whether a chunk has run under that id yet
_marks = None           # while a step is warmed up or captured:
                        # [(phase, event, launches)]
_events = None          # while a step is captured: one event a mark
_pending = None         # a graph whose sampled replay awaits a host read
_graphs = collections.deque(maxlen=MAX_GRAPHS)


def _new_bucket():
    return {"spans": {}, "counters": {}, "phases": {},
            "graph_ms": collections.deque(maxlen=GRAPH_MS_KEEP),
            "graph_ms_sum": [0, 0.0]}


_buckets = {"unprofiled": _new_bucket(), "profiled": _new_bucket()}
_cur = _buckets["unprofiled"]


def configure(enabled=True):
    """Turn the spans, counters and graph events on or off for the
    process (on by default). A graph holds events only if captured while
    on."""
    global _on
    _on = bool(enabled)


def enabled():
    return _on


def reset():
    """Clear every aggregate, counter, sample and graph record."""
    global _cur, _pending
    for k in _buckets:
        _buckets[k] = _new_bucket()
    _cur = _buckets["unprofiled"]
    _graphs.clear()
    _pending = None


class span:
    """``with span(name) as s:`` times the block into the aggregate
    ``name``; ``s.ns`` holds its duration after the block, kept or not."""

    __slots__ = ("name", "ns", "_t0", "_child", "_range", "_kept")

    def __init__(self, name):
        self.name = name
        self.ns = 0

    def __enter__(self):
        global _cur
        self._kept = _on
        if _on:
            if not _stack:
                _cur = _buckets["profiled" if _profiling()
                                else "unprofiled"]
            self._range = None
            if _Range is not None and _cur is _buckets["profiled"]:
                self._range = _Range("clrs." + self.name, [],
                                     {"solve": _solve})
                self._range.__enter__()
            self._child = 0
            _stack.append(self)
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        self.ns = ns = _clock() - self._t0
        if not self._kept:
            return False
        _stack.pop()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        parent = _stack[-1] if _stack else None
        if parent is not None:
            parent._child += ns
        agg = _cur["spans"].get(self.name)
        if agg is None:
            agg = _cur["spans"][self.name] = [0, 0, 0, None, 0]
        agg[0] += 1
        agg[1] += ns
        agg[2] += ns - self._child
        agg[3] = None if parent is None else parent.name
        agg[4] = _solve
        return False


def timed(name):
    """Decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed_call(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return timed_call
    return wrap


def instrument_compile():
    """Put the compile layer's spans on its entry points. Its modules are
    copies of the JAX package's, kept line for line
    (``tests/test_torch_copies.py``), so the spans wrap them from outside;
    the package's ``__init__`` calls this once."""
    from .compile import preprocess, sdp
    from .model import checks

    cls = sdp.ClusteredLowRankSDP
    cls.__init__ = timed("compile.sdp")(cls.__init__)
    checks.remove_empty_blocks = timed("compile.remove_empty")(
        checks.remove_empty_blocks)
    preprocess.preprocess_sdp = timed("compile.preprocess")(
        preprocess.preprocess_sdp)


def count(name, n=1):
    if _on:
        c = _cur["counters"]
        c[name] = c.get(name, 0) + n


def open_solve():
    """Begin a solve: the spans that follow carry a new id, which the next
    chunk run on a fresh state joins."""
    global _solve, _claimed
    _solve += 1
    _claimed = False
    return _solve


def chunk_solve(fresh):
    """A chunk is about to run; ``fresh``: on a state that is not its
    loop's own carry, so it begins a solve (the one :func:`open_solve`
    opened, if no chunk has joined it yet, else a new one)."""
    global _claimed
    if fresh:
        if _claimed:
            open_solve()
        _claimed = True


def span_totals(name):
    """(count, total ns) of the span ``name`` over both buckets."""
    n = t = 0
    for b in _buckets.values():
        agg = b["spans"].get(name)
        if agg is not None:
            n, t = n + agg[0], t + agg[1]
    return n, t


# ---------------------------------------------------------------------------
# device time per phase, from timing events captured in the step's graph
# ---------------------------------------------------------------------------

def phase(name):
    """Mark the start of IPM phase ``name`` (one of :data:`PHASES`;
    "end" closes the last). While a step is warmed up (:func:`phase_marks`)
    this notes the mark; while it is captured, it also records the mark's
    timing event, which every replay of the graph records again; anywhere
    else it does nothing."""
    if _marks is not None:
        from .dd.kernels import launch_total
        ev = None
        if _events is not None:
            ev = _events[len(_marks) - 1]
            ev.record()
        _marks.append((name, ev, launch_total()))


@contextlib.contextmanager
def phase_marks(events=None):
    """Collect the :func:`phase` marks of a step's warm-up (``events``
    None) or of its capture (``events``: a created CUDA timing event for
    each mark of the warm-up): yields the list, a start entry, then one a
    mark (None while tracing is off: no events)."""
    global _marks, _events
    if not _on:
        yield None
        return
    from .dd.kernels import launch_total
    _marks, _events = [(None, None, launch_total())], events
    try:
        yield _marks
    finally:
        _marks = _events = None


class GraphTimes:
    """A captured graph's phase events and its kernel nodes per phase.

    ``marks``: :func:`phase_marks`' list (a start entry, then one a mark,
    at least two); ``events``: one a mark; ``nodes[k + 1]``: the graph's
    kernel nodes after mark k and before the next, ``nodes[0]`` those
    before the first."""

    def __init__(self, marks, nodes, events):
        start, marks = marks[0][2], marks[1:]
        self.names = [m[0] for m in marks[:-1]]
        self.events = list(events)
        launches = [b[2] - a[2] for a, b in zip(marks, marks[1:])]
        kernel_nodes = list(nodes[1:len(marks)])
        # work outside the marks, if any, is counted with the nearest phase
        kernel_nodes[0] += nodes[0]
        kernel_nodes[-1] += nodes[len(marks)]
        launches[0] += marks[0][2] - start
        self.torch_nodes = sum(kernel_nodes) - sum(launches)
        self.info = {"phases": self.names, "kernel_nodes": kernel_nodes,
                     "port_launches": launches,
                     "torch_nodes": self.torch_nodes}
        _graphs.append(self.info)


def replayed(times, n):
    """Count the ``n``-th replay of a graph (``times``: its
    :class:`GraphTimes`, None for a graph without events); each
    ``SAMPLE_EVERY``-th is read at the next host read."""
    global _pending
    if not _on:
        return
    c = _cur["counters"]
    c["graph.replays"] = c.get("graph.replays", 0) + 1
    c["graph.host_calls"] = c.get("graph.host_calls", 0) + 1
    if times is not None:
        c["graph.torch_nodes"] = c.get("graph.torch_nodes", 0) \
            + times.torch_nodes
        if n % SAMPLE_EVERY == 0:
            _pending = times


def read_sample():
    """After a host read's wait: the sampled graph's intervals into the
    bucket (its last replay is complete: the wait was on the stream it
    ran on)."""
    global _pending
    g = _pending
    if g is None or not _on:
        return
    _pending = None
    ev = g.events
    if not ev[-1].query():
        return
    per = dict.fromkeys(g.names, 0.0)
    for name, a, b in zip(g.names, ev, ev[1:]):
        per[name] += a.elapsed_time(b)
    phases = _cur["phases"]
    for name, ms in per.items():
        agg = phases.setdefault(name, [0, 0.0])
        agg[0] += 1
        agg[1] += ms
    total = ev[0].elapsed_time(ev[-1])
    _cur["graph_ms"].append(total)
    s = _cur["graph_ms_sum"]
    s[0] += 1
    s[1] += total


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _plain(b):
    return {
        "spans": {k: {"count": a[0], "total_ns": a[1], "self_ns": a[2],
                      "parent": a[3], "solve": a[4]}
                  for k, a in b["spans"].items()},
        "counters": dict(b["counters"]),
        "phases": {k: {"samples": a[0], "total_ms": a[1]}
                   for k, a in b["phases"].items()},
        "graph_ms": list(b["graph_ms"]),
        "graph_ms_samples": b["graph_ms_sum"][0],
        "graph_ms_total": b["graph_ms_sum"][1],
    }


def snapshot():
    """Everything as plain dicts: ``unprofiled`` and ``profiled`` buckets
    (``spans``: name -> count, total_ns, self_ns, parent, solve;
    ``counters``; ``phases``: name -> samples, total_ms; ``graph_ms``, the
    kept samples, with ``graph_ms_samples`` and ``graph_ms_total`` over
    all), ``graphs`` (each captured graph's phases, kernel nodes and port
    launches per phase, and ``torch_nodes``), ``solve`` (the current id)
    and ``enabled``."""
    return {"enabled": _on, "solve": _solve,
            "graphs": [dict(g) for g in _graphs],
            "unprofiled": _plain(_buckets["unprofiled"]),
            "profiled": _plain(_buckets["profiled"])}
