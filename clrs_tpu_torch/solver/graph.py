"""CUDA graphs of the IPM step: the port's counterpart of ``jax.jit``.

An iteration runs in three parts (:func:`.step.make_step_parts`): a head
from the state up to the step-length matrices, the eigensolver (float64
lowest eigenvalues, or the certified route's f32 eigenpairs), and a tail
from the step lengths to the new state and its info. On the card the
eigensolver is a kernel of the port (csrc/eig.cu), which reads nothing
back to the host, so the three parts are captured together, once, as one
CUDA graph (:class:`GraphStep`) and replayed: an iteration is one host
call. The graph reads and writes static buffers: inputs are copied into
them before a replay, and what a replay returns is overwritten by the
next one.

A captured kernel is launched by every replay, not by the capture, so the
launch counters of :mod:`clrs_tpu_torch.dd.kernels` are kept truthful
here: a :class:`Segment` takes back out the counts its capture added and
counts its replays, which ``dd.kernels.counts()`` multiplies in when read.

The capture also records a CUDA timing event at each IPM phase boundary
(:func:`clrs_tpu_torch.tracing.phase`), so every replay runs them as
event-record nodes, and the graph keeps spans and counters
(``graph.warmup``, ``graph.capture``, ``graph.first_replay``,
``graph.replays``, ``graph.host_calls``); after the capture its kernel
nodes are counted per phase (:func:`phase_nodes`).

:class:`EagerSplit` runs the same three parts without a graph (the CPU,
where the eigensolver is LAPACK's, or a sharded step, whose collectives
are not captured), so one host loop drives both.
"""

from __future__ import annotations

import ctypes

import torch

from .. import tracing
from ..dd import kernels as dk


def record(fn):
    """Run ``fn`` and return (its result, {kernel or plain-version name:
    count} that it added to the launch counters), with those counts taken
    back out of the counters."""
    before = dk.counts()
    out = fn()
    added = {k: v - before[k] for k, v in dk.counts().items()
             if v != before[k]}
    dk.add_counts(added, -1)
    return out, added


class Segment:
    """A captured graph and the kernel launches each replay of it makes."""

    def __init__(self, graph, launches):
        self.graph = graph
        self.launches = launches
        self._tally = dk.replay_tally(self, launches)

    @property
    def replays(self):
        """Replays since the last ``dd.kernels.reset_counts()``."""
        return self._tally.replays

    def replay(self):
        self.graph.replay()
        self._tally.replays += 1


def capture(fn, pool):
    """Capture ``fn()`` into a CUDA graph on ``pool`` and instantiate it:
    (Segment, the tensors ``fn`` returned, now static outputs). The
    graph's topology is kept for :func:`phase_nodes`. A capture that fails
    raises; nothing falls back to eager execution."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)

    def run():
        with torch.cuda.graph(graph, pool=pool):
            return fn()

    out, launches = record(run)
    graph.instantiate()
    return Segment(graph, launches), out


def phase_nodes(graph, events):
    """Kernel nodes of a captured ``torch.cuda.CUDAGraph`` between its
    event-record nodes of ``events`` (in the order recorded): a list of
    len(events) + 1 counts, [0] before the first event, [k + 1] after
    event k (csrc/graphwalk.cu, the nodes in dependency order)."""
    from ..dd.build import library

    n = len(events)
    handles = (ctypes.c_void_p * n)(*(e.cuda_event for e in events))
    out = (ctypes.c_longlong * (n + 1))()
    rc = library().clrs_graph_phase_nodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), handles, n, out)
    dk._launched(rc, "graph_phase_nodes")
    return list(out)


class EagerSplit:
    """head() -> (mid, mats); eig(mats) -> lows; tail(mid, lows) -> out,
    run in turn at each :meth:`run`."""

    def __init__(self, head, eig, tail):
        self._head, self._eig, self._tail = head, eig, tail

    def run(self):
        mid, mats = self._head()
        return self._tail(mid, self._eig(mats))


class GraphStep:
    """The same three parts on the card as one CUDA graph, captured once
    after an eager warm-up on a side stream (PyTorch's graph recipe: it
    builds the kernels and copies the kernels' tables to the device).
    ``head`` and ``tail`` must read their inputs from static tensors.
    ``warmup_seconds`` and ``capture_seconds`` (capture and
    instantiation) are the spans ``graph.warmup`` and ``graph.capture``;
    ``host_calls`` counts what the host issues: a replay is one, and so is
    each copy its caller counts in (:meth:`count_host_call`). ``times``:
    the graph's phase events and kernel nodes per phase
    (:class:`clrs_tpu_torch.tracing.GraphTimes`), None if it was captured
    with tracing off."""

    def __init__(self, head, eig, tail):
        def whole():
            mid, mats = head()
            out = tail(mid, eig(mats))
            tracing.phase("end")
            return out

        with tracing.span("graph.warmup") as warm:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), tracing.phase_marks() as marks:
                whole()
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
        self.warmup_seconds = warm.ns / 1e9
        events = None
        if marks and len(marks) > 2:    # one timing event a mark
            events = [torch.cuda.Event(enable_timing=True, external=True)
                      for _ in marks[1:]]
            for e in events:            # creates the CUDA event
                e.record()
        with tracing.span("graph.capture") as cap:
            with tracing.phase_marks(events) as marks:
                self.graph, self.out = capture(
                    whole, torch.cuda.graph_pool_handle())
            torch.cuda.synchronize()
        self.capture_seconds = cap.ns / 1e9
        self.times = None
        if events:
            self.times = tracing.GraphTimes(
                marks, phase_nodes(self.graph.graph, events), events)
        self.host_calls = 0
        self._uploaded = False

    def run(self):
        if self._uploaded:
            self.graph.replay()
        else:
            with tracing.span("graph.first_replay"):
                self.graph.replay()
            self._uploaded = True
        self.host_calls += 1
        tracing.replayed(self.times, self.graph.replays)
        return self.out

    def count_host_call(self):
        """A copy the caller issued beside the replays."""
        self.host_calls += 1
        tracing.count("graph.host_calls")
