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
adds them again at each replay.

:class:`EagerSplit` runs the same three parts without a graph (the CPU,
where the eigensolver is LAPACK's, or a sharded step, whose collectives
are not captured), so one host loop drives both.
"""

from __future__ import annotations

import time

import torch

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

    def replay(self):
        self.graph.replay()
        dk.add_counts(self.launches)


def capture(fn, pool):
    """Capture ``fn()`` into a CUDA graph on ``pool``: (Segment, the
    tensors ``fn`` returned, now static outputs). A capture that fails
    raises; nothing falls back to eager execution."""
    graph = torch.cuda.CUDAGraph()

    def run():
        with torch.cuda.graph(graph, pool=pool):
            return fn()

    out, launches = record(run)
    return Segment(graph, launches), out


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
    instantiation) are kept; ``host_calls`` counts what the host issues:
    a replay is one, and so is each copy its caller counts in."""

    def __init__(self, head, eig, tail):
        def whole():
            mid, mats = head()
            return tail(mid, eig(mats))

        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            whole()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.warmup_seconds = t1 - t0
        self.graph, self.out = capture(whole,
                                       torch.cuda.graph_pool_handle())
        torch.cuda.synchronize()
        self.capture_seconds = time.perf_counter() - t1
        self.host_calls = 0

    def run(self):
        self.graph.replay()
        self.host_calls += 1
        return self.out
