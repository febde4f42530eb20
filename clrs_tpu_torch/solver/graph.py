"""CUDA graphs of the IPM step: the port's counterpart of ``jax.jit``.

An iteration runs in three parts (:func:`.step.make_step_parts`): a head
from the state up to the step-length matrices, the eigensolver (float64
lowest eigenvalues, or the certified route's f32 eigenpairs), and a tail
from the step lengths to the new state and its info. On the
card the head and the tail are each captured once in a CUDA graph and
replayed; the eigensolver runs eagerly between them, because PyTorch reads
cuSOLVER's ``info`` on the host, which capture refuses. Both graphs of a
solve share one private memory pool. The graphs read and write static
buffers: inputs are copied into them before a replay, and what a replay
returns is overwritten by the next one.

A captured kernel is launched by every replay, not by the capture, so the
launch counters of :mod:`clrs_tpu_torch.dd.kernels` are kept truthful
here: a :class:`Segment` takes back out the counts its capture added and
adds them again at each replay.

:class:`EagerSplit` runs the same three parts without graphs (the CPU, or
any device), so one host loop drives both.
"""

from __future__ import annotations

import time

import torch

from ..dd import kernels as dk
from .step import _tree_map


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
    each run as it is called."""

    def __init__(self, head, eig, tail):
        self._head, self._eig, self._tail = head, eig, tail

    def run_head(self):
        self.mid, self.mats = self._head()

    def run_eig(self):
        self.lows = self._eig(self.mats)

    def run_tail(self):
        return self._tail(self.mid, self.lows)


class GraphSplit:
    """The same three parts on the card: the head and the tail captured
    once, after an eager warm-up on a side stream (PyTorch's graph recipe:
    it builds the kernels, loads cuBLAS/cuSOLVER and copies the kernels'
    tables to the device), the eigensolver eager between their replays,
    its results (a tensor or a tuple of them per matrix batch) copied into
    static buffers. ``head`` and ``tail`` must
    read their inputs from static tensors. ``warmup_seconds`` and
    ``capture_seconds`` (capture and instantiation of both graphs) are
    kept; ``host_calls`` counts what the host issues: a replay, an
    eigensolver call or a copy of its result is one."""

    def __init__(self, head, eig, tail):
        self._eig = eig
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            mid, mats = head()
            lows = eig(mats)
            tail(mid, lows)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.warmup_seconds = t1 - t0
        pool = torch.cuda.graph_pool_handle()
        self.head, (self.mid, self.mats) = capture(head, pool)
        self.lows = _tree_map(torch.empty_like, lows)
        self.tail, self.out = capture(lambda: tail(self.mid, self.lows),
                                      pool)
        torch.cuda.synchronize()
        self.capture_seconds = time.perf_counter() - t1
        self.host_calls = 0

    def run_head(self):
        self.head.replay()
        self.host_calls += 1

    def run_eig(self):
        copies = []
        _tree_map(lambda buf, lo: copies.append(buf.copy_(lo)), self.lows,
                  self._eig(self.mats))
        self.host_calls += len(self.mats) + len(copies)

    def run_tail(self):
        self.tail.replay()
        self.host_calls += 1
        return self.out
