"""Host milliseconds per replay spent launching the step's CUDA graph:
the self time of the program's ``chunk.launch`` spans (a graph's first
replay, which uploads it, is a span of its own and left out) over the
replays after each graph's first."""

from perfbench.harness.spans import replayed, span


def read(run):
    b = replayed()
    if b is None:
        return None
    n = b["counters"]["graph.replays"] - span(b, "graph.first_replay",
                                              "count")
    if n <= 0:
        return None
    return 1e-6 * span(b, "chunk.launch", "self_ns") / n
