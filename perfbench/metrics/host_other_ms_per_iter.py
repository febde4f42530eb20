"""Host milliseconds per graph replay in the solve loop's own Python:
the self time of the program's ``chunk``, ``chunk.copy_in``,
``chunk.flag`` and ``host_read`` spans, which leaves out the launch, the
wait and the one-off warm-up, capture and first replay of each graph."""

from perfbench.harness.spans import replayed, span

SPANS = ("chunk", "chunk.copy_in", "chunk.flag", "host_read")


def read(run):
    b = replayed()
    if b is None:
        return None
    ns = sum(span(b, name, "self_ns") for name in SPANS)
    return 1e-6 * ns / b["counters"]["graph.replays"]
