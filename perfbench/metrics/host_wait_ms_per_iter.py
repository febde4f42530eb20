"""Host milliseconds per graph replay blocked in the solve loop's host
read, waiting for the device (the program's ``host_read.wait`` spans)."""

from perfbench.harness.spans import replayed, span


def read(run):
    b = replayed()
    if b is None:
        return None
    return 1e-6 * span(b, "host_read.wait") / b["counters"]["graph.replays"]
