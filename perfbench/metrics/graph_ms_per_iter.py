"""Device milliseconds of one replay of the step's CUDA graph, from its
first timing event to its last (events captured in the graph, read after
every 16th replay): the mean over the samples."""

from perfbench.harness.spans import sampled


def read(run):
    b = sampled()
    if b is None:
        return None
    return b["graph_ms_total"] / b["graph_ms_samples"]
