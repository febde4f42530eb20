"""Kernel nodes of the step's CUDA graph that are not the port's own
launches (PyTorch's), per replay: each graph's count at capture, weighted
by its replays."""

from perfbench.harness.spans import replayed


def read(run):
    b = replayed()
    if b is None or "graph.torch_nodes" not in b["counters"]:
        return None
    c = b["counters"]
    return c["graph.torch_nodes"] / c["graph.replays"]
