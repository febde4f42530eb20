"""Spread of the sampled device time of the step's graph, first to last
event: (p90 - p10) / p50 of the kept samples, in percent. The card runs
one graph at one of two paces; a run that catches both reads wide."""

from perfbench.harness.spans import deciles, sampled


def read(run):
    b = sampled()
    if b is None or len(b["graph_ms"]) < 2:
        return None
    p10, p50, p90 = deciles(b["graph_ms"])
    return 100.0 * (p90 - p10) / p50
