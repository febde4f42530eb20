"""Device milliseconds per replay of the step graph's kkt phase (the
Cholesky factor of S, L^-1 B, Q and its Cholesky factor), from the
timing events captured in the graph, the mean over the sampled replays."""

from perfbench.harness.spans import phase_ms


def read(run):
    return phase_ms("kkt")
