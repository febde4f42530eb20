"""Device milliseconds per replay of the step graph's chol phase (mu, the
Cholesky factors of X and Y, X^-1), from the timing events captured in
the graph, the mean over the sampled replays."""

from perfbench.harness.spans import phase_ms


def read(run):
    return phase_ms("chol")
