"""Device milliseconds per replay of the step graph's schur phase (the XY
products, the pairing panels, the residual R and the Schur complement
S), from the timing events captured in the graph, the mean over the
sampled replays."""

from perfbench.harness.spans import phase_ms


def read(run):
    return phase_ms("schur")
