"""Device milliseconds per replay of the step graph's steplen phase (the
step-length matrices, the eigensolver and the step lengths), from the
timing events captured in the graph, the mean over the sampled replays."""

from perfbench.harness.spans import phase_ms


def read(run):
    return phase_ms("steplen")
