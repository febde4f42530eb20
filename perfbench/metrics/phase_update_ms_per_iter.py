"""Device milliseconds per replay of the step graph's update phase (the
state update, the info, the commit, the termination tests and the code
ladder), from the timing events captured in the graph, the mean over the
sampled replays."""

from perfbench.harness.spans import phase_ms


def read(run):
    return phase_ms("update")
