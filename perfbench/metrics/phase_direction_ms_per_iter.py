"""Device milliseconds per replay of the step graph's direction phase (the
residuals, the predictor, the corrector mu and the corrector direction),
from the timing events captured in the graph, the mean over the sampled
replays."""

from perfbench.harness.spans import phase_ms


def read(run):
    return phase_ms("direction")
