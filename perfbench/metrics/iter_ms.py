"""Window wall milliseconds over all IPM iterations committed in it."""

from perfbench.harness.stats import per


def read(run):
    return per(run.window_s, sum(s.iterations for s in run.solves))
