"""Window wall milliseconds over the solves completed in it."""

from perfbench.harness.stats import per


def read(run):
    return per(run.window_s, len(run.solves))
