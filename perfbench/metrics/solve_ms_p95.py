"""The 95th percentile of every solve's wall milliseconds in the window."""

from perfbench.harness.stats import p95


def read(run):
    return p95(1e3 * s.seconds for s in run.solves)
