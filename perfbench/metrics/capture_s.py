"""Seconds of the step graph's eager warm-up and capture, summed over the
instances (solver/graph.py's GraphStep.warmup_seconds and
capture_seconds); nothing where no graph was captured."""


def read(run):
    if any(c is None for c in run.capture_s):
        return None
    return sum(run.capture_s)
