"""Percent of an iteration's wall time in which no operation ran on the
device: 100 (1 - device busy seconds per iteration in the traced solves
(torch.profiler, device activity alone) / wall seconds per iteration of
the run's own window). The traced span's own wall is not the divisor:
the profiler's tracing of every kernel of a replayed graph slows the
graph's launch about twofold (4.8 against 2.2 ms an iteration at
delsarte(3,10) on an H100), which would count as idle time."""


def read(run):
    p = run.profile
    its = sum(s.iterations for s in run.solves)
    if not p or not p["iterations"] or not p["busy_s"] or not its:
        return None
    busy = p["busy_s"] / p["iterations"]
    return 100.0 * (1.0 - busy / (run.window_s / its))
