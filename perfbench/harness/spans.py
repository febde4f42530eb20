"""The program's own spans and counters (``clrs_tpu_torch.tracing``), from
the bucket it keeps for work done while no profiler recorded: the window
and the set-up, not the traced solves. Nothing where the program has no
such module (it keeps none) or recorded no graph replay."""

from __future__ import annotations

import statistics


def unprofiled():
    """The unprofiled bucket of the program's snapshot, or None."""
    try:
        from clrs_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()["unprofiled"]


def replayed():
    """The unprofiled bucket if it holds graph replays, else None."""
    b = unprofiled()
    if b is None or not b["counters"].get("graph.replays"):
        return None
    return b


def span(b, name, key="total_ns"):
    """A span's ``count``, ``total_ns`` or ``self_ns`` (0 if it never
    ran)."""
    s = b["spans"].get(name)
    return s[key] if s else 0


def sampled():
    """The unprofiled bucket if it holds sampled graph times, else None."""
    b = replayed()
    if b is None or not b["graph_ms_samples"]:
        return None
    return b


def phase_ms(name):
    """Sampled device ms per replay of IPM phase ``name``."""
    b = sampled()
    if b is None or name not in b["phases"]:
        return None
    p = b["phases"][name]
    return p["total_ms"] / p["samples"]


def deciles(values):
    """(p10, p50, p90) by ``statistics.quantiles`` (inclusive)."""
    q = statistics.quantiles(values, n=10, method="inclusive")
    return q[0], q[4], q[8]
