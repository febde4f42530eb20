"""Metric arithmetic on solve records: rates over the whole window, a tail
over all solves, and device busy time from intervals."""

from __future__ import annotations

import statistics


def per(total_s: float, count: int):
    """Milliseconds of ``total_s`` per unit of ``count`` (None if none)."""
    return 1e3 * total_s / count if count else None


def p95(values):
    """The 95th percentile of every value (inclusive quantiles: linear
    between order statistics, the largest value at most)."""
    vals = list(values)
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    return statistics.quantiles(vals, n=20, method="inclusive")[18]


def union_seconds(intervals):
    """Seconds covered by (start, end) intervals in microseconds."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6
