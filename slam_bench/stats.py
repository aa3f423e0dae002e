"""The benchmark's arithmetic: rates, percentiles and the union of device
intervals."""

from __future__ import annotations

import math


def rate(count: int, seconds: float) -> float:
    """Work per second over the whole window: `count` items done in
    `seconds`, every second of the window counted."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) over every value:
    the smallest value with at least q% of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def union_seconds(intervals, lo: float = -math.inf, hi: float = math.inf) -> float:
    """Length of the union of (start, end) intervals, clipped to [lo, hi]."""
    total, end = 0.0, -math.inf
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]
