"""Percentiles, rates and spreads, in plain Python.

A tail is taken over every request of the window: a request that never
finished counts with the wait it had when the run gave up on it, so a stall
raises the tail instead of dropping out of it.
"""

from __future__ import annotations

import math


def quantile(values, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics
    (numpy's default rule), over a non-empty sequence."""
    xs = sorted(values)
    if not xs:
        raise ValueError("quantile of nothing")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def per_second(work: float, start: float, end: float) -> float:
    """All the work of a window over all its time."""
    if end <= start:
        raise ValueError(f"empty window [{start}, {end}]")
    return work / (end - start)


def token_gaps(times) -> list[float]:
    """The gaps between consecutive token times of one request."""
    return [b - a for a, b in zip(times, times[1:])]
