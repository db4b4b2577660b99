"""Percentiles, rates and windows on hand-made timelines: a stall inside the
window moves the tail and the rate."""

from __future__ import annotations

import pytest

from benchlib import stats


def test_quantile_matches_linear_rule():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.quantile(xs, 0.5) == 3.0
    assert stats.quantile(xs, 0.95) == pytest.approx(4.8)
    assert stats.quantile([7.0], 0.95) == 7.0


def timeline(stalls=(), stall=0.5, n=100, gap=0.02):
    """Token times of one request, one token every `gap` seconds, with a
    stall of `stall` seconds after each token in `stalls`."""
    t, out = 0.0, []
    for i in range(n):
        t += gap + (stall if i in stalls else 0.0)
        out.append(t)
    return out


def test_stall_moves_gap_tail():
    assert stats.quantile(stats.token_gaps(timeline()), 0.95) == pytest.approx(0.02)
    # a stall before one token in a hundred stays under the 95th percentile
    assert stats.quantile(stats.token_gaps(timeline({50})), 0.95) == pytest.approx(0.02)
    # one before every tenth token (a long admission between steps) moves it
    every_tenth = stats.token_gaps(timeline(set(range(5, 100, 10))))
    assert stats.quantile(every_tenth, 0.95) == pytest.approx(0.52)


def test_stall_moves_ttft_tail():
    due = [0.1 * i for i in range(100)]
    first = [d + 0.2 for d in due]
    assert stats.quantile([f - d for f, d in zip(first, due)], 0.95) == pytest.approx(0.2)
    # a 2 s stall at t = 5: every request due in it waits for its end
    stalled = [max(f, 7.2) if 5.0 <= d < 7.0 else f for f, d in zip(first, due)]
    p95 = stats.quantile([f - d for f, d in zip(stalled, due)], 0.95)
    assert p95 > 1.5


def test_rate_counts_all_time_of_window():
    assert stats.per_second(100, 0.0, 10.0) == 10.0
    # the same work with a 2 s stall inside the window: the rate falls
    assert stats.per_second(100, 0.0, 12.0) < 10.0
    with pytest.raises(ValueError):
        stats.per_second(1, 3.0, 3.0)
