"""Statistics of the benchmark: percentiles over all requests, and busy
and idle time from device intervals.

Nothing here reads the program's own histograms or batch latencies: a
percentile is taken over every request of the window, each timed from the
moment it was due (the generator's schedule, or the moment a closed-loop
caller issued it), so a stall of the generator or the server counts
against every request it delays.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0..100) of ``values`` with linear interpolation
    between closest ranks (numpy's default method)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def request_latencies(due: Sequence[float], completed: Sequence[float]
                      ) -> list[float]:
    """Latency of every request: completion minus the time it was due."""
    if len(due) != len(completed):
        raise ValueError("one due time per completion")
    return [c - d for d, c in zip(due, completed)]


def merge_intervals(spans: Iterable[tuple[float, float]]
                    ) -> list[tuple[float, float]]:
    """The union of ``spans`` as sorted disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(spans):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_time(spans: Iterable[tuple[float, float]],
              window: Optional[tuple[float, float]] = None) -> float:
    """Length of the union of ``spans``, clipped to ``window`` if given."""
    tot = 0.0
    for a, b in merge_intervals(spans):
        if window is not None:
            a, b = max(a, window[0]), min(b, window[1])
        tot += max(0.0, b - a)
    return tot


def idle_gaps(spans: Iterable[tuple[float, float]],
              window: tuple[float, float]) -> list[tuple[float, float]]:
    """The intervals of ``window`` that no span covers."""
    gaps, cur = [], window[0]
    for a, b in merge_intervals(spans):
        if b <= window[0] or a >= window[1]:
            continue
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < window[1]:
        gaps.append((cur, window[1]))
    return gaps
