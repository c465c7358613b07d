"""The arithmetic of the metrics, kept with the benchmark: percentiles over
every sample, rates over a whole window, the device's busy time as the
union of its operations' intervals."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(samples: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of all ``samples``, linear between
    the closest ranks (numpy's default)."""
    xs = sorted(samples)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work done per second over a whole window."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return count / seconds


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint, sorted union of (start, end) intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``intervals``: the time in which at least
    one of them ran."""
    return sum(b - a for a, b in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The idle stretches between the union's pieces."""
    u = union(intervals)
    return [(u[i][1], u[i + 1][0]) for i in range(len(u) - 1)]


def idle_share(intervals: Iterable[Tuple[float, float]], window: float) -> float:
    """1 - busy / window."""
    return 1.0 - busy(intervals) / window
