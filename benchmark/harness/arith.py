"""The arithmetic the metrics share: a rate over a window, a tail over
all scans, and busy time as the union of device intervals.

The union replaces the sum of kernel, copy and fill times that
``tools/profile_port.py`` (commit e8749d5) takes: under NCCL's second
stream device operations overlap, and a sum counts the overlap twice.
"""

from __future__ import annotations

import bisect
import math
from typing import Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def rate_per_s(amounts: Sequence[float], start: float,
               ends: Sequence[float]) -> Optional[float]:
    """The amount completed in a window over the window's time, from its
    start to the last completion."""
    if not ends:
        return None
    span = max(ends) - start
    if span <= 0:
        return None
    return float(sum(amounts)) / span


def nearest_rank(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0 < q ≤ 1) of all values by nearest rank: the
    smallest value with at least q of the values at or below it."""
    if not values:
        return None
    v = sorted(values)
    return float(v[max(math.ceil(q * len(v)), 1) - 1])


def mean(values: Iterable[float]) -> Optional[float]:
    v = list(values)
    return float(sum(v)) / len(v) if v else None


def union(intervals: Iterable[Interval], lo: float = -math.inf,
          hi: float = math.inf) -> List[Interval]:
    """The disjoint, sorted union of intervals, clipped to [lo, hi]."""
    out: List[list] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals: Iterable[Interval], lo: float = -math.inf,
            hi: float = math.inf) -> float:
    """Length of the union of intervals inside [lo, hi]."""
    return sum(b - a for a, b in union(intervals, lo, hi))


def gaps(intervals: Iterable[Interval], lo: float,
         hi: float) -> List[Interval]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(intervals, lo, hi):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


class Coverage:
    """Covered length of a fixed set of intervals inside any [lo, hi], by
    bisection over their union (many queries over one trace)."""

    def __init__(self, intervals: Iterable[Interval]):
        self.u = union(intervals)
        self.starts = [a for a, _b in self.u]
        self.prefix = [0.0]
        for a, b in self.u:
            self.prefix.append(self.prefix[-1] + (b - a))

    def __call__(self, lo: float, hi: float) -> float:
        if hi <= lo or not self.u:
            return 0.0
        i = max(bisect.bisect_right(self.starts, lo) - 1, 0)
        j = bisect.bisect_left(self.starts, hi)
        if j <= i:
            return 0.0
        total = self.prefix[j] - self.prefix[i]
        a, b = self.u[i]
        total -= min(max(lo, a), b) - a        # the part of the first before lo
        a, b = self.u[j - 1]
        total -= b - max(min(hi, b), a)        # the part of the last past hi
        return total
