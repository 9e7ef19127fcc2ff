"""Arithmetic over a run's completions."""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence, Tuple


def snapped_rate(done: Sequence[Tuple[float, float]]) -> Optional[float]:
    """Work per second over the time between the first and the last
    completion. ``done``: (completion time, work) of every op that
    completed in the window. The first completion only opens the interval,
    so its work is not counted; ``None`` with fewer than two."""
    if len(done) < 2:
        return None
    done = sorted(done)
    first, last = done[0][0], done[-1][0]
    if last <= first:
        return None
    return sum(w for _, w in done[1:]) / (last - first)


def percentile(values: Iterable[float], q: float) -> float:
    """The ``q`` quantile (0..1) by linear interpolation between the
    closest ranks (numpy's and ``statistics``' "inclusive" method)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    if pos == lo or v[hi] == v[lo]:
        return v[lo]
    if math.isinf(v[hi]):
        # a failed op's latency is infinite
        return v[hi]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values: List[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median, by ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
