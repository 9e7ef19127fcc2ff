"""Per-node interval sets: sorted disjoint free ranges with bisect fitting.

Paper §5.2.1 "Interval Set Fitting": free windows are kept as sorted disjoint
[s, e) ranges; ``simulate_insert`` verifies a time-shifted segment list fits
via binary search in O(N log M) without mutating state.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


class IntervalSet:
    """Sorted disjoint free intervals [s, e)."""

    def __init__(self, intervals: Iterable[Interval] = ()):
        ivs = sorted((float(s), float(e)) for s, e in intervals if e > s)
        merged: List[Interval] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]

    # ------------------------------------------------------------ queries
    def __len__(self):
        return len(self.starts)

    def intervals(self) -> List[Interval]:
        return list(zip(self.starts, self.ends))

    def covers(self, s: float, e: float) -> bool:
        """Is [s, e) fully inside one free window? O(log M) bisect."""
        if e <= s:
            return True
        i = bisect.bisect_right(self.starts, s) - 1
        return i >= 0 and self.ends[i] >= e

    def simulate_insert(self, segments: Sequence[Interval],
                        shift: float = 0.0) -> bool:
        """Eq. 2 feasibility: every shifted segment fits a free window."""
        return all(self.covers(a + shift, a + shift + d) for a, d in segments)

    def next_fit(self, after: float, duration: float) -> float:
        """Earliest start >= after where [start, start+duration) fits.
        Returns inf if none."""
        i = bisect.bisect_right(self.starts, after) - 1
        i = max(i, 0)
        while i < len(self.starts):
            s = max(self.starts[i], after)
            if s + duration <= self.ends[i]:
                return s
            i += 1
        return float("inf")

    def total_free(self, horizon: float = float("inf")) -> float:
        return sum(min(e, horizon) - s for s, e in self.intervals()
                   if s < horizon)

    # --------------------------------------------------------- mutations
    def allocate(self, s: float, e: float) -> bool:
        """Remove [s, e) from the free set. False if it doesn't fit."""
        if not self.covers(s, e):
            return False
        i = bisect.bisect_right(self.starts, s) - 1
        ws, we = self.starts[i], self.ends[i]
        del self.starts[i], self.ends[i]
        pieces = []
        if ws < s:
            pieces.append((ws, s))
        if e < we:
            pieces.append((e, we))
        for j, (ps, pe) in enumerate(pieces):
            self.starts.insert(i + j, ps)
            self.ends.insert(i + j, pe)
        return True

    def subtract(self, s: float, e: float):
        """Remove the intersection of [s, e) from the free set, regardless of
        coverage (live-completion carving: an op's actual busy window may
        straddle windows already consumed by the projected plan)."""
        if e <= s:
            return
        i = max(bisect.bisect_right(self.starts, s) - 1, 0)
        while i < len(self.starts) and self.starts[i] < e:
            ws, we = self.starts[i], self.ends[i]
            if we <= s:
                i += 1
                continue
            lo, hi = max(ws, s), min(we, e)
            del self.starts[i], self.ends[i]
            j = i
            if ws < lo:
                self.starts.insert(j, ws)
                self.ends.insert(j, lo)
                j += 1
            if hi < we:
                self.starts.insert(j, hi)
                self.ends.insert(j, we)
                j += 1
            i = j

    def trim_before(self, t: float):
        """Drop free capacity earlier than ``t`` (the past cannot be
        allocated; idle time behind ``now`` is spent, not banked)."""
        self.subtract(float("-inf"), t)

    def free_many(self, windows: Sequence[Interval]):
        """Return many [s, e) windows to the free set in ONE linear merge —
        equivalent to repeated :meth:`free` but O(N + K) instead of
        O(N * K) (each ``free`` pays a list insert). The bulk path behind
        ``NodeGroup.release_resident``, whose freed-cycle lists run to
        thousands of windows at fleet horizons."""
        add = sorted((s, e) for s, e in windows if e > s)
        if not add:
            return
        out_s: List[float] = []
        out_e: List[float] = []
        starts, ends = self.starts, self.ends
        i = j = 0
        cs: float = 0.0
        ce: float = float("-inf")
        first = True
        while i < len(starts) or j < len(add):
            if j >= len(add) or (i < len(starts)
                                 and starts[i] <= add[j][0]):
                s, e = starts[i], ends[i]
                i += 1
            else:
                s, e = add[j]
                j += 1
            if first:
                cs, ce, first = s, e, False
            elif s <= ce:
                if e > ce:
                    ce = e
            else:
                out_s.append(cs)
                out_e.append(ce)
                cs, ce = s, e
        if not first:
            out_s.append(cs)
            out_e.append(ce)
        self.starts, self.ends = out_s, out_e

    def free(self, s: float, e: float):
        """Return [s, e) to the free set, merging neighbours."""
        if e <= s:
            return
        i = bisect.bisect_left(self.starts, s)
        self.starts.insert(i, s)
        self.ends.insert(i, e)
        # merge around i
        j = max(i - 1, 0)
        while j < len(self.starts) - 1:
            if self.ends[j] >= self.starts[j + 1]:
                self.ends[j] = max(self.ends[j], self.ends[j + 1])
                del self.starts[j + 1], self.ends[j + 1]
            elif j > i:
                break
            else:
                j += 1
