"""Lazy range-add / range-min segment tree over the capacity ring buffer.

Backs the Global Capacity Profile's O(log T) gang-feasibility pruning
(paper §5.2.1: "Segment Tree Pruning ... filters out over 80% of the search
space before accessing granular states").
"""
from __future__ import annotations

from typing import List


class MinSegmentTree:
    """Range-add, range-min, point-query segment tree (lazy propagation)."""

    def __init__(self, values: List[float]):
        self.n = len(values)
        size = 1
        while size < self.n:
            size *= 2
        self.size = size
        inf = float("inf")
        self.mn = [inf] * (2 * size)
        self.lz = [0.0] * (2 * size)
        for i, v in enumerate(values):
            self.mn[size + i] = float(v)
        for i in range(size - 1, 0, -1):
            self.mn[i] = min(self.mn[2 * i], self.mn[2 * i + 1])

    # ------------------------------------------------------------ internal
    def _push(self, node: int):
        if self.lz[node]:
            for child in (2 * node, 2 * node + 1):
                self.mn[child] += self.lz[node]
                self.lz[child] += self.lz[node]
            self.lz[node] = 0.0

    def _add(self, node, node_l, node_r, l, r, delta):
        if r <= node_l or node_r <= l:
            return
        if l <= node_l and node_r <= r:
            self.mn[node] += delta
            self.lz[node] += delta
            return
        self._push(node)
        mid = (node_l + node_r) // 2
        self._add(2 * node, node_l, mid, l, r, delta)
        self._add(2 * node + 1, mid, node_r, l, r, delta)
        self.mn[node] = min(self.mn[2 * node], self.mn[2 * node + 1])

    def _min(self, node, node_l, node_r, l, r) -> float:
        if r <= node_l or node_r <= l:
            return float("inf")
        if l <= node_l and node_r <= r:
            return self.mn[node]
        self._push(node)
        mid = (node_l + node_r) // 2
        return min(self._min(2 * node, node_l, mid, l, r),
                   self._min(2 * node + 1, mid, node_r, l, r))

    # ------------------------------------------------------------- public
    def add(self, l: int, r: int, delta: float):
        """values[l:r] += delta."""
        if l < r:
            self._add(1, 0, self.size, l, r, delta)

    def range_min(self, l: int, r: int) -> float:
        """min(values[l:r])."""
        if l >= r:
            return float("inf")
        return self._min(1, 0, self.size, l, r)

    def point(self, i: int) -> float:
        return self.range_min(i, i + 1)
