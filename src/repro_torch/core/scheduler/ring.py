"""Cyclic time horizon: the Global Capacity Profile C_global(t).

Paper §4.3.1/§5.2.1: a fixed-size ring buffer (28,800 one-second slots for an
8-hour horizon) mapped by modulo arithmetic, with a segment tree for O(log T)
range-min gang-feasibility checks and commit-once atomic reservations.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.scheduler.segment_tree import MinSegmentTree

DEFAULT_SLOTS = 28_800          # 8 h at 1 s granularity
DEFAULT_SLOT_SECONDS = 1.0


class CapacityRing:
    def __init__(self, total_nodes: int, slots: int = DEFAULT_SLOTS,
                 slot_seconds: float = DEFAULT_SLOT_SECONDS):
        self.total_nodes = total_nodes
        self.slots = slots
        self.slot_seconds = slot_seconds
        self.tree = MinSegmentTree([float(total_nodes)] * slots)

    # -------------------------------------------------------------- index
    def idx(self, t_abs: float) -> int:
        """t_idx = t_abs (mod L) — unbounded horizon without array shifts."""
        return int(t_abs / self.slot_seconds) % self.slots

    def _ranges(self, t0: float, duration: float) -> List[Tuple[int, int]]:
        """Wrap an absolute interval onto ring index ranges."""
        a = self.idx(t0)
        n = min(self.slots, max(1, int(round(duration / self.slot_seconds))))
        if a + n <= self.slots:
            return [(a, a + n)]
        return [(a, self.slots), (0, (a + n) % self.slots)]

    # ------------------------------------------------------------ queries
    def min_free(self, t0: float, duration: float) -> float:
        """min free nodes over [t0, t0+duration) — the O(log T) gang check."""
        return min(self.tree.range_min(l, r) for l, r in self._ranges(t0, duration))

    def feasible(self, t0: float, duration: float, nodes: int) -> bool:
        return self.min_free(t0, duration) >= nodes

    def free_at(self, t: float) -> float:
        return self.tree.point(self.idx(t))

    # --------------------------------------------------------- mutations
    def reserve(self, t0: float, duration: float, nodes: int) -> bool:
        """Commit-once atomic reservation (subtract across the horizon).

        Returns False (and reserves nothing) if any slot would go negative.
        """
        if not self.feasible(t0, duration, nodes):
            return False
        for l, r in self._ranges(t0, duration):
            self.tree.add(l, r, -float(nodes))
        return True

    def reserve_periodic(self, t0: float, duration: float, nodes: int,
                         period: float) -> bool:
        """Reserve every period-spaced occurrence across the ring horizon
        (atomic pre-allocation of all future cycles, §4.3.1)."""
        n_rep = max(1, int(self.slots * self.slot_seconds / period))
        offs = [t0 + i * period for i in range(n_rep)]
        if not all(self.feasible(t, duration, nodes) for t in offs):
            return False
        for t in offs:
            for l, r in self._ranges(t, duration):
                self.tree.add(l, r, -float(nodes))
        return True

    def release(self, t0: float, duration: float, nodes: int):
        for l, r in self._ranges(t0, duration):
            self.tree.add(l, r, float(nodes))

    def release_periodic(self, t0: float, duration: float, nodes: int,
                         period: float):
        n_rep = max(1, int(self.slots * self.slot_seconds / period))
        for i in range(n_rep):
            self.release(t0 + i * period, duration, nodes)
