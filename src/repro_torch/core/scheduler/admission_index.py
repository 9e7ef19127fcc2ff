"""Incremental HRRS admission index (kinetic tournament over score lines).

Algorithm 1 (``hrrs.schedule``) re-scores the entire pending pool on every
admission — O(n log n) per pick, measured as the dominant cost of the
dispatch plane's hot path. This module maintains the *same* argmax
incrementally, exploiting the structure of the HRRS score

    P_i(t) = rho_i * (1 + max(0, t - a_i) / s_i),  s_i = max(e_i + C, 1e-9)

where ``C`` is the context-switch surcharge (``t_load + t_offload`` if the
request's job is not resident, else 0) and ``rho_i`` is the request's tenant
priority (1.0 default). For t >= a_i each score is a line in ``t`` with
slope ``rho_i / s_i``; any two lines cross at most once, so the winner of a
pairwise comparison flips at most once in the future — the multiplicative
priority term preserves the kinetic invariant. (Unequal priorities add one
new event class: a risen line crossing the other's flat pre-arrival level
``rho``; with equal priorities that crossing degenerates to the arrival
kink, which was already an event, so default-tenant behaviour is
unchanged.) A *kinetic tournament* — a
flat-array tournament tree in the style of ``segment_tree.MinSegmentTree``,
where every internal node caches its subtree's current winner plus a
*certificate* (the earliest future time any comparison below it may flip) —
therefore supports:

- ``insert`` / ``remove``: one root path, O(log n);
- ``peek(t)``: expired certificates are re-evaluated (amortised O(log^2 n)
  per elapsed crossing, O(1) when nothing crossed), then the root winner is
  exact at ``t``.

Certificates only gate *when* a node is re-compared; every re-comparison uses
the exact ``hrrs.queued_score`` floats and Algorithm 1's full tie-break
``(-score, arrival, req_id)``, so the index's pick is bit-identical to the
full re-score. Crossing times are solved algebraically and widened by a
conservative guard band: firing a certificate early merely costs one extra
O(1) re-comparison, while firing late could miss a flip — so all float error
is pushed to the harmless side.

The switch bit flips for a whole job bucket whenever the group's resident job
changes (every context switch) — far too often to re-key per request. Instead
``GroupAdmissionIndex`` keeps, per job, TWO tournaments over the same
entries: one scored resident (C = 0) and one scored non-resident
(C = setup). A resident-job change then costs *nothing* structurally; the
query just reads each bucket's applicable tournament and reduces the (few)
bucket winners with the exact Algorithm-1 key. Setup-cost recalibration
(``set_setup_costs``) is the one O(n) event: it re-pulls the non-resident
tournaments, and only when the measured value actually changed.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.scheduler import hrrs

INF = float("inf")

# Relative half-width of the certificate guard band around an algebraically
# solved crossing time. ~1e9 x the double-precision error of the solve: early
# firing is a spare comparison, late firing would break equivalence.
_GUARD = 1e-7


class Entry:
    """Immutable scoring inputs of one queued request."""

    __slots__ = ("req_id", "job_id", "arrival", "exec_time", "priority")

    def __init__(self, req_id: int, job_id: str, arrival: float,
                 exec_time: float, priority: float = 1.0):
        self.req_id = req_id
        self.job_id = job_id
        self.arrival = arrival
        self.exec_time = exec_time
        self.priority = priority


class KineticTournament:
    """Kinetic tournament over HRRS score lines with a fixed switch bit.

    Flat-array layout like ``MinSegmentTree``: node ``i`` has children
    ``2i``/``2i+1``; leaf ``size + slot`` holds entry ``slot``. ``win[i]`` is
    the winning slot of the subtree (-1 if empty), ``exp[i]`` the earliest
    future time the subtree's winner may change.
    """

    def __init__(self, switch: bool, setup: float, capacity: int = 4):
        self.switch = switch
        self.setup = setup
        self.t_front = -INF            # last time certificates were settled
        self.slot_of: Dict[int, int] = {}
        self._alloc(max(capacity, 2))

    def _alloc(self, capacity: int):
        size = 1
        while size < capacity:
            size *= 2
        self.size = size
        self.win: List[int] = [-1] * (2 * size)
        self.exp: List[float] = [INF] * (2 * size)
        self.entries: List[Optional[Entry]] = [None] * size
        # per-slot service time s_i = max(e_i + C, 1e-9), cached because the
        # surcharge C is fixed per tournament (recomputed on set_setup)
        self.s: List[float] = [1.0] * size
        # per-slot tenant priority rho_i (multiplicative score weight)
        self.prio: List[float] = [1.0] * size
        self._free = list(range(size - 1, -1, -1))

    def __len__(self) -> int:
        return len(self.slot_of)

    # --------------------------------------------------------- comparisons
    def _surcharge(self) -> float:
        return self.setup if self.switch else 0.0

    def _slot_s(self, e: Entry) -> float:
        return max(e.exec_time + self._surcharge(), 1e-9)

    def _score_slot(self, slot: int, t: float) -> float:
        # identical floats to hrrs.queued_score, with s_i precomputed
        # (prio * ((w + s) / s) matches hrrs_score's operation order exactly;
        # 1.0 * x == x bit-for-bit, so default-tenant scores are unchanged)
        s = self.s[slot]
        w = t - self.entries[slot].arrival
        if w < 0.0:
            w = 0.0
        return self.prio[slot] * ((w + s) / s)

    def _beats(self, i: int, j: int, t: float) -> bool:
        """Exact Algorithm-1 comparison of slots i, j at time t."""
        pa = self._score_slot(i, t)
        pb = self._score_slot(j, t)
        if pa != pb:
            return pa > pb
        a, b = self.entries[i], self.entries[j]
        if a.arrival != b.arrival:
            return a.arrival < b.arrival
        return a.req_id < b.req_id

    def _next_event(self, i: int, j: int, t: float) -> float:
        """Earliest time strictly after ``t`` at which the winner among
        slots i, j may change; INF if the order is settled forever.

        The comparator can only change at an arrival kink (a score leaves
        its flat wait=0 region), at the single crossing of the two rising
        lines, or — with unequal tenant priorities — where one risen line
        crosses the other's flat pre-arrival level ``rho`` (with equal
        priorities that point degenerates to the arrival kink, already an
        event). Every crossing is widened to [ts - guard, ts + guard]; if
        ``t`` already sits inside the band the certificate is "immediately
        after t", degrading to one exact re-comparison per query until the
        band is cleared — never to a missed flip.
        """
        a, b = self.entries[i], self.entries[j]
        nxt = INF
        if a.arrival > t:
            nxt = a.arrival
        if t < b.arrival < nxt:
            nxt = b.arrival
        sa = self.s[i]
        sb = self.s[j]
        pa = self.prio[i]
        pb = self.prio[j]
        if pa == pb:
            # equal priorities: the common factor rho cancels from the
            # crossing solve, so keep the original algebra verbatim
            # (bit-identical certificates on the default-tenant path)
            if sa != sb:
                d = sb - sa
                ts = (a.arrival * sb - b.arrival * sa) / d
                if ts != ts:           # NaN-safe: treat as "recheck next"
                    return min(nxt, math.nextafter(t, INF))
                guard = _GUARD * (1.0 + abs(ts)) + _GUARD * (
                    sa * sb + abs(a.arrival) * sb
                    + abs(b.arrival) * sa) / abs(d)
                if ts + guard > t:     # crossing not safely behind us
                    lo = ts - guard
                    cand = lo if lo > t else math.nextafter(t, INF)
                    if cand < nxt:
                        nxt = cand
            return nxt
        # Unequal priorities. Joint crossing of the two rising lines
        # rho_i * (1 + (t - a_i)/s_i): slopes k = rho/s, intercepts solved at
        # each arrival.
        ka = pa / sa
        kb = pb / sb
        if ka != kb:
            d = ka - kb
            ts = (ka * a.arrival - kb * b.arrival + pb - pa) / d
            if ts != ts:               # NaN-safe: treat as "recheck next"
                return min(nxt, math.nextafter(t, INF))
            guard = _GUARD * (1.0 + abs(ts)) + _GUARD * (
                abs(ka * a.arrival) + abs(kb * b.arrival)
                + pa + pb) / abs(d)
            if ts + guard > t:
                lo = ts - guard
                cand = lo if lo > t else math.nextafter(t, INF)
                if cand < nxt:
                    nxt = cand
        # New event class: a risen line reaching the other's flat pre-arrival
        # level rho_other, which can flip the winner strictly before the
        # second arrival kink. Only relevant while the other line is still
        # flat (crossing before its arrival, guard-widened).
        for arr_r, p_r, s_r, arr_o, p_o in (
                (a.arrival, pa, sa, b.arrival, pb),
                (b.arrival, pb, sb, a.arrival, pa)):
            if p_r <= 0.0:
                continue
            tf = arr_r + (p_o - p_r) * s_r / p_r
            if tf != tf:               # NaN-safe
                return min(nxt, math.nextafter(t, INF))
            guard = _GUARD * (1.0 + abs(tf) + abs(arr_r)
                              + abs(p_o - p_r) * s_r / p_r)
            if tf - guard < arr_o and tf + guard > t:
                lo = tf - guard
                cand = lo if lo > t else math.nextafter(t, INF)
                if cand < nxt:
                    nxt = cand
        return nxt

    # ------------------------------------------------------------ internal
    def _pull(self, node: int, t: float):
        l, r = 2 * node, 2 * node + 1
        wl, wr = self.win[l], self.win[r]
        if wl < 0 or wr < 0:
            self.win[node] = wl if wl >= 0 else wr
            self.exp[node] = min(self.exp[l], self.exp[r])
        else:
            self.win[node] = wl if self._beats(wl, wr, t) else wr
            self.exp[node] = min(self.exp[l], self.exp[r],
                                 self._next_event(wl, wr, t))

    def _pull_path(self, slot: int, t: float):
        node = (self.size + slot) // 2
        while node:
            self._pull(node, t)
            node //= 2

    def _rebuild(self, t: float):
        for node in range(self.size - 1, 0, -1):
            self._pull(node, t)

    def _advance_node(self, node: int, t: float):
        if node < self.size and self.exp[node] <= t:
            self._advance_node(2 * node, t)
            self._advance_node(2 * node + 1, t)
            self._pull(node, t)

    def advance(self, t: float):
        """Settle every certificate expiring at or before ``t``."""
        if t < self.t_front:
            # Non-monotonic clock (never the executor's contract, but a
            # correct fallback beats a wrong winner): full re-pull.
            self.t_front = t
            self._rebuild(t)
            return
        self.t_front = t
        self._advance_node(1, t)

    # -------------------------------------------------------------- public
    def insert(self, req_id: int, job_id: str, arrival: float,
               exec_time: float, t: float, priority: float = 1.0):
        if req_id in self.slot_of:
            return
        self.advance(t)
        if not self._free:
            self._grow(t)
        slot = self._free.pop()
        e = Entry(req_id, job_id, arrival, exec_time, priority)
        self.entries[slot] = e
        self.s[slot] = self._slot_s(e)
        self.prio[slot] = e.priority
        self.slot_of[req_id] = slot
        self.win[self.size + slot] = slot
        self._pull_path(slot, t)

    def remove(self, req_id: int, t: float) -> bool:
        slot = self.slot_of.pop(req_id, None)
        if slot is None:
            return False
        self.advance(t)
        self.entries[slot] = None
        self.win[self.size + slot] = -1
        self._free.append(slot)
        self._pull_path(slot, t)
        return True

    def peek(self, t: float) -> Optional[Entry]:
        """The exact Algorithm-1 argmax over the indexed pool at time t."""
        self.advance(t)
        w = self.win[1]
        return None if w < 0 else self.entries[w]

    def set_setup(self, setup: float):
        """Setup-cost recalibration: every certificate and comparison is
        parameterised by it, so re-pull the whole tree (O(n); rare)."""
        self.setup = setup
        for slot, e in enumerate(self.entries):
            if e is not None:
                self.s[slot] = self._slot_s(e)
        self._rebuild(self.t_front)

    def _grow(self, t: float):
        old = self.entries
        self._alloc(self.size * 2)
        for slot, e in enumerate(old):
            if e is not None:
                self.entries[slot] = e
                self.s[slot] = self._slot_s(e)
                self.prio[slot] = e.priority
                self.win[self.size + slot] = slot
        self._free = [s for s in range(self.size - 1, -1, -1)
                      if self.entries[s] is None]
        self._rebuild(t)


class GroupAdmissionIndex:
    """Per-node-group admission index: one job bucket = two tournaments.

    ``pick(now, resident_job)`` reduces each bucket's applicable winner
    (resident bucket -> no-switch tournament, others -> switch tournament)
    with the exact ``hrrs.sort_key``, so the result equals
    ``hrrs.schedule(...)[0]`` over the same pool. O(J + log n) per pick for
    J jobs sharing the group.
    """

    def __init__(self, t_load: float = 0.0, t_offload: float = 0.0):
        self.setup = t_load + t_offload
        self.buckets: Dict[str, Tuple[KineticTournament,
                                      KineticTournament]] = {}
        self._job_of: Dict[int, str] = {}

    def __len__(self) -> int:
        return len(self._job_of)

    def insert(self, req_id: int, job_id: str, arrival: float,
               exec_time: float, now: float, priority: float = 1.0):
        if req_id in self._job_of:
            # upsert: a reused req_id must not leave a ghost entry behind
            # in another job's bucket (unreachable by remove() otherwise)
            self.remove(req_id, now)
        pair = self.buckets.get(job_id)
        if pair is None:
            pair = self.buckets[job_id] = (
                KineticTournament(switch=False, setup=self.setup),
                KineticTournament(switch=True, setup=self.setup))
        for kt in pair:
            kt.insert(req_id, job_id, arrival, exec_time, now, priority)
        self._job_of[req_id] = job_id

    def remove(self, req_id: int, now: float) -> bool:
        job_id = self._job_of.pop(req_id, None)
        if job_id is None:
            return False
        pair = self.buckets[job_id]
        for kt in pair:
            kt.remove(req_id, now)
        if not len(pair[0]):
            del self.buckets[job_id]
        return True

    def set_setup_costs(self, t_load: float, t_offload: float):
        setup = t_load + t_offload
        if setup == self.setup:
            return
        self.setup = setup
        for _, kt_switch in self.buckets.values():
            kt_switch.set_setup(setup)

    def pick(self, now: float, resident_job: Optional[str]) -> Optional[int]:
        """req_id of the next request Algorithm 1 would admit, or None."""
        best_key = None
        best_id = None
        for job_id, (kt_res, kt_sw) in self.buckets.items():
            e = (kt_res if job_id == resident_job else kt_sw).peek(now)
            if e is None:
                continue
            switch = job_id != resident_job
            key = (-hrrs.queued_score(e.exec_time, e.arrival, now,
                                      switch, self.setup, e.priority),
                   e.arrival, e.req_id)
            if best_key is None or key < best_key:
                best_key, best_id = key, e.req_id
        return best_id
