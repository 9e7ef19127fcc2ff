"""Incremental repack planning: flat-cost placement re-fitting at fleet
scale.

``PlacementPolicy.plan_repack`` is exact but O(fleet): it deep-copies every
group's free-window list and re-fits every placed job, so planning cost
grows superlinearly with resident count (5.4 ms -> 30 ms -> 180 ms at
4 -> 16 -> 64 jobs in ``BENCH_PR5.json``) — at the thousands of jobs a
production cluster holds, the reconciler cannot even *plan* inside its own
cadence. :class:`RepackIndex` repeats the admission-index trick (the HRRS
kinetic tournament) at the placement layer:

- **Dirty tracking.** Every :class:`~repro_torch.core.scheduler.placement.NodeGroup`
  carries a revision counter (``rev``) bumped on any resident change; the
  index remembers the revision it last planned against, so only groups
  something actually touched — a move, an add/remove, or reconciler-flagged
  occupancy drift via :meth:`RepackIndex.mark_dirty` — contribute
  re-fit candidates. A converged fleet plans in microseconds regardless of
  its size.
- **Delta planning.** Candidate jobs (the residents of dirty groups) are
  re-fitted one at a time in the full planner's order (descending duty,
  then job id) against a copy-on-write overlay: a clean group's possibly
  huge free list is never cloned, only the few groups a decision touches
  are materialized. The result is a delta
  :class:`~repro_torch.core.scheduler.placement.RepackPlan`
  (``incremental=True``) whose ordered ``deltas`` are replayed onto the
  live state move-by-move instead of adopting a wholesale re-fitted clone.
- **Candidate pruning.** Before any exact micro-shift search runs: a job
  whose current interference is already below the migration-cost floor is
  skipped outright (no move can gain more interference than the job
  suffers), and destination groups are screened with a sound duty-overlap
  lower bound — folding both jobs onto a resident's cycle circle, their
  overlap is at least ``|union(cand arcs)| + |union(res arcs)| - period``
  by pigeonhole, and the bound is rotation-invariant, so it holds for
  *every* micro-shift. A destination whose summed bound already eats the
  whole achievable gain is never searched.

With ``max_dest_search=None`` the index searches every surviving
destination and (by construction: same order, same scoring key, same
floor/vacate rules) reproduces the full planner's decisions — the property
tests in ``tests/test_repack_index.py`` pin that agreement under
randomized add/remove/drift/repack sequences. The shipped reconcile path
caps the exact searches per job at ``DirectorConfig.repack_dest_search``
most-promising destinations (ranked by the same lower bound), trading
oracle-exactness for a hard per-pass cost bound; every move it does emit
still clears the same migration-cost floor.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler.intervals import IntervalSet
from repro_torch.core.scheduler.placement import (JobMove, JobTrace, NodeGroup,
                                            Placed, PlacementPolicy,
                                            RepackPlan, best_shift,
                                            phase_interference, wrapped_arcs)


def union_busy(segments: Sequence[Tuple[float, float]], anchor: float,
               period: float) -> float:
    """Measure of the union of ``segments`` anchored at ``anchor`` and
    wrapped onto the circle ``[0, period)``. Rotation-invariant in
    ``anchor`` (wrapping is a measure-preserving bijection), which is what
    makes the pigeonhole bound below shift-independent."""
    arcs: List[Tuple[float, float]] = []
    for a, d in segments:
        arcs.extend(wrapped_arcs(anchor + a, d, period))
    arcs.sort()
    total = 0.0
    cur_lo = cur_hi = None
    for lo, hi in arcs:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


class _Overlay:
    """Copy-on-write view of a policy's groups: reads hit the live objects
    (planning never mutates them), writes materialize a private clone of
    just the touched group. The incremental analogue of
    ``PlacementPolicy.clone`` at O(touched) instead of O(fleet)."""

    def __init__(self, policy: PlacementPolicy, origin: float):
        self.policy = policy
        self.origin = origin
        self._mat: Dict[int, NodeGroup] = {}

    def group(self, group_id: int) -> Optional[NodeGroup]:
        g = self._mat.get(group_id)
        return g if g is not None else self.policy.group(group_id)

    def groups(self, eligible: Optional[frozenset]) -> List[NodeGroup]:
        out = []
        for g in self.policy.groups:
            if eligible is not None and g.group_id not in eligible:
                continue
            out.append(self._mat.get(g.group_id, g))
        return out

    def materialized(self, group_id: int) -> bool:
        return group_id in self._mat

    def materialize(self, group_id: int) -> NodeGroup:
        g = self._mat.get(group_id)
        if g is None:
            live = self.policy.group(group_id)
            g = NodeGroup(live.group_id, live.nodes,
                          IntervalSet(live.free.intervals()),
                          resident=list(live.resident),
                          horizon_end=live.horizon_end,
                          rev=live.rev,
                          interference_scale=live.interference_scale)
            g.advance_to(self.origin)
            self._mat[group_id] = g
        return g


class RepackIndex:
    """Incremental repack planner over one live :class:`PlacementPolicy`.

    Holds no lock of its own — the director serializes calls under its
    decision lock, exactly like the :class:`Reconciler` that owns it."""

    def __init__(self, policy: PlacementPolicy):
        self.policy = policy
        self._seen_rev: Dict[int, int] = {}
        self._forced: set = set()
        # per-group summary cache keyed by rev: rows of
        # (period, |union busy| on own circle) per non-degenerate resident,
        # plus the minimum circle slack (period - busy) for the O(1)
        # zero-bound fast path
        self._summaries: Dict[int, Tuple[int, List[Tuple[float, float]],
                                         float]] = {}
        self.last_stats: Dict[str, int] = {}

    # --------------------------------------------------- dirty tracking
    def mark_dirty(self, group_id: int) -> None:
        """Force a group's residents back into the next pass's candidate
        set even though its placement state did not change — the
        reconciler's hook for occupancy drift (the plan is stale, not the
        placements)."""
        self._forced.add(group_id)

    def dirty_groups(self) -> List[int]:
        """Groups whose residents changed since the last plan (revision
        mismatch), were never planned against, or were force-marked."""
        out = []
        for g in self.policy.groups:
            if (self._seen_rev.get(g.group_id) != g.rev
                    or g.group_id in self._forced):
                out.append(g.group_id)
        return sorted(out)

    # ------------------------------------------------------- summaries
    def _summary(self, g: NodeGroup,
                 cached: bool) -> Tuple[List[Tuple[float, float]], float]:
        if cached:
            hit = self._summaries.get(g.group_id)
            if hit is not None and hit[0] == g.rev:
                return hit[1], hit[2]
        rows = []
        slack_min = float("inf")
        for r in g.resident:
            period = r.trace.period
            if period <= 0.0:
                continue
            busy = union_busy(r.trace.segments, r.origin + r.shift, period)
            rows.append((period, busy))
            slack_min = min(slack_min, period - busy)
        if cached:
            self._summaries[g.group_id] = (g.rev, rows, slack_min)
        return rows, slack_min

    def _dest_bound(self, trace: JobTrace, cand_len: float, g: NodeGroup,
                    overlay: _Overlay, a_cache: Dict[float, float]) -> float:
        """Sound lower bound on ``phase_interference(trace, shift, g)``
        over ALL shifts: per resident circle, overlap >= |union(cand)| +
        |union(res)| - period (pigeonhole), each term rotation-invariant.
        Fast path: when the candidate's total busy fits every resident's
        circle slack, the bound is exactly zero — one comparison."""
        rows, slack_min = self._summary(
            g, cached=not overlay.materialized(g.group_id))
        if not rows or cand_len <= slack_min:
            return 0.0
        lb = 0.0
        for period, busy in rows:
            a_u = a_cache.get(period)
            if a_u is None:
                a_u = union_busy(trace.segments, 0.0, period)
                a_cache[period] = a_u
            lb += max(0.0, a_u + busy - period)
        return lb * g.interference_scale

    # ------------------------------------------------------------ plan
    @staticmethod
    def _floor_for(src: int, dst: int, min_gain: float,
                   cross_min_gain: Optional[float],
                   mesh_of: Optional[Dict[int, int]]) -> float:
        floor = min_gain
        if cross_min_gain is not None and mesh_of is not None:
            src_dom, dst_dom = mesh_of.get(src), mesh_of.get(dst)
            if src_dom is None or dst_dom is None or src_dom != dst_dom:
                floor = max(floor, cross_min_gain)
        return floor

    @staticmethod
    def _snapshot(g: NodeGroup) -> tuple:
        """Cheap undo point for a materialized (private) group clone:
        C-speed list copies, vs re-carving thousands of cycle windows one
        ``subtract`` at a time to put a released candidate back."""
        return (g.free.starts[:], g.free.ends[:], list(g.resident), g.rev)

    @staticmethod
    def _restore(g: NodeGroup, snap: tuple) -> None:
        g.free.starts, g.free.ends, g.resident, g.rev = snap

    def plan(self, origin: float = 0.0,
             groups: Optional[Sequence[int]] = None,
             min_gain: float = 0.0,
             cross_min_gain: Optional[float] = None,
             mesh_of: Optional[Dict[int, int]] = None,
             exclude: frozenset = frozenset(),
             max_dest_search: Optional[int] = None,
             prune_dests: bool = True) -> RepackPlan:
        """Plan a delta repack WITHOUT mutating the live state: re-fit only
        the residents of dirty groups, against a copy-on-write overlay.
        Same candidate order, scoring key, migration-cost floors and
        vacate exemption as ``plan_repack`` — see the module docstring for
        where the two can diverge (``max_dest_search``).

        ``groups`` restricts *destinations* (candidacy is dirtiness);
        ``exclude`` pins jobs (the director's migration cooldown);
        ``max_dest_search`` caps exact micro-shift searches per job
        (None = search every surviving destination); ``prune_dests``
        toggles the duty-overlap bound screen. With ``min_gain=0``,
        ``max_dest_search=None`` and ``prune_dests=False`` the decisions
        are bit-identical to ``plan_repack`` on the same (all-dirty)
        state — the oracle mode the property tests pin. With a positive
        floor the index intentionally deviates in two below-floor ways:
        a job whose interference is under the floor is skipped without
        re-fitting (the oracle may re-anchor it in place — no migration
        either way), and a pruned destination the oracle WOULD have
        picked-then-skipped can let the index take a different move that
        actually clears the floor (gain the oracle leaves on the table).
        Returns an ``incremental=True`` plan; groups planned against are
        marked clean, so the next pass only revisits what the application
        of this plan (or new drift) touches."""
        pol = self.policy
        cfg = pol.cfg
        live_ids = {g.group_id for g in pol.groups}
        for gid in list(self._seen_rev):
            if gid not in live_ids:
                del self._seen_rev[gid]
                self._summaries.pop(gid, None)
        self._forced &= live_ids
        dirty = self.dirty_groups()
        eligible = None if groups is None else frozenset(groups)

        cands: List[Placed] = []
        for gid in dirty:
            for p in pol.group(gid).resident:
                if not p.once and p.job_id not in exclude:
                    cands.append(p)
        cands.sort(key=lambda p: (-p.trace.duty(), p.job_id))

        overlay = _Overlay(pol, origin)
        moves: List[JobMove] = []
        reshifts: List[str] = []
        skipped: List[JobMove] = []
        deltas: List[JobMove] = []
        stats = dict(candidates=len(cands), pruned_jobs=0, pruned_dests=0,
                     searched=0, dirty=len(dirty))

        for old in cands:
            job_id = old.job_id
            src_gid = old.group_id
            src = overlay.group(src_gid)
            if src is None:
                continue
            trace = old.trace
            before = phase_interference(trace, old.shift, src, old.origin,
                                        exclude=job_id)
            was_last = len(src.resident) == 1
            if not was_last and before < min_gain:
                # no destination can gain more than the interference the
                # job currently suffers — same outcome as the oracle's
                # re-fit-then-revert, minus the search
                stats["pruned_jobs"] += 1
                continue
            n = old.n_cycles or max(1, int(cfg.horizon
                                           // max(trace.period, 1e-9)))
            src_m = overlay.materialize(src_gid)
            snap = self._snapshot(src_m)
            src_m.release_resident(old, n)

            a_cache: Dict[float, float] = {}
            cand_len = sum(d for _, d in trace.segments)
            search: List[NodeGroup] = []
            ranked: List[Tuple[Tuple[float, int, int], NodeGroup]] = []
            summaries = self._summaries
            mat = overlay._mat
            flat_floor = cross_min_gain is None or mesh_of is None
            for g in overlay.groups(eligible):
                if g.nodes < trace.nodes:
                    continue
                gid = g.group_id
                if gid == src_gid:
                    search.append(g)   # staying pays no migration: exempt
                    continue
                # zero-bound fast path inlined (the ranking loop runs per
                # fleet group; a clean group with circle slack for the
                # candidate bounds to exactly 0 via one cache hit)
                hit = None if gid in mat else summaries.get(gid)
                if (hit is not None and hit[0] == g.rev
                        and (not hit[1] or cand_len <= hit[2])):
                    lb = 0.0
                else:
                    lb = self._dest_bound(trace, cand_len, g, overlay,
                                          a_cache)
                if prune_dests and not was_last:
                    floor_g = (min_gain if flat_floor else
                               self._floor_for(src_gid, gid, min_gain,
                                               cross_min_gain, mesh_of))
                    if before - lb < floor_g:
                        stats["pruned_dests"] += 1
                        continue
                ranked.append(((lb, -len(g.resident), gid), g))
            ranked.sort(key=lambda t: t[0])
            if max_dest_search is not None:
                ranked = ranked[:max_dest_search]
            search.extend(g for _, g in ranked)

            best: Optional[Tuple[tuple, NodeGroup, float]] = None
            for g in search:
                fit = best_shift(trace, g.free, cfg, origin)
                if fit is None:
                    continue
                stats["searched"] += 1
                delta, cost = fit
                interf = phase_interference(trace, delta, g, origin)
                key = (round(cost, 6), interf, -len(g.resident),
                       0 if g.group_id == src_gid else 1, g.group_id)
                if best is None or key < best[0]:
                    best = (key, g, delta)

            if best is None:
                self._restore(src_m, snap)
                continue
            key, g_best, delta = best
            if g_best.group_id == src_gid:
                if delta != old.shift or origin != old.origin:
                    newp = Placed(job_id, trace, src_gid, delta,
                                  origin=origin, n_cycles=n)
                    src_m.carve_cycles(trace, delta, origin, n)
                    src_m.resident.append(newp)
                    src_m.rev += 1
                    mv = JobMove(job_id, src_gid, src_gid, delta,
                                 origin=origin, gain=0.0,
                                 src_shift=old.shift, src_origin=old.origin,
                                 n_cycles=n)
                    reshifts.append(job_id)
                    deltas.append(mv)
                else:
                    self._restore(src_m, snap)
                continue
            after = key[1]
            move = JobMove(job_id, src_gid, g_best.group_id, delta,
                           origin=origin, gain=before - after,
                           vacates=was_last, src_shift=old.shift,
                           src_origin=old.origin, n_cycles=n)
            floor_g = self._floor_for(src_gid, g_best.group_id, min_gain,
                                      cross_min_gain, mesh_of)
            if not move.vacates and move.gain < floor_g:
                skipped.append(move)
                self._restore(src_m, snap)
                continue
            dst_m = overlay.materialize(g_best.group_id)
            newp = Placed(job_id, trace, dst_m.group_id, delta,
                          origin=origin, n_cycles=n)
            dst_m.carve_cycles(trace, delta, origin, n)
            dst_m.resident.append(newp)
            dst_m.rev += 1
            moves.append(move)
            deltas.append(move)

        for gid in dirty:
            g = pol.group(gid)
            if g is not None:
                self._seen_rev[gid] = g.rev
            self._forced.discard(gid)
        stats["moves"] = len(moves)
        stats["reshifts"] = len(reshifts)
        self.last_stats = stats
        return RepackPlan(origin, tuple(moves), tuple(reshifts),
                          tuple(skipped), fitted=None, incremental=True,
                          deltas=tuple(deltas))
