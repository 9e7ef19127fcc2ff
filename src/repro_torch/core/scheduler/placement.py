"""Job placement: spatio-temporal trace fitting (paper §4.3.2, Eq. 1-2).

A job's profiled cycle is a list of execution segments S = {(a_i, d_i)} with
period T and a node demand. Placement searches node groups and a Micro-Shift
delta in [0, alpha*T] minimising the Scheduling Cost

    J(delta) = w1 * (t_end(delta) - T)/T  +  w2 * delta/T        (Eq. 1)

subject to every shifted segment fitting a free window (Eq. 2). Candidate
deltas are the alignments of segment starts with free-window starts (the
classic critical-shift set), evaluated with IntervalSet bisects. Ties are
broken by predicted phase interference against resident jobs.

Cold start (no trace): a dedicated group is provisioned for clean profiling.
Warm start: trace fitting as above. A repacking event re-fits all profiled
jobs to raise packing density.

Live-plane operation (the control plane in ``core/control_plane.py``):
fitting takes an ``origin`` — the wall/virtual time the trace's cycle 0
starts — so free windows can be kept in absolute time. ``NodeGroup`` free
state is then maintained *incrementally*: ``note_busy`` carves actually
measured execution out of the free set as completions stream in,
``advance_to`` retires capacity behind ``now``, and ``extend_to`` rolls the
planning horizon forward (projecting resident jobs' periodic segments into
the new span). Groups can be added and removed at runtime
(``PlacementPolicy.add_group`` / ``remove_group``) — the hooks the capacity
adjuster drives.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.scheduler.intervals import IntervalSet

Segment = Tuple[float, float]          # (relative offset a_i, duration d_i)


@dataclasses.dataclass(frozen=True)
class JobTrace:
    """Profiled periodic demand: segments are the *active* (GPU-busy)
    execution windows within one period of length T."""
    period: float
    segments: Tuple[Segment, ...]
    nodes: int = 1

    def duty(self) -> float:
        return sum(d for _, d in self.segments) / self.period

    def end(self, shift: float = 0.0) -> float:
        return max((a + shift + d) for a, d in self.segments) if self.segments else 0.0


@dataclasses.dataclass
class NodeGroup:
    group_id: int
    nodes: int
    free: IntervalSet                   # free windows over the planning horizon
    resident: List["Placed"] = dataclasses.field(default_factory=list)
    horizon_end: float = 0.0            # absolute end of the planned span
    rev: int = 0                        # bumped on every resident change —
    #   the incremental repack planner's dirty-tracking signal
    interference_scale: float = 1.0     # EWMA correction the reconciler feeds
    #   back from realized busy overlap; multiplies phase_interference

    def __post_init__(self):
        if self.horizon_end == 0.0 and len(self.free):
            self.horizon_end = self.free.ends[-1]

    def occupancy(self, horizon: float) -> float:
        return 1.0 - self.free.total_free(horizon) / max(horizon * 1.0, 1e-9)

    # ------------------------------------------------- incremental updates
    def note_busy(self, t0: float, t1: float):
        """Carve an actually-measured execution window out of the free set
        (live completion feedback). Safe when the window overlaps segments
        the projected plan already consumed — only the intersection with
        still-free capacity is removed."""
        self.free.subtract(t0, t1)

    def advance_to(self, now: float):
        """Retire capacity behind ``now``: the past cannot be allocated."""
        self.free.trim_before(now)

    @staticmethod
    def _projected(p: "Placed", lo: float, hi: float):
        """Yield ``p``'s planned busy windows clipped to [lo, hi): the
        periodic projection of its trace segments from its anchor (one-shot
        cold reservations do not repeat). Single source of truth for both
        the free-set carving and the reconciler's drift measurement."""
        period = p.trace.period
        if period <= 0.0:
            return
        anchor = p.origin + p.shift
        c = 0 if p.once else max(0, int((lo - anchor) // period) - 1)
        while True:
            base = anchor + c * period
            if base > hi:
                break
            for a, d in p.trace.segments:
                s, e = base + a, base + a + d
                if e > lo and s < hi:
                    yield (max(s, lo), min(e, hi))
            if p.once:
                break
            c += 1

    def carve_resident(self, p: "Placed", lo: float, hi: float):
        """Subtract ``p``'s planned windows intersecting [lo, hi) from the
        free set (idempotent: already-busy spans stay busy)."""
        for s, e in self._projected(p, lo, hi):
            self.free.subtract(s, e)

    def carve_cycles(self, trace: JobTrace, shift: float, origin: float,
                     n_cycles: int, once: bool = False):
        """Subtract ``n_cycles`` of ``trace``'s segments anchored at
        ``origin + shift`` from the free set (``subtract``, not
        ``allocate``: on a live group later cycles may partially overlap
        windows already carved by measured completions — the span must end
        up busy either way). Single implementation behind ``place_warm``,
        ``place_at`` and the incremental planner's overlay."""
        for c in range(n_cycles):
            base = origin + c * trace.period + shift
            for a, d in trace.segments:
                self.free.subtract(base + a, base + a + d)
            if once:
                break

    def release_resident(self, p: "Placed", n_cycles: int):
        """Drop ``p`` from the residents and return its windows to the free
        set: the allocated cycle block plus the projected cycles beyond it
        (``extend_to`` carvings), MINUS the spans surviving residents'
        projections still occupy. Computed as one batched interval sweep
        (freed-union minus survivor-union, then ``free_many``) — the naive
        free-everything-then-re-carve-survivors version paid one bisecting
        list insert per window and dominated repack planning at fleet
        horizons. The group-local half of :meth:`PlacementPolicy.remove`,
        shared with the incremental planner's copy-on-write overlay."""
        self.resident = [r for r in self.resident if r.job_id != p.job_id]
        self.rev += 1
        freed: List[Tuple[float, float]] = []
        for c in range(n_cycles):
            base = p.origin + c * p.trace.period + p.shift
            for a, d in p.trace.segments:
                freed.append((base + a, base + a + d))
            if p.once:
                break
        if not p.once:
            anchor = p.origin + p.shift
            c = n_cycles
            while anchor + c * p.trace.period <= self.horizon_end:
                base = anchor + c * p.trace.period
                for a, d in p.trace.segments:
                    if base + a < self.horizon_end:
                        freed.append((base + a,
                                      min(base + a + d, self.horizon_end)))
                c += 1
        if not freed:
            return
        freed.sort()
        lo, hi = freed[0][0], max(e for _, e in freed)
        occupied: List[Tuple[float, float]] = []
        # survivors' planned windows clipped to [lo, hi) — the _projected
        # generator inlined: this loop enumerates every surviving window in
        # the span and generator frames double its cost at fleet horizons
        for other in self.resident:
            period = other.trace.period
            if period <= 0.0:
                continue
            anchor = other.origin + other.shift
            segs = other.trace.segments
            c = 0 if other.once else max(0, int((lo - anchor) // period) - 1)
            while True:
                base = anchor + c * period
                if base > hi:
                    break
                for a, d in segs:
                    s, e = base + a, base + a + d
                    if e > lo and s < hi:
                        occupied.append((s if s > lo else lo,
                                         e if e < hi else hi))
                if other.once:
                    break
                c += 1
        occupied.sort()

        def _union(ws):
            u: List[Tuple[float, float]] = []
            for s, e in ws:
                if u and s <= u[-1][1]:
                    if e > u[-1][1]:
                        u[-1] = (u[-1][0], e)
                else:
                    u.append((s, e))
            return u

        fu, ou = _union(freed), _union(occupied)
        give: List[Tuple[float, float]] = []
        j = 0
        for s, e in fu:
            cur = s
            while j < len(ou) and ou[j][1] <= cur:
                j += 1
            k = j
            while k < len(ou) and ou[k][0] < e:
                os_, oe = ou[k]
                if os_ > cur:
                    give.append((cur, os_))
                cur = oe
                if oe >= e:
                    break
                k += 1
            if cur < e:
                give.append((cur, e))
        self.free.free_many(give)

    def extend_to(self, new_end: float):
        """Roll the planning horizon forward to ``new_end``: the new span is
        freed, then every resident job's *periodic* segments are projected
        into it (one-shot cold reservations do not repeat)."""
        if new_end <= self.horizon_end:
            return
        old_end = self.horizon_end
        self.free.free(old_end, new_end)
        for p in self.resident:
            self.carve_resident(p, old_end, new_end)
        self.horizon_end = new_end

    def planned_windows(self, lo: float, hi: float) -> List[Tuple[float, float]]:
        """The PLAN's predicted busy windows over [lo, hi): the union of
        every resident's projected segments (merged, clipped). The live
        reconciler compares measured execution against this to detect
        realized-vs-planned occupancy drift."""
        out: List[Tuple[float, float]] = []
        for p in self.resident:
            out.extend(self._projected(p, lo, hi))
        return IntervalSet(out).intervals()

    def planned_overlap(self, t0: float, t1: float) -> float:
        """Seconds of [t0, t1) covered by the plan's predicted busy windows."""
        total = 0.0
        for s, e in self.planned_windows(t0, t1):
            total += max(0.0, min(e, t1) - max(s, t0))
        return total


@dataclasses.dataclass
class Placed:
    job_id: str
    trace: JobTrace
    group_id: int
    shift: float
    origin: float = 0.0                # absolute time of cycle 0's start
    once: bool = False                 # one-shot reservation (cold profiling)
    n_cycles: int = 0                  # cycles actually allocated


@dataclasses.dataclass(frozen=True)
class JobMove:
    """One planned live migration: re-fit ``job_id`` from ``src_group`` to
    ``dst_group`` at the new anchor (origin + shift). Carries the predicted
    interference delta and the pre-move placement so a failed realization
    can roll back exactly."""
    job_id: str
    src_group: int
    dst_group: int
    shift: float
    origin: float = 0.0
    gain: float = 0.0              # predicted interference reduction (s)
    vacates: bool = False          # last resident leaving src (consolidation)
    src_shift: float = 0.0
    src_origin: float = 0.0
    n_cycles: int = 0


@dataclasses.dataclass
class RepackPlan:
    """Result of :meth:`PlacementPolicy.plan_repack`: an ordered set of job
    moves (with predicted interference deltas) plus the same-group
    re-anchors, computed WITHOUT mutating the live placement state. Apply
    with :meth:`PlacementPolicy.apply_repack`, realize the moves through
    ``Router.reassign_jobs``."""
    origin: float
    moves: Tuple[JobMove, ...] = ()
    reshifts: Tuple[str, ...] = ()      # jobs re-anchored on their own group
    skipped: Tuple[JobMove, ...] = ()   # gain below the migration-cost floor
    fitted: Optional["PlacementPolicy"] = None   # the re-fitted state
    incremental: bool = False           # delta plan (RepackIndex): applied
    #   move-by-move via ``deltas`` instead of adopting a fitted clone
    deltas: Tuple[JobMove, ...] = ()    # ordered re-anchor sequence (cross-
    #   group moves AND same-group reshifts, in planning order)

    def __bool__(self) -> bool:
        return bool(self.moves or self.reshifts)


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    w1: float = 1.0                     # completion-delay weight
    w2: float = 0.25                    # start-shift weight
    alpha: float = 1.0                  # shift search range [0, alpha*T]
    horizon: float = 28_800.0
    max_candidates: int = 256


def scheduling_cost(trace: JobTrace, shift: float,
                    cfg: PlacementConfig) -> float:
    """Eq. 1."""
    t_end = trace.end(shift)
    return (cfg.w1 * (t_end - trace.period) / trace.period
            + cfg.w2 * shift / trace.period)


def candidate_shifts(trace: JobTrace, free: IntervalSet,
                     cfg: PlacementConfig, origin: float = 0.0) -> List[float]:
    """delta = window_start - segment_offset alignments, clipped to range.
    ``origin`` translates the trace into the free set's absolute frame."""
    cands = {0.0}
    limit = cfg.alpha * trace.period
    starts = free.starts
    for a, _ in trace.segments:
        # only window starts in [origin + a, origin + a + limit] can yield
        # an in-range delta — bisect the sorted starts instead of scanning
        # every free window (the free list grows with the horizon; the
        # search range is one period)
        lo = bisect.bisect_left(starts, origin + a)
        hi = bisect.bisect_right(starts, origin + a + limit)
        for ws in starts[lo:hi]:
            cands.add(ws - a - origin)
    out = sorted(cands)
    if len(out) > cfg.max_candidates:
        step = len(out) / cfg.max_candidates
        out = [out[int(i * step)] for i in range(cfg.max_candidates)]
    return out


def best_shift(trace: JobTrace, free: IntervalSet,
               cfg: PlacementConfig,
               origin: float = 0.0) -> Optional[Tuple[float, float]]:
    """Min-cost feasible micro-shift for one group. (shift, cost) or None."""
    best: Optional[Tuple[float, float]] = None
    for delta in candidate_shifts(trace, free, cfg, origin):
        if not free.simulate_insert(trace.segments, origin + delta):
            continue
        cost = scheduling_cost(trace, delta, cfg)
        if best is None or cost < best[1]:
            best = (delta, cost)
    return best


def wrapped_arcs(start: float, dur: float,
                 period: float) -> Tuple[Tuple[float, float], ...]:
    """The linear pieces of the arc ``[start, start+dur)`` on the circle
    ``[0, period)``: one piece when it fits, two when it crosses the period
    boundary, the whole circle when the duration covers it."""
    start %= period
    if dur >= period:
        return ((0.0, period),)
    end = start + dur
    if end <= period:
        return ((start, end),)
    return ((start, period), (0.0, end - period))


def phase_interference(trace: JobTrace, shift: float,
                       group: NodeGroup, origin: float = 0.0,
                       exclude: Optional[str] = None) -> float:
    """Predicted overlap of the shifted active segments with resident jobs'
    active segments over one hyper-cycle (lower = better, §4.3.2).

    Overlap is measured on each RESIDENT's cycle circle: both the
    candidate's shifted segments and the resident's anchored segments are
    wrapped at the resident's period boundary, so a segment crossing the
    cycle edge contributes its wrapped tail. (The pre-fix code clipped the
    overlap to ``[s0, s0+d) ∩ [rs, rs+rd)`` linearly, silently dropping
    anything past the boundary — interference near the cycle edge was
    systematically undercounted.) Mixed periods keep the paper's
    one-hyper-cycle approximation: the candidate is folded onto the
    resident's circle, i.e. the score is the overlap within one
    representative resident cycle, not the exact steady-state average over
    the full (possibly enormous) joint hyper-period.

    The sum is scaled by ``group.interference_scale`` — the reconciler's
    EWMA correction from realized busy overlap (1.0 = trust the
    prediction; a drifting group scores pessimistically so planners prefer
    placements with slack there).

    ``exclude`` skips one resident by job id — the form used when scoring a
    job that is itself already placed on the group (repack / shed ranking).
    """
    total = 0.0
    for placed in group.resident:
        if exclude is not None and placed.job_id == exclude:
            continue
        period = placed.trace.period
        if period <= 0.0:
            continue
        cand_arcs = [arc for a, d in trace.segments
                     for arc in wrapped_arcs(origin + a + shift, d, period)]
        for ra, rd in placed.trace.segments:
            for r_lo, r_hi in wrapped_arcs(placed.origin + ra + placed.shift,
                                           rd, period):
                for s_lo, s_hi in cand_arcs:
                    total += max(0.0, min(s_hi, r_hi) - max(s_lo, r_lo))
    return total * group.interference_scale


def group_duty(group: NodeGroup) -> float:
    """Aggregate duty demand of a group's residents in node-duty units."""
    return sum(p.trace.duty() * p.trace.nodes for p in group.resident)


def least_interfering_group(trace: JobTrace, groups: Sequence[NodeGroup],
                            duty_cap: float = 1.0,
                            origin: float = 0.0) -> Optional[NodeGroup]:
    """Shared §4.3.2 ranking consumed by BOTH the offline simulator
    (``ClusterSim._choose_group``) and the live reconciler: the group
    minimising (predicted phase interference, duty load, id) among those
    with duty headroom for the trace. None when no group has headroom."""
    best, best_key = None, None
    for g in groups:
        duty = group_duty(g)
        if duty + trace.duty() * trace.nodes > g.nodes * duty_cap:
            continue
        key = (phase_interference(trace, 0.0, g, origin), duty, g.group_id)
        if best_key is None or key < best_key:
            best, best_key = g, key
    return best


class PlacementPolicy:
    """Dual-phase (cold/warm) placement over a set of node groups.

    Groups are dynamic: ``add_group`` / ``remove_group`` let a live capacity
    adjuster grow and shrink the fleet between fits."""

    def __init__(self, groups: Sequence[NodeGroup],
                 cfg: PlacementConfig = PlacementConfig()):
        self.groups = list(groups)
        self._by_id: Dict[int, NodeGroup] = {g.group_id: g for g in self.groups}
        self.cfg = cfg
        self.placed: Dict[str, Placed] = {}

    # ------------------------------------------------------ group registry
    def group(self, group_id: int) -> Optional[NodeGroup]:
        return self._by_id.get(group_id)

    def add_group(self, group: NodeGroup) -> NodeGroup:
        if group.group_id in self._by_id:
            raise ValueError(f"group {group.group_id} already registered")
        self.groups.append(group)
        self._by_id[group.group_id] = group
        return group

    def remove_group(self, group_id: int) -> NodeGroup:
        g = self._by_id.get(group_id)
        if g is None:
            raise KeyError(f"unknown group {group_id}")
        if g.resident:
            raise RuntimeError(
                f"group {group_id} still hosts {[p.job_id for p in g.resident]}")
        del self._by_id[group_id]
        self.groups = [x for x in self.groups if x.group_id != group_id]
        return g

    def _eligible(self, only: Optional[Sequence[int]]) -> List[NodeGroup]:
        if only is None:
            return self.groups
        allowed = set(only)
        return [g for g in self.groups if g.group_id in allowed]

    # ------------------------------------------------------------- place
    def place_cold(self, job_id: str, nodes: int,
                   expected_duration: float, origin: float = 0.0,
                   groups: Optional[Sequence[int]] = None) -> Optional[Placed]:
        """Cold start: dedicated group for clean profiling (no sharing)."""
        for g in self._eligible(groups):
            if g.nodes >= nodes and not g.resident and \
                    g.free.covers(origin, origin + expected_duration):
                g.free.allocate(origin, origin + expected_duration)
                p = Placed(job_id, JobTrace(expected_duration,
                                            ((0.0, expected_duration),),
                                            nodes), g.group_id, 0.0,
                           origin=origin, once=True, n_cycles=1)
                g.resident.append(p)
                g.rev += 1
                self.placed[job_id] = p
                return p
        return None

    def place_warm(self, job_id: str, trace: JobTrace,
                   n_cycles: Optional[int] = None, origin: float = 0.0,
                   groups: Optional[Sequence[int]] = None,
                   pack: bool = False,
                   prefer: Optional[int] = None) -> Optional[Placed]:
        """Warm start: micro-shift trace fitting over eligible groups.

        ``pack`` breaks score ties toward groups already hosting residents
        (repacking density) and ``prefer`` toward one group id (a repack
        keeping a job where it is costs no migration); both only reorder
        EQUAL (cost, interference) candidates, so default fits are
        unchanged."""
        cfg = self.cfg
        n_cycles = n_cycles or max(1, int(cfg.horizon // trace.period))
        scored: List[Tuple[tuple, NodeGroup, float]] = []
        for g in self._eligible(groups):
            if g.nodes < trace.nodes:
                continue
            fit = best_shift(trace, g.free, cfg, origin)
            if fit is None:
                continue
            delta, cost = fit
            interf = phase_interference(trace, delta, g, origin)
            key = (round(cost, 6), interf,
                   -len(g.resident) if pack else 0,
                   0 if g.group_id == prefer else 1,
                   g.group_id)
            scored.append((key, g, delta))
        if not scored:
            return None
        scored.sort(key=lambda t: t[0])
        _, g, delta = scored[0]
        g.carve_cycles(trace, delta, origin, n_cycles)
        p = Placed(job_id, trace, g.group_id, delta, origin=origin,
                   n_cycles=n_cycles)
        g.resident.append(p)
        g.rev += 1
        self.placed[job_id] = p
        return p

    def place_at(self, job_id: str, trace: JobTrace, group_id: int,
                 shift: float, origin: float = 0.0, n_cycles: int = 0,
                 once: bool = False) -> Placed:
        """Pin a job at an EXACT (group, shift, origin) — no search. Used to
        restore a placement (failed-migration rollback, plan restore) and to
        realize a planned assignment verbatim. Windows are carved with
        ``subtract`` so re-pinning over partially measured spans is safe."""
        g = self._by_id[group_id]
        n = n_cycles or max(1, int(self.cfg.horizon
                                   // max(trace.period, 1e-9)))
        g.carve_cycles(trace, shift, origin, n, once=once)
        p = Placed(job_id, trace, group_id, shift, origin=origin, once=once,
                   n_cycles=n)
        g.resident.append(p)
        g.rev += 1
        self.placed[job_id] = p
        return p

    def clone(self) -> "PlacementPolicy":
        """Deep copy of the placement state (free windows, residents,
        placed map). ``Placed`` records are shared — they are treated as
        immutable everywhere — so a clone is cheap: two float lists per
        group. ``plan_repack`` fits against a clone so planning never
        mutates the live state."""
        groups = []
        for g in self.groups:
            c = NodeGroup(g.group_id, g.nodes,
                          IntervalSet(g.free.intervals()),
                          resident=list(g.resident),
                          horizon_end=g.horizon_end,
                          rev=g.rev,
                          interference_scale=g.interference_scale)
            groups.append(c)
        out = PlacementPolicy(groups, self.cfg)
        out.placed = dict(self.placed)
        return out

    # ------------------------------------------------------------ remove
    def remove(self, job_id: str, n_cycles: Optional[int] = None):
        p = self.placed.pop(job_id, None)
        if p is None:
            return
        g = self._by_id.get(p.group_id)
        if g is None:
            return                     # group already retired
        n_cycles = p.n_cycles or n_cycles or max(
            1, int(self.cfg.horizon // p.trace.period))
        g.release_resident(p, n_cycles)

    # ----------------------------------------------------------- repack
    def plan_repack(self, origin: float = 0.0,
                    groups: Optional[Sequence[int]] = None,
                    min_gain: float = 0.0,
                    cross_min_gain: Optional[float] = None,
                    mesh_of: Optional[Dict[int, int]] = None,
                    exclude: frozenset = frozenset()) -> RepackPlan:
        """Plan a repacking event (§4.3.2) WITHOUT mutating the live state.

        Jobs are re-fitted one at a time on a clone, by descending duty
        ratio, against live absolute-time windows (``origin`` = now). The
        result is an ordered migration plan: group-changing moves carry
        their predicted interference delta, and a move whose gain is below
        the migration-cost floor is skipped — unless it vacates its source
        group, since retiring a whole group always beats a
        millisecond-scale migration. One-shot cold reservations are pinned
        and never repacked.

        The floor is mesh-domain-aware: ``min_gain`` applies to moves
        within one mesh domain (fed from the measured
        ``placement/repack_migrate_s`` bench), while a move that crosses
        domains in ``mesh_of`` (group id -> mesh-slice index) must clear
        ``cross_min_gain`` — the realized cross-mesh reshard cost the
        director measures from ``Router.migrate_log``. Unknown groups are
        treated as crossing (the conservative floor).

        ``exclude`` pins jobs in place without re-fitting them — the
        director feeds it the recently-migrated set so the cooldown
        hysteresis also holds for full repacks."""
        clone = self.clone()
        for g in clone.groups:
            g.advance_to(origin)
        jobs = sorted(((j, p) for j, p in clone.placed.items()
                       if not p.once and j not in exclude),
                      key=lambda kv: (-kv[1].trace.duty(), kv[0]))
        moves: List[JobMove] = []
        reshifts: List[str] = []
        skipped: List[JobMove] = []
        for job_id, old in jobs:
            g_old = clone.group(old.group_id)
            if g_old is None:
                continue
            before = phase_interference(old.trace, old.shift, g_old,
                                        old.origin, exclude=job_id)
            was_last = len(g_old.resident) == 1
            clone.remove(job_id)
            p = clone.place_warm(job_id, old.trace,
                                 n_cycles=old.n_cycles or None,
                                 origin=origin, groups=groups,
                                 pack=True, prefer=old.group_id)
            if p is None:
                clone.place_at(job_id, old.trace, old.group_id, old.shift,
                               origin=old.origin, n_cycles=old.n_cycles)
                continue
            if p.group_id == old.group_id:
                if p.shift != old.shift or p.origin != old.origin:
                    reshifts.append(job_id)
                continue
            after = phase_interference(old.trace, p.shift,
                                       clone.group(p.group_id), origin,
                                       exclude=job_id)
            move = JobMove(job_id, old.group_id, p.group_id, p.shift,
                           origin=origin, gain=before - after,
                           vacates=was_last, src_shift=old.shift,
                           src_origin=old.origin, n_cycles=p.n_cycles)
            floor = min_gain
            if cross_min_gain is not None and mesh_of is not None:
                src_dom = mesh_of.get(old.group_id)
                dst_dom = mesh_of.get(p.group_id)
                if src_dom is None or dst_dom is None or src_dom != dst_dom:
                    floor = max(floor, cross_min_gain)
            if not move.vacates and move.gain < floor:
                clone.remove(job_id)
                clone.place_at(job_id, old.trace, old.group_id, old.shift,
                               origin=old.origin, n_cycles=old.n_cycles)
                skipped.append(move)
            else:
                moves.append(move)
        return RepackPlan(origin, tuple(moves), tuple(reshifts),
                          tuple(skipped), fitted=clone)

    def apply_repack(self, plan: RepackPlan):
        """Adopt a plan's re-fitted placement state. Call under the same
        lock / quiescence the plan was computed under — the plan's windows
        are a re-fit of the state as of ``plan.origin``.

        An incremental plan (``plan.incremental``) carries no fitted clone;
        its ordered ``deltas`` are replayed move-by-move (remove + pin at
        the planned anchor). A delta whose job has since vanished or moved
        off the planned source group is stale and skipped."""
        if plan.incremental:
            for m in plan.deltas:
                cur = self.placed.get(m.job_id)
                if cur is None or cur.group_id != m.src_group:
                    continue           # stale: state changed since planning
                if self.group(m.dst_group) is None:
                    continue
                self.remove(m.job_id)
                self.place_at(m.job_id, cur.trace, m.dst_group, m.shift,
                              origin=m.origin, n_cycles=m.n_cycles)
            return
        if plan.fitted is None:
            raise ValueError("plan has no fitted state (already applied?)")
        src = plan.fitted
        self.groups = src.groups
        self._by_id = src._by_id
        self.placed = src.placed
        plan.fitted = None

    def repack(self, origin: float = 0.0,
               groups: Optional[Sequence[int]] = None,
               min_gain: float = 0.0,
               cross_min_gain: Optional[float] = None,
               mesh_of: Optional[Dict[int, int]] = None) -> int:
        """Repacking event (§4.3.2), plan-then-apply: re-fit all placed jobs
        by descending duty ratio. Returns the number of jobs whose
        assignment changed (moved groups or re-anchored)."""
        plan = self.plan_repack(origin=origin, groups=groups,
                                min_gain=min_gain,
                                cross_min_gain=cross_min_gain,
                                mesh_of=mesh_of)
        self.apply_repack(plan)
        return len(plan.moves) + len(plan.reshifts)
