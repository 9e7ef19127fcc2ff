"""The reconciliation loop: detect divergence between the realized schedule
and the :class:`~repro_torch.core.control_plane.plan.ClusterPlan`, and turn it
into repack / re-profile / shed decisions (paper §4.3.2's "repack when the
realized schedule diverges from the plan").

Four triggers, all event-driven from job-step hooks (no timer thread, so
the whole decision sequence replays bit-identically under a VirtualClock):

1. **Occupancy drift** (periodic, every ``repack_interval_s``): the
   executor's measured per-group busy windows
   (``TaskExecutor.group_busy_since``) are overlapped with the plan's
   predicted windows (``NodeGroup.planned_windows``). A group whose
   realized execution falls mostly OUTSIDE its planned windows has drifted;
   the policy plans an incremental repack
   (:meth:`~repro_torch.core.scheduler.placement.PlacementPolicy.plan_repack`)
   whose moves carry predicted interference deltas and respect the
   migration-cost floor.
2. **Phase drift** (per job): the rolling cycle tail the profiler retains
   is folded into a fresh trace and compared against the trace the job was
   PLACED with. Period divergence beyond ``drift_ratio`` (either direction
   — response lengths grow as policies improve, "RL in the Wild") re-fits
   the job on the re-profiled trace.
3. **Queue pressure** (per telemetry poll): a deep-queued group hosting
   more than one warm job sheds its worst-interfering resident onto
   another group (spawning a spare if none fits) instead of merely adding
   idle capacity.
4. **SLO breach** (multi-tenant service layer): a GUARANTEED tenant whose
   rolling p95 step latency exceeds its SLO preempts the most-interfering
   BEST_EFFORT job sharing its group — shed elsewhere when a placement
   exists, else admission-held for a bounded window (work-conserving:
   best-effort work is delayed, never starved). Cooldown-aware via the
   director's ``migration_cooldown_s`` pins, so preemption cannot
   ping-pong a victim.

The reconciler only *decides*; the director applies decisions to the
placement state and realizes migrations through ``Router.reassign_jobs``.
Scoring is shared with the offline simulator (``phase_interference`` /
``least_interfering_group`` in ``scheduler/placement.py``) so predictions
and the live loop can never disagree by construction.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.control_plane.plan import (DirectorConfig, JobTrace,
                                           trace_from_cycles)
from repro_torch.core.scheduler.placement import (NodeGroup, Placed,
                                            PlacementPolicy, RepackPlan,
                                            phase_interference)
from repro_torch.core.scheduler.repack_index import RepackIndex


class Reconciler:
    """Drift detection + repack planning over one PlacementPolicy.

    Owns the rolling state the triggers need (repack cadence anchor,
    per-group busy-window cursors, the incremental repack index); holds no
    lock of its own — the director serializes calls under its decision
    lock."""

    def __init__(self, policy: PlacementPolicy, cfg: DirectorConfig):
        self.policy = policy
        self.cfg = cfg
        self.index = RepackIndex(policy)
        self._last_repack_t: Optional[float] = None
        self._busy_cursors: Dict[int, int] = {}

    # ------------------------------------------- trigger 1: occupancy drift
    def due(self, now: float) -> bool:
        """Periodic gate — a PURE predicate. Unanchored (no observation
        yet) is never due; :meth:`check`'s first observation anchors the
        cadence. (The old version mutated ``_last_repack_t`` inside this
        predicate, so merely ASKING whether a pass was due silently
        re-anchored the clock.)"""
        if self._last_repack_t is None:
            return False
        return now - self._last_repack_t >= self.cfg.repack_interval_s

    def anchor(self, now: float) -> None:
        """Anchor / advance the periodic cadence. Called on the first
        observation and after each SCHEDULED pass — never by forced
        passes, which would otherwise push back the next scheduled one."""
        self._last_repack_t = now

    def occupancy_drift(self, executor) -> List[dict]:
        """Realized-vs-planned busy overlap per group since the last check.
        Returns the groups whose measured execution diverged from the plan
        (overlap ratio below ``plan_overlap_min`` over at least
        ``min_drift_busy_s`` of measured busy time)."""
        drifted: List[dict] = []
        for g in sorted(self.policy.groups, key=lambda g: g.group_id):
            cursor = self._busy_cursors.get(g.group_id, 0)
            windows = executor.group_busy_since(g.group_id, cursor)
            if not windows:
                continue
            self._busy_cursors[g.group_id] = windows[-1][0]
            busy = sum(t1 - t0 for _, _, t0, t1 in windows)
            if busy < self.cfg.min_drift_busy_s:
                continue
            overlap = sum(min(g.planned_overlap(t0, t1), t1 - t0)
                          for _, _, t0, t1 in windows)
            ratio = overlap / busy
            beta = self.cfg.interference_ewma
            if beta > 0.0:
                # fold realized-vs-planned overlap back into the group's
                # interference prediction: fully on-plan (ratio 1) decays
                # toward neutral 1.0, fully off-plan (ratio 0) toward a 2x
                # pessimistic score, so planners route new load away from
                # groups whose execution keeps missing the plan
                target = min(2.0, max(1.0, 2.0 - ratio))
                g.interference_scale += beta * (target - g.interference_scale)
            if ratio < self.cfg.plan_overlap_min:
                drifted.append(dict(group=g.group_id,
                                    busy_s=round(busy, 6),
                                    overlap_ratio=round(ratio, 4)))
        return drifted

    def check(self, now: float, executor,
              eligible: Optional[Sequence[int]] = None,
              force: bool = False,
              min_gain: Optional[float] = None,
              cross_min_gain: Optional[float] = None,
              mesh_of: Optional[Dict[int, int]] = None,
              exclude: frozenset = frozenset()
              ) -> Optional[Tuple[RepackPlan, List[dict]]]:
        """The periodic reconcile pass: when due (or forced), measure
        occupancy drift and — if any group diverged — plan an incremental
        repack against the live absolute-time windows. Returns
        ``(plan, drifted_groups)`` or None when nothing is due/diverged.

        Cadence rules: the first observation anchors the clock (and plans
        nothing unless forced); only a SCHEDULED (due) pass re-anchors it,
        so forced passes never delay the next scheduled one.

        Planning goes through the :class:`RepackIndex` (drifted groups are
        marked dirty, candidates come from dirty groups only) unless
        ``cfg.incremental_repack`` is off, which falls back to the full
        ``plan_repack`` oracle.

        ``min_gain`` / ``cross_min_gain`` override the configured
        migration-cost floor with the director's MEASURED same-mesh /
        cross-mesh migration costs; ``mesh_of`` maps group ids to
        mesh-slice domains so the planner knows which moves pay the
        cross-mesh reshard; ``exclude`` pins jobs (the director's
        migration cooldown)."""
        if self._last_repack_t is None:
            self.anchor(now)
            if not force:
                return None
        elif self.due(now):
            self.anchor(now)
        elif not force:
            return None
        drifted = self.occupancy_drift(executor)
        if not drifted and not force:
            return None
        floor = (self.cfg.migration_floor_s if min_gain is None
                 else min_gain)
        for d in drifted:
            self.index.mark_dirty(d["group"])
        if self.cfg.incremental_repack:
            cap = self.cfg.repack_dest_search
            plan = self.index.plan(
                origin=now, groups=eligible, min_gain=floor,
                cross_min_gain=cross_min_gain, mesh_of=mesh_of,
                exclude=exclude,
                max_dest_search=cap if cap > 0 else None)
        else:
            plan = self.policy.plan_repack(
                origin=now, groups=eligible, min_gain=floor,
                cross_min_gain=cross_min_gain, mesh_of=mesh_of,
                exclude=exclude)
        return plan, drifted

    # --------------------------------------------- trigger 2: phase drift
    def phase_drift(self, cycles: Sequence[Dict[str, float]],
                    placed_trace: Optional[JobTrace],
                    nodes: int) -> Optional[Tuple[JobTrace, float]]:
        """Compare the rolling cycle tail against the trace the job was
        placed with; on divergence beyond ``drift_ratio`` return the
        re-profiled trace and the observed ratio."""
        cfg = self.cfg
        if placed_trace is None or placed_trace.period <= 0.0:
            return None
        if len(cycles) < cfg.drift_window:
            return None
        recent = trace_from_cycles(cycles[-cfg.drift_window:], nodes)
        if recent is None or recent.period <= 0.0:
            return None
        ratio = max(recent.period / placed_trace.period,
                    placed_trace.period / recent.period)
        if ratio < cfg.drift_ratio:
            return None
        return recent, ratio

    # -------------------------------------------- trigger 3: queue pressure
    def pick_shed(self, group: Optional[NodeGroup],
                  exclude=frozenset()) -> Optional[Placed]:
        """The worst-interfering warm resident of a deep-queued group — the
        job a pressure-relief repack moves onto another group. None when
        the group hosts fewer than two warm jobs (shedding the only job
        just moves the queue). ``exclude`` skips jobs the director already
        has a migration in flight for."""
        if group is None:
            return None
        warm = [p for p in group.resident
                if not p.once and p.job_id not in exclude]
        if len(warm) < 2:
            return None
        scored = sorted(
            warm,
            key=lambda p: (-phase_interference(p.trace, p.shift, group,
                                               p.origin, exclude=p.job_id),
                           p.job_id))
        return scored[0]

    # ----------------------------------------------- trigger 4: SLO breach
    def pick_preempt(self, group: Optional[NodeGroup], is_best_effort,
                     exclude=frozenset()) -> Optional[Placed]:
        """The BEST_EFFORT victim to preempt off a group whose GUARANTEED
        tenant is breaching its SLO: the most-interfering warm best-effort
        resident. Unlike :meth:`pick_shed` there is no min-2 requirement —
        removing the group's only best-effort job is exactly the point.
        ``is_best_effort(job_id) -> bool`` comes from the tenant ledger;
        ``exclude`` pins jobs already migrating, cooled, or held."""
        if group is None:
            return None
        victims = [p for p in group.resident
                   if not p.once and p.job_id not in exclude
                   and is_best_effort(p.job_id)]
        if not victims:
            return None
        scored = sorted(
            victims,
            key=lambda p: (-phase_interference(p.trace, p.shift, group,
                                               p.origin, exclude=p.job_id),
                           p.job_id))
        return scored[0]
