"""Cluster control plane: online profiling, automatic placement, capacity
adjustment, and continuous reconciliation (paper §4.3-§4.4).

The :class:`PlacementDirector` closes the loop between the trace-fitting
placement machinery (``scheduler/placement.py``), the live serve-mode
dispatch plane (``router.py``), and state migration — and, since the
reconciliation refactor, keeps closing it: placement is a *loop*, not a
one-shot decision at cold→warm promotion.

- **Online profiler.** The executor exports a per-job stream of
  :class:`~repro_torch.core.scheduler.executor.PhaseRecord` completions; the
  director folds them into per-cycle phase durations and, once a clean
  cycle exists, into the same
  :class:`~repro_torch.core.scheduler.placement.JobTrace` the simulator consumes
  (§4.3.2 cold-start profiling). A bounded rolling tail of cycles is
  retained for EVERY job so drift can be re-profiled later.
- **Cold → warm lifecycle.** A job arriving with no trace is placed on a
  dedicated profiling group (``place_cold``); after ``cold_cycles`` clean
  cycles it is re-fitted with ``place_warm`` micro-shift search
  (pack-first) and, if the fit lands elsewhere, migrated live.
- **Reconciliation** (:mod:`repro_torch.core.control_plane.reconcile`). Four
  standing triggers keep the realized schedule converged on the
  :class:`~repro_torch.core.control_plane.plan.ClusterPlan`: periodic
  realized-vs-planned occupancy drift plans an incremental repack
  (migration-cost floor respected), per-job phase drift re-profiles and
  re-fits a diverged job, queue pressure sheds the worst-interfering
  job off a deep-queued group, and a GUARANTEED tenant's SLO breach
  (rolling p95 step latency, folded per tenant from the PhaseRecord
  stream) preempts the most-interfering BEST_EFFORT job on its group —
  shed elsewhere when a placement exists, else admission-held for a
  bounded ``slo_hold_s`` window. Repack planning goes through the
  :class:`~repro_torch.core.scheduler.repack_index.RepackIndex` (dirty groups
  only — flat cost at fleet scale; ``plan_repack`` stays the oracle), and
  a per-job migration cooldown (``migration_cooldown_s``) pins recently
  moved jobs so pressure relief cannot ping-pong them. Decisions batch
  into ordered :class:`~repro_torch.core.scheduler.placement.JobMove` lists
  realized through ``Router.reassign_jobs`` (vacate-before-fill, per-move
  rollback).
- **Capacity adjuster** (§4.4). Queue-depth / occupancy telemetry drives
  group spawn (``Router.ensure_group``) and retire
  (``Router.retire_group``), bounded by ``min_groups`` / ``max_groups``.

Everything is event-driven from job arrivals and step completions (no
background timer thread), so the whole decision sequence is deterministic
under a :class:`~repro_torch.core.scheduler.executor.VirtualClock` and replayable
bit-identically; ``events`` is the append-only decision log tests and
operators read.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence

from repro_torch.core.control_plane.plan import (PHASE_OF_OP, ClusterPlan,
                                           DirectorConfig, plan_from_policy,
                                           trace_from_cycles)
from repro_torch.core.control_plane.reconcile import Reconciler
from repro_torch.core.scheduler.executor import TaskExecutor  # noqa: F401 (docs)
from repro_torch.core.scheduler.intervals import IntervalSet
from repro_torch.core.scheduler.placement import (JobMove, JobTrace, NodeGroup,
                                            Placed, PlacementConfig,
                                            PlacementPolicy, group_duty)


@dataclasses.dataclass
class _JobState:
    job_id: str
    nodes: int
    phase: str = "cold"             # "cold" (profiling) | "warm" (fitted)
    group_id: int = -1
    seq_cursor: int = 0             # last consumed PhaseRecord.seq
    open_cycle: Dict[str, float] = dataclasses.field(default_factory=dict)
    cycles: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    trace: Optional[JobTrace] = None
    # wall-clock bounds of the open cycle (for the per-tenant step-latency
    # fold): first record's start, last record's end
    open_cycle_t0: Optional[float] = None
    last_rec_end: float = 0.0


class PlacementDirector:
    """Live placement + capacity control over a Router's node groups.

    Thread-safe: client threads call :meth:`assign` / :meth:`on_job_step` /
    :meth:`on_job_removed` concurrently; one re-entrant lock serializes
    decisions (the underlying Router/executor operations take their own
    locks). The blocking half of every migration — the admission-hold
    drain — runs OUTSIDE the lock."""

    def __init__(self, router, cfg: Optional[DirectorConfig] = None,
                 initial_groups: Sequence[int] = (), tenancy=None):
        self.router = router
        self.cfg = cfg or DirectorConfig()
        # multi-tenant service layer: a TenantLedger (or None on untenanted
        # planes). Supplies the SLO trigger's inputs — per-tenant rolling
        # step-latency windows (fed back by _fold) and class lookups.
        self.tenancy = tenancy
        # jobs admission-held by the SLO trigger because no placement could
        # absorb them: job_id -> (hold time, guard job whose SLO they broke)
        self._slo_holds: Dict[str, tuple] = {}
        # jobs currently observed in breach (edge-triggered logging)
        self._slo_breached: set = set()
        pcfg = self.cfg.placement or PlacementConfig(horizon=self.cfg.horizon)
        self.policy = PlacementPolicy([], pcfg)
        self.reconciler = Reconciler(self.policy, self.cfg)
        self._lock = threading.RLock()
        self._jobs: Dict[str, _JobState] = {}
        # jobs with a migration currently draining OUTSIDE the lock: no
        # further re-placement decision may target them until the move
        # settles (hold_job/release_job are not refcounted, so a second
        # concurrent migration of the same job would drop the first one's
        # admission hold mid-copy)
        self._migrating: set = set()
        # realized-migration timestamps backing the cooldown hysteresis:
        # repack and pressure-shed may not move a job again until
        # migration_cooldown_s after its last realized move
        self._last_migrated: Dict[str, float] = {}
        # measured migration-cost floors (EWMA of realized costs from
        # Router.migrate_log), keyed by cross_mesh; None = not yet measured
        # (fall back to the configured floors). VirtualClock runs record
        # zero-duration migrations, which are discarded — replay stays
        # bit-identical to the configured-floor decisions.
        self._measured_floor: Dict[bool, Optional[float]] = {
            False: None, True: None}
        self._migrate_cursor = 0
        self.events: List[dict] = []
        self._plan: Optional[ClusterPlan] = None
        self._plan_version = 0
        self._plan_dirty = True
        for g in initial_groups:
            self.register_group(g)

    # Decision-log retention: decisions are per job-lifecycle (not
    # per-step), but a long-lived plane with heavy job churn still accretes
    # — keep the most recent window.
    MAX_EVENTS = 4096

    # ------------------------------------------------------------- helpers
    def _log(self, event: str, **kw):
        self.events.append(dict(event=event, **kw))
        if len(self.events) > self.MAX_EVENTS:
            del self.events[:len(self.events) - self.MAX_EVENTS]

    def job_state(self, job_id: str) -> Optional[_JobState]:
        with self._lock:
            return self._jobs.get(job_id)

    def profiled_trace(self, job_id: str) -> Optional[JobTrace]:
        with self._lock:
            js = self._jobs.get(job_id)
            return js.trace if js else None

    def cluster_plan(self) -> ClusterPlan:
        """The declarative desired state — ``job → (group, shift, trace)``
        plus the group set — re-derived (and re-versioned) whenever a
        decision changed the placement."""
        with self._lock:
            if self._plan is None or self._plan_dirty:
                self._plan_version += 1
                self._plan = plan_from_policy(self.policy,
                                              self._plan_version,
                                              self.router.now())
                self._plan_dirty = False
            return self._plan

    def _cooled(self, now: float) -> frozenset:
        """Jobs inside their migration cooldown: moved less than
        ``migration_cooldown_s`` ago, pinned against repack/shed (the
        hysteresis that keeps pressure relief from ping-ponging one job
        between two groups). Promotions and drift re-fits bypass this —
        when the trace itself changed, correctness beats stability.
        Expired entries are dropped in passing. Call under ``_lock``."""
        cd = self.cfg.migration_cooldown_s
        if cd <= 0.0:
            return frozenset()
        for j in [j for j, t in self._last_migrated.items()
                  if now - t >= cd]:
            del self._last_migrated[j]
        return frozenset(self._last_migrated)

    def _cold_groups(self, exclude_job: Optional[str] = None) -> set:
        return {s.group_id for s in self._jobs.values()
                if s.phase == "cold" and s.job_id != exclude_job}

    def register_group(self, group_id: int):
        """Track an externally created group (e.g. the cluster's seed
        groups) in the placement state."""
        with self._lock:
            if self.policy.group(group_id) is not None:
                return
            now = self.router.now()
            self.policy.add_group(NodeGroup(
                group_id, self.cfg.group_nodes,
                IntervalSet([(now, now + self.cfg.horizon)]),
                horizon_end=now + self.cfg.horizon))
            self._plan_dirty = True

    def _spawn_group(self, now: float, reason: str) -> int:
        known = set(self.router.known_groups()) | \
            {g.group_id for g in self.policy.groups}
        gid = max(known, default=-1) + 1
        self.router.ensure_group(gid)
        self.policy.add_group(NodeGroup(
            gid, self.cfg.group_nodes,
            IntervalSet([(now, now + self.cfg.horizon)]),
            horizon_end=now + self.cfg.horizon))
        self._plan_dirty = True
        self._log("spawn_group", group=gid, reason=reason, t=now)
        return gid

    def _advance(self, now: float):
        """Roll every group's planning window: retire capacity behind
        ``now``, project resident jobs into the extended horizon."""
        for g in self.policy.groups:
            g.advance_to(now)
            g.extend_to(now + self.cfg.horizon)

    # ------------------------------------------------------------- arrival
    def assign(self, job_id: str, nodes: int = 1,
               expected_duration: Optional[float] = None) -> int:
        """Place an arriving (trace-less) job: a dedicated profiling group,
        spawning one if none is free (§4.3.2 cold start). Returns the
        group_id the caller should deploy onto."""
        with self._lock:
            if job_id in self._jobs:
                return self._jobs[job_id].group_id
            now = self.router.now()
            self._advance(now)
            dur = min(expected_duration or self.cfg.cold_reserve_s,
                      self.cfg.horizon * 0.5)
            placed = self.policy.place_cold(job_id, nodes, dur, origin=now)
            if placed is None and len(self.policy.groups) < self.cfg.max_groups:
                self._spawn_group(now, reason=f"cold:{job_id}")
                placed = self.policy.place_cold(job_id, nodes, dur,
                                                origin=now)
            if placed is None:
                # fleet at max size and no clean group: profile on the group
                # with the fewest residents (profiling is noisier, not wrong)
                g = min(self.policy.groups,
                        key=lambda g: (len(g.resident), g.group_id))
                gid = g.group_id
                self._log("cold_overflow", job=job_id, group=gid, t=now)
            else:
                gid = placed.group_id
                self._log("cold_place", job=job_id, group=gid, t=now)
            self._jobs[job_id] = _JobState(job_id, nodes, "cold", gid)
            self._plan_dirty = True
            return gid

    def adopt_warm(self, job_id: str, trace: JobTrace, group_id: int,
                   shift: float = 0.0, nodes: int = 1) -> int:
        """Register an externally profiled WARM job at an exact placement —
        the warm-start handoff path (e.g. re-adopting a checkpointed
        ClusterPlan after a restart): the job skips cold profiling and is
        tracked, drift-checked, and reconciled like any promoted job.
        Returns the group id."""
        with self._lock:
            now = self.router.now()
            self.register_group(group_id)
            self._advance(now)
            # an already-tracked job (e.g. assigned cold) must not leave a
            # ghost reservation behind on its old group
            self.policy.remove(job_id)
            self.policy.place_at(job_id, trace, group_id, shift, origin=now)
            js = self._jobs.get(job_id) or _JobState(job_id, nodes)
            js.nodes, js.phase, js.group_id = nodes, "warm", group_id
            js.trace = trace
            self._jobs[job_id] = js
            self._plan_dirty = True
            self._log("adopt_warm", job=job_id, group=group_id,
                      shift=shift, period=trace.period, t=now)
            return group_id

    # ---------------------------------------------------------- telemetry
    def _fold(self, js: _JobState):
        """Consume the job's new PhaseRecords: carve live completions out of
        group free windows and accumulate per-cycle phase durations."""
        recs = self.router.executor.phase_records_since(js.job_id,
                                                        js.seq_cursor)
        for r in recs:
            js.seq_cursor = max(js.seq_cursor, r.seq)
            g = self.policy.group(r.group_id)
            if g is not None:
                g.note_busy(r.t_started, r.t_finished)
            phase = PHASE_OF_OP.get(r.op)
            if phase is None:
                continue
            if (phase == "rollout" and "rollout" in js.open_cycle
                    and "update_actor" in js.open_cycle):
                self._close_cycle(js)             # next cycle's rollout
            if not js.open_cycle:
                js.open_cycle_t0 = r.t_started
            js.open_cycle[phase] = js.open_cycle.get(phase, 0.0) + r.duration
            js.last_rec_end = r.t_finished
        # a completed step means the open cycle (if whole) is closed
        if "rollout" in js.open_cycle and "update_actor" in js.open_cycle:
            self._close_cycle(js)
        # bounded history for EVERY job: promotion reads the first
        # warmup+cold cycles and drift re-profiling the rolling tail, so
        # nothing needs more than this window — in particular a job stuck
        # cold (its cycles never fold into a usable trace) must not
        # accumulate one dict per step forever
        keep = (self.cfg.warmup_cycles + self.cfg.cold_cycles
                + max(8, self.cfg.drift_window))
        if len(js.cycles) > keep:
            del js.cycles[:len(js.cycles) - keep]

    def _close_cycle(self, js: _JobState):
        """Close the open profiling cycle; its WALL time (first record start
        to last record end — queueing and interference included, which is
        exactly what a tenant experiences) feeds the per-tenant step-latency
        window the SLO trigger reads."""
        js.cycles.append(js.open_cycle)
        js.open_cycle = {}
        if self.tenancy is not None and js.open_cycle_t0 is not None:
            wall = js.last_rec_end - js.open_cycle_t0
            if wall > 0.0:
                self.tenancy.record_step(js.job_id, wall)
        js.open_cycle_t0 = None

    # ----------------------------------------------------------- lifecycle
    def on_job_step(self, job_id: str):
        """Per-step hook (event-driven; deterministic under VirtualClock):
        fold telemetry, promote cold→warm once profiled, run the
        reconciliation triggers (phase drift, periodic occupancy drift,
        queue pressure), adjust capacity.

        Decisions mutate the placement state under the lock; the blocking
        half — the batched migration drain — runs OUTSIDE it, so one job's
        migration never stalls other jobs' step hooks or new-job
        placement."""
        moves: List[JobMove] = []
        with self._lock:
            js = self._jobs.get(job_id)
            if js is None:
                return
            now = self.router.now()
            self._advance(now)
            self._fold(js)
            self._release_slo_holds(now)
            if js.job_id in self._migrating:
                pass          # another thread is mid-move: defer decisions
            elif (js.phase == "cold"
                    and len(js.cycles) >= (self.cfg.warmup_cycles
                                           + self.cfg.cold_cycles)):
                mv = self._promote(js, now)
                if mv is not None:
                    moves.append(mv)
            elif js.phase == "warm":
                mv = self._check_drift(js, now)
                if mv is not None:
                    moves.append(mv)
                mv = self._check_slo(js, now)
                if mv is not None:
                    moves.append(mv)
            moves += self._reconcile(now)
            moves += self._adjust_capacity(now)
            self._migrating.update(m.job_id for m in moves)
        self._realize(moves)

    def _promote(self, js: _JobState, now: float) -> Optional[JobMove]:
        """Cold→warm: build the profiled trace, micro-shift fit it
        (pack-first). Returns the move the caller must realize when the fit
        lands on another group, else None."""
        trace = trace_from_cycles(js.cycles[self.cfg.warmup_cycles:],
                                  js.nodes)
        if trace is None:
            return None
        self.policy.remove(js.job_id)      # release the cold reservation
        placed = self._fit_warm(js.job_id, trace, now)
        js.trace = trace
        js.phase = "warm"
        self._plan_dirty = True
        if placed is None:
            self._log("unplaceable", job=js.job_id, group=js.group_id,
                      period=trace.period, t=now)
            return None
        old_gid = js.group_id
        js.group_id = placed.group_id
        self._log("warm_place", job=js.job_id, group=placed.group_id,
                  shift=placed.shift, period=trace.period,
                  duty=trace.duty(), t=now)
        if placed.group_id != old_gid:
            return JobMove(js.job_id, old_gid, placed.group_id,
                           placed.shift, origin=placed.origin,
                           n_cycles=placed.n_cycles)
        return None

    def _check_drift(self, js: _JobState, now: float) -> Optional[JobMove]:
        """Trigger 2: the rolling cycle tail diverged from the placed trace
        — re-profile, re-fit, and (when the fit moves) migrate."""
        hit = self.reconciler.phase_drift(js.cycles, js.trace, js.nodes)
        if hit is None:
            return None
        recent, ratio = hit
        old = self.policy.placed.get(js.job_id)
        self._log("drift", job=js.job_id, ratio=round(ratio, 4),
                  old_period=js.trace.period, new_period=recent.period,
                  t=now)
        self.policy.remove(js.job_id)
        placed = self._fit_warm(js.job_id, recent, now)
        js.trace = recent
        self._plan_dirty = True
        if placed is None:
            self._log("unplaceable", job=js.job_id, group=js.group_id,
                      period=recent.period, t=now)
            return None
        old_gid = js.group_id
        js.group_id = placed.group_id
        self._log("warm_place", job=js.job_id, group=placed.group_id,
                  shift=placed.shift, period=recent.period,
                  duty=recent.duty(), t=now, reason="drift")
        if placed.group_id != old_gid:
            return JobMove(js.job_id, old_gid, placed.group_id,
                           placed.shift, origin=placed.origin,
                           src_shift=old.shift if old else 0.0,
                           src_origin=old.origin if old else now,
                           n_cycles=placed.n_cycles)
        return None

    def _check_slo(self, js: _JobState, now: float) -> Optional[JobMove]:
        """Trigger 4 (SLO-guarded preemption): the stepping job's tenant is
        GUARANTEED and its rolling p95 step latency breached its SLO —
        preempt the most-interfering BEST_EFFORT job on the group. Shed it
        elsewhere when a placement exists (same hold→drain→migrate
        machinery as queue-pressure shed); otherwise admission-hold it for
        a bounded ``slo_hold_s`` window (work-conserving: delayed, never
        starved). Cooldown pins (``migration_cooldown_s``) apply to victims
        exactly as to repack moves, so preemption cannot ping-pong."""
        if self.tenancy is None:
            return None
        if not self.tenancy.slo_breach(js.job_id):
            if js.job_id in self._slo_breached:
                self._slo_breached.discard(js.job_id)
                self._log("slo_recovered", job=js.job_id, t=now)
            return None
        if js.job_id not in self._slo_breached:
            self._slo_breached.add(js.job_id)
            spec = self.tenancy.spec_of_job(js.job_id)
            self._log("slo_breach", job=js.job_id, group=js.group_id,
                      tenant=spec.tenant_id,
                      p95=self.tenancy.step_p95(spec.tenant_id),
                      slo=spec.slo_step_latency_s, t=now)
        victim = self.reconciler.pick_preempt(
            self.policy.group(js.group_id), self.tenancy.is_best_effort,
            exclude=frozenset(self._migrating) | self._cooled(now)
            | set(self._slo_holds) | {js.job_id})
        if victim is None:
            return None
        cold = self._cold_groups()
        others = [x.group_id for x in self.policy.groups
                  if x.group_id != js.group_id
                  and x.group_id not in cold]
        self.policy.remove(victim.job_id)
        placed = None
        if others:
            placed = self.policy.place_warm(victim.job_id, victim.trace,
                                            origin=now, groups=others,
                                            pack=True)
        if placed is None and len(self.policy.groups) < self.cfg.max_groups:
            spare = self._spawn_group(now, reason=f"slo:{js.job_id}")
            placed = self.policy.place_warm(victim.job_id, victim.trace,
                                            origin=now, groups=[spare])
        if placed is None:
            # nowhere to move it: restore the reservation and HOLD the
            # victim's admissions instead. The hold is bounded (slo_hold_s)
            # and released early if the guard's p95 recovers; the cooldown
            # stamp keeps the next breach from re-targeting it instantly.
            self.policy.place_at(victim.job_id, victim.trace, js.group_id,
                                 victim.shift, origin=victim.origin,
                                 n_cycles=victim.n_cycles)
            self.router.executor.hold_job(victim.job_id)
            self._slo_holds[victim.job_id] = (now, js.job_id)
            self._last_migrated[victim.job_id] = now
            self._log("slo_hold", job=victim.job_id, group=js.group_id,
                      guard=js.job_id, t=now)
            return None
        vjs = self._jobs.get(victim.job_id)
        if vjs is not None:
            vjs.group_id = placed.group_id
        self._plan_dirty = True
        self._log("slo_preempt", job=victim.job_id, src=js.group_id,
                  dst=placed.group_id, guard=js.job_id, t=now)
        return JobMove(victim.job_id, js.group_id, placed.group_id,
                       placed.shift, origin=placed.origin,
                       src_shift=victim.shift, src_origin=victim.origin,
                       n_cycles=placed.n_cycles)

    def _release_slo_holds(self, now: float):
        """Release SLO admission holds whose window elapsed or whose guard
        job's tenant recovered. Event-driven from step hooks (no timer
        thread — deterministic under VirtualClock). Call under ``_lock``."""
        if not self._slo_holds:
            return
        for job_id, (t0, guard) in list(self._slo_holds.items()):
            recovered = (self.tenancy is None
                         or not self.tenancy.slo_breach(guard))
            if recovered or now - t0 >= self.cfg.slo_hold_s:
                del self._slo_holds[job_id]
                self.router.executor.release_job(job_id)
                self._log("slo_release", job=job_id, guard=guard,
                          reason="recovered" if recovered else "timeout",
                          t=now)

    def placement_feasible(self) -> bool:
        """Admission-time feasibility for the tenancy layer: can the
        cluster host one more job WITHOUT unbounded spawning? True while a
        new group may still be spawned (< max_groups) or any existing group
        has duty slack left. Conservative by design — it never spawns or
        reserves anything; the actual placement happens post-admission."""
        with self._lock:
            if len(self.policy.groups) < self.cfg.max_groups:
                return True
            return any(group_duty(g) < g.nodes * 1.0 - 1e-9
                       for g in self.policy.groups)

    def _reconcile(self, now: float, force: bool = False) -> List[JobMove]:
        """Trigger 1: periodic realized-vs-planned occupancy check; on
        drift (or ``force``) plan an incremental repack and apply it."""
        if self._migrating:
            return []     # a move is draining: plan against settled state
        if not any(not p.once for p in self.policy.placed.values()):
            return []
        cold = self._cold_groups()
        eligible = [g.group_id for g in self.policy.groups
                    if g.group_id not in cold]
        if not eligible:
            return []
        mesh_of = (self.router.mesh_domains()
                   if hasattr(self.router, "mesh_domains") else None)
        res = self.reconciler.check(now, self.router.executor, eligible,
                                    force=force,
                                    min_gain=self.migration_floor(False),
                                    cross_min_gain=self.migration_floor(True),
                                    mesh_of=mesh_of,
                                    exclude=self._cooled(now))
        if res is None:
            return []
        plan, drifted = res
        if drifted:
            self._log("occupancy_drift", groups=drifted, t=now)
        if not plan.moves and not plan.reshifts:
            return []
        self.policy.apply_repack(plan)
        self._plan_dirty = True
        for m in plan.moves:
            mjs = self._jobs.get(m.job_id)
            if mjs is not None:
                mjs.group_id = m.dst_group
        self._log("repack",
                  moves=[(m.job_id, m.src_group, m.dst_group,
                          round(m.gain, 6)) for m in plan.moves],
                  reshifts=list(plan.reshifts),
                  skipped=[(m.job_id, m.src_group, m.dst_group,
                            round(m.gain, 6)) for m in plan.skipped],
                  t=now)
        return list(plan.moves)

    def _fit_warm(self, job_id: str, trace: JobTrace,
                  now: float) -> Optional[Placed]:
        n_cycles = max(1, min(self.cfg.max_cycles,
                              int(self.cfg.horizon
                                  // max(trace.period, 1e-9))))
        cold_groups = self._cold_groups(exclude_job=job_id)
        # pack-first: consolidate onto groups already hosting warm jobs so
        # drained profiling groups become retirable (repacking density,
        # §4.3.2) — then the remaining (resident-free) non-profiling
        # groups, then a fresh spawn
        tiers = [
            [g.group_id for g in self.policy.groups
             if g.resident and g.group_id not in cold_groups],
            [g.group_id for g in self.policy.groups
             if not g.resident and g.group_id not in cold_groups],
        ]
        for tier in tiers:
            if not tier:
                continue
            placed = self.policy.place_warm(job_id, trace,
                                            n_cycles=n_cycles,
                                            origin=now, groups=tier)
            if placed is not None:
                return placed
        if len(self.policy.groups) < self.cfg.max_groups:
            gid = self._spawn_group(now, reason=f"warm:{job_id}")
            return self.policy.place_warm(job_id, trace, n_cycles=n_cycles,
                                          origin=now, groups=[gid])
        return None

    def on_job_removed(self, job_id: str):
        with self._lock:
            js = self._jobs.pop(job_id, None)
            self._last_migrated.pop(job_id, None)
            self._slo_breached.discard(job_id)
            # a held victim leaving keeps no dangling hold; holds guarded
            # by the departing job lose their reason and release at once
            if self._slo_holds.pop(job_id, None) is not None:
                self.router.executor.release_job(job_id)
            for held, (_, guard) in list(self._slo_holds.items()):
                if guard == job_id:
                    del self._slo_holds[held]
                    self.router.executor.release_job(held)
            self.policy.remove(job_id)
            self.router.executor.drop_job_telemetry(job_id)
            self._plan_dirty = True
            now = self.router.now()
            if js is not None:
                self._log("job_removed", job=job_id, t=now)
            self._retire_idle(now)

    # -------------------------------------------- measured migration floor
    def migration_floor(self, cross_mesh: bool = False) -> float:
        """The migration-cost floor the planner should charge a move:
        the MEASURED realized cost (EWMA over Router.migrate_log) once any
        migration of that kind has run, else the configured floor
        (``cross_mesh_floor_s`` falls back to the same-mesh measurement,
        then to ``migration_floor_s``)."""
        m = self._measured_floor[cross_mesh]
        if m is not None:
            return m
        if cross_mesh:
            if self.cfg.cross_mesh_floor_s is not None:
                return self.cfg.cross_mesh_floor_s
            if self._measured_floor[False] is not None:
                return self._measured_floor[False]
        return self.cfg.migration_floor_s

    def _ingest_migration_costs(self):
        """Fold newly realized migrations (reshard time included) into the
        per-kind floor EWMAs. Zero-duration records (VirtualClock replays,
        where transfers take no virtual time) are discarded so replayed
        decision sequences stay bit-identical. Call under ``_lock``."""
        log = getattr(self.router, "migrate_log", None)
        if log is None:
            return
        new = log[self._migrate_cursor:]
        self._migrate_cursor = len(log)
        for ev in new:
            dt = ev.get("seconds", 0.0)
            if dt <= 0.0:
                continue
            kind = bool(ev.get("cross_mesh"))
            old = self._measured_floor[kind]
            self._measured_floor[kind] = (dt if old is None
                                          else 0.7 * old + 0.3 * dt)

    # ---------------------------------------------------------- realization
    def _realize(self, moves: List[JobMove]):
        """Realize a batch of decided moves through the router (batched
        hold→drain→migrate→rehome, dependency-ordered). The placement
        state already reflects the decisions; a failed move is rolled back
        — re-fitted onto its source group — leaving the plan partially
        realized but consistent."""
        if not moves:
            return
        try:
            # several triggers may have re-placed the same job in one tick;
            # the policy holds only the LAST decision, so merge into
            # first.src -> last.dst and drop no-ops
            merged: Dict[str, JobMove] = {}
            for m in moves:
                prev = merged.get(m.job_id)
                if prev is None:
                    merged[m.job_id] = m
                else:
                    merged[m.job_id] = dataclasses.replace(
                        m, src_group=prev.src_group,
                        src_shift=prev.src_shift,
                        src_origin=prev.src_origin)
            todo = [m for m in merged.values()
                    if m.src_group != m.dst_group]
            if not todo:
                return
            results = self.router.reassign_jobs(todo)
            with self._lock:
                now = self.router.now()
                # calibrate the migration floors from the realized
                # (reshard-included) costs these moves just measured
                self._ingest_migration_costs()
                for m, moved, err in results:
                    if err is None:
                        self._last_migrated[m.job_id] = now
                        self._log("migrate", job=m.job_id, src=m.src_group,
                                  dst=m.dst_group, bytes=moved, t=now)
                        continue
                    # e.g. a quiesce timeout behind a long-running op: the
                    # job still runs on src. Re-fit it there (freeing the
                    # dst reservation) and keep driving it — a failed
                    # repack move must never kill a healthy job.
                    js = self._jobs.get(m.job_id)
                    self.policy.remove(m.job_id)
                    if (js is not None and js.trace is not None
                            and self.policy.group(m.src_group) is not None):
                        p = self.policy.place_warm(m.job_id, js.trace,
                                                   origin=now,
                                                   groups=[m.src_group])
                        if p is None:
                            self.policy.place_at(m.job_id, js.trace,
                                                 m.src_group, m.src_shift,
                                                 origin=now)
                        js.group_id = m.src_group
                    self._plan_dirty = True
                    self._log("migrate_failed", job=m.job_id,
                              src=m.src_group, dst=m.dst_group,
                              error=str(err), t=now)
                self._retire_idle(now)  # consolidation may drain groups
        finally:
            with self._lock:
                self._migrating.difference_update(
                    m.job_id for m in moves)

    # ------------------------------------------------- capacity adjustment
    def poll(self):
        """Explicit capacity-adjustment tick (the event hooks call this
        implicitly; exposed for external control loops)."""
        with self._lock:
            now = self.router.now()
            self._advance(now)
            moves = self._adjust_capacity(now)
            self._migrating.update(m.job_id for m in moves)
        self._realize(moves)

    def reconcile_now(self, force: bool = True) -> List[JobMove]:
        """Run the periodic reconcile pass immediately; ``force`` skips the
        cadence gate and plans a repack even without measured drift.
        Returns the moves that were decided (already realized)."""
        with self._lock:
            now = self.router.now()
            self._advance(now)
            moves = self._reconcile(now, force=force)
            self._migrating.update(m.job_id for m in moves)
        self._realize(moves)
        return moves

    def _adjust_capacity(self, now: float) -> List[JobMove]:
        """Trigger 3 + §4.4 capacity adjustment: a deep-queued group sheds
        its worst-interfering warm job onto another group; when nothing is
        sheddable a spare group is kept available; with no pressure, idle
        groups retire.

        Process plane: a dead group worker process is respawned first (the
        capacity adjuster IS the plane's supervisor — a crashed group is a
        capacity loss exactly like a failed node). Thread mode returns no
        dead groups, so replay determinism is untouched."""
        respawn = getattr(self.router, "respawn_dead_groups", None)
        if respawn is not None:
            for gid in respawn():
                self._log("respawn_group", group=gid, t=now)
        telem = self.router.group_telemetry()
        deep = sorted(g for g, t in telem.items()
                      if t["queue_depth"] >= self.cfg.spawn_queue_depth)
        if not deep:
            self._retire_idle(now, telem)
            return []
        moves: List[JobMove] = []
        for gid in deep:
            # a job shed earlier in THIS pass is pinned for the rest of it:
            # without this, a second deep group could immediately shed the
            # newcomer back before the move is even realized
            mv = self._shed(now, gid, telem,
                            moved=frozenset(m.job_id for m in moves))
            if mv is not None:
                moves.append(mv)
        if not moves and len(self.policy.groups) < self.cfg.max_groups:
            # nothing sheddable: keep (or create) one spare group so the
            # next warm fit / repack can expand onto it
            spare = [g for g in self.policy.groups
                     if not g.resident and not telem.get(
                         g.group_id, {}).get("deployments")]
            if not spare:
                self._spawn_group(now, reason=f"queue_depth:g{deep[0]}")
        return moves

    def _shed(self, now: float, gid: int, telem: Dict,
              moved: frozenset = frozenset()) -> Optional[JobMove]:
        """Move the worst-interfering warm resident OFF a deep-queued group
        (spawning a spare when nothing else fits)."""
        victim = self.reconciler.pick_shed(
            self.policy.group(gid),
            exclude=frozenset(self._migrating) | self._cooled(now) | moved)
        if victim is None:
            return None
        cold = self._cold_groups()
        others = [x.group_id for x in self.policy.groups
                  if x.group_id != gid and x.group_id not in cold]
        self.policy.remove(victim.job_id)
        placed = None
        if others:
            placed = self.policy.place_warm(victim.job_id, victim.trace,
                                            origin=now, groups=others,
                                            pack=True)
        if placed is None and len(self.policy.groups) < self.cfg.max_groups:
            spare = self._spawn_group(now, reason=f"shed:g{gid}")
            placed = self.policy.place_warm(victim.job_id, victim.trace,
                                            origin=now, groups=[spare])
        if placed is None:
            self.policy.place_at(victim.job_id, victim.trace, gid,
                                 victim.shift, origin=victim.origin,
                                 n_cycles=victim.n_cycles)
            return None
        js = self._jobs.get(victim.job_id)
        if js is not None:
            js.group_id = placed.group_id
        self._plan_dirty = True
        self._log("shed", job=victim.job_id, src=gid, dst=placed.group_id,
                  queue_depth=telem[gid]["queue_depth"], t=now)
        return JobMove(victim.job_id, gid, placed.group_id, placed.shift,
                       origin=placed.origin, src_shift=victim.shift,
                       src_origin=victim.origin, n_cycles=placed.n_cycles)

    def _retire_idle(self, now: float, telem: Optional[Dict] = None):
        """Retire groups with no placed jobs, no deployments, and no queued
        or running work (down to ``min_groups``)."""
        if telem is None:
            telem = self.router.group_telemetry()
        for gid in sorted((g.group_id for g in self.policy.groups),
                          reverse=True):
            if len(self.policy.groups) <= self.cfg.min_groups:
                break
            g = self.policy.group(gid)
            if g is None or g.resident:
                continue
            t = telem.get(gid)
            if t and (t["deployments"] or t["queue_depth"] or t["running"]):
                continue
            try:
                self.router.retire_group(gid)
            except RuntimeError:
                continue               # raced an attach: leave it alone
            self.policy.remove_group(gid)
            self._plan_dirty = True
            self._log("retire_group", group=gid, t=now)
