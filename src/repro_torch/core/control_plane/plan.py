"""The declarative half of the control plane: profiled traces and the
:class:`ClusterPlan`.

A ``ClusterPlan`` is the desired state the director maintains — the
``job → (group, shift, trace)`` assignment plus the group set — extracted
from :class:`~repro_torch.core.scheduler.placement.PlacementPolicy`'s live fitting
state. The realized schedule (what the executor actually ran) is
continuously compared against it by the reconciler
(:mod:`repro_torch.core.control_plane.reconcile`); divergence triggers
re-profiling, repacking, and live migration rather than a one-shot
placement decision.

Also here: the per-op → phase mapping and the fold that turns the
executor's :class:`~repro_torch.core.scheduler.executor.PhaseRecord` stream into
the same :class:`~repro_torch.core.scheduler.placement.JobTrace` the simulator
consumes, and :class:`DirectorConfig` — the knobs for the whole
profile → fit → reconcile loop.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.scheduler.placement import (  # noqa: F401 (re-exported)
    JobMove, JobTrace, PlacementConfig, PlacementPolicy, RepackPlan)

# Executor op value -> profiled phase (paper Table 2 cycle anatomy).
PHASE_OF_OP = {
    "generate": "rollout",
    "forward": "compute_log_prob",
    "update_actor": "update_actor",
    "forward_backward": "update_actor",
    "optim_step": "update_actor",
    "sync_weights": "sync_weight",
}
TRAIN_PHASES = ("compute_log_prob", "update_actor", "sync_weight")


@dataclasses.dataclass(frozen=True)
class DirectorConfig:
    horizon: float = 600.0          # rolling planning window (seconds)
    max_cycles: int = 64            # cap on pre-allocated warm cycles
    cold_cycles: int = 1            # clean cycles before the warm re-fit
    warmup_cycles: int = 1          # leading cycles DROPPED from the fold
    #   (the first cycle carries JIT compilation / cache warming and would
    #   poison the steady-state trace; set 0 for exact-replay tests)
    cold_reserve_s: float = 60.0    # dedicated-group reservation length
    group_nodes: int = 1            # node count of spawned groups
    min_groups: int = 1
    max_groups: int = 32
    spawn_queue_depth: int = 8      # per-group QUEUED depth triggering
    #   pressure relief (shed onto another group, else keep a spare)
    placement: Optional[PlacementConfig] = None
    # ---- reconciliation loop (§4.3.2's repack-when-diverged) -------------
    repack_interval_s: float = 60.0   # cadence of the occupancy-drift check
    plan_overlap_min: float = 0.5     # realized busy must overlap planned
    #   windows at least this fraction, else the group counts as drifted
    min_drift_busy_s: float = 1.0     # ignore groups with less measured busy
    drift_ratio: float = 1.5          # per-job period divergence (either
    #   direction) between the rolling cycle tail and the placed trace that
    #   triggers a re-profile + re-fit
    drift_window: int = 4             # trailing cycles the tail compares
    migration_floor_s: float = 0.001  # predicted-gain floor under which a
    #   repack move is skipped (fed from the measured
    #   placement/repack_migrate_s benchmark: ~1 ms per realized migration)
    cross_mesh_floor_s: Optional[float] = None  # floor for moves that cross
    #   mesh-slice domains (the reshard-included cost); None = start at
    #   migration_floor_s until the director has measured real cross-mesh
    #   migrations from Router.migrate_log
    # ---- incremental repack planning + stability --------------------------
    incremental_repack: bool = True   # reconcile passes plan deltas with the
    #   RepackIndex (dirty groups only, copy-on-write overlay); False falls
    #   back to the full plan_repack oracle on every pass
    repack_dest_search: int = 12      # cap on exact micro-shift searches per
    #   re-fitted job — the most-promising destinations by duty-overlap
    #   bound; 0 = search every non-pruned group (the oracle's behavior)
    migration_cooldown_s: float = 30.0  # hysteresis: a job migrated at t is
    #   pinned against further repack/shed moves until t + cooldown, so
    #   pressure relief cannot ping-pong it between two groups; promotions
    #   and drift re-fits bypass the cooldown (correctness beats stability
    #   when the trace itself changed). 0 disables.
    interference_ewma: float = 0.2    # weight folding realized-vs-planned
    #   busy overlap into each group's interference_scale (a group whose
    #   execution keeps landing outside the plan scores pessimistically in
    #   phase_interference until reality re-converges); 0 disables
    # ---- SLO-guarded preemption (multi-tenant service layer) --------------
    slo_window: int = 16              # rolling step-latency window per tenant
    #   (walls folded from the PhaseRecord stream; p95 is nearest-rank over
    #   this window)
    slo_min_samples: int = 4          # walls required before the p95 is
    #   meaningful — the SLO trigger never fires off one noisy sample
    slo_hold_s: float = 10.0          # when a breaching group has nowhere to
    #   shed the BEST_EFFORT victim, it is admission-held for this long
    #   (bounded, so best-effort work stays work-conserving, never starved);
    #   released early if the guaranteed tenant's p95 recovers


def trace_from_cycles(cycles: Sequence[Dict[str, float]],
                      nodes: int = 1) -> Optional[JobTrace]:
    """Fold per-cycle phase durations into a JobTrace (mean per phase, the
    same anatomy as ``traces.Profiler.trace``: training segments
    back-to-back after the rollout gap)."""
    mean: Dict[str, float] = {}
    for phase in ("rollout",) + TRAIN_PHASES:
        vals = [c[phase] for c in cycles if phase in c]
        if vals:
            mean[phase] = sum(vals) / len(vals)
    if "rollout" not in mean or "update_actor" not in mean:
        return None
    t = mean["rollout"]
    segs = []
    for p in TRAIN_PHASES:
        if p in mean:
            segs.append((t, mean[p]))
            t += mean[p]
    if t <= 1e-9:
        return None                 # degenerate (clock never advanced)
    return JobTrace(period=t, segments=tuple(segs), nodes=nodes)


@dataclasses.dataclass(frozen=True)
class JobAssignment:
    """One job's desired placement: where its profiled trace is anchored."""
    job_id: str
    group_id: int
    shift: float
    origin: float
    trace: JobTrace
    once: bool = False              # one-shot cold-profiling reservation


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """Declarative desired state: the group set plus every job's
    assignment, versioned per placement change. Purely derived — the
    fitting source of truth stays in ``PlacementPolicy``; this is the
    stable snapshot operators, tests, and the reconciler diff against."""
    version: int
    t: float                        # time the snapshot was taken
    groups: Tuple[int, ...]
    assignments: Tuple[JobAssignment, ...]

    def assignment(self, job_id: str) -> Optional[JobAssignment]:
        for a in self.assignments:
            if a.job_id == job_id:
                return a
        return None

    def diff(self, other: "ClusterPlan") -> Dict[str, Tuple]:
        """Jobs whose (group, shift, origin) changed between two plans:
        ``job_id -> ((old group, shift) | None, (new group, shift) | None)``."""
        mine = {a.job_id: a for a in self.assignments}
        theirs = {a.job_id: a for a in other.assignments}
        out: Dict[str, Tuple] = {}
        for job_id in sorted(set(mine) | set(theirs)):
            a, b = mine.get(job_id), theirs.get(job_id)
            ka = (a.group_id, a.shift, a.origin) if a else None
            kb = (b.group_id, b.shift, b.origin) if b else None
            if ka != kb:
                out[job_id] = (ka, kb)
        return out


def plan_from_policy(policy: PlacementPolicy, version: int,
                     t: float) -> ClusterPlan:
    """Snapshot the live fitting state into a declarative ClusterPlan."""
    assigns = tuple(sorted(
        (JobAssignment(p.job_id, p.group_id, p.shift, p.origin, p.trace,
                       once=p.once)
         for p in policy.placed.values()),
        key=lambda a: a.job_id))
    groups = tuple(sorted(g.group_id for g in policy.groups))
    return ClusterPlan(version=version, t=t, groups=groups,
                       assignments=assigns)
