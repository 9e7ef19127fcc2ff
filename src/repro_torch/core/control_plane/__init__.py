"""Control plane package: declarative plan, reconciliation loop, director.

Split across three modules (one per layer of the loop):

- :mod:`~repro_torch.core.control_plane.plan` — the declarative state: profiled
  trace folding, :class:`DirectorConfig`, and the versioned
  :class:`ClusterPlan` (job → (group, shift, trace) + group set).
- :mod:`~repro_torch.core.control_plane.reconcile` — drift detection: periodic
  realized-vs-planned occupancy overlap, per-job phase drift, and
  queue-pressure shed selection.
- :mod:`~repro_torch.core.control_plane.director` — the
  :class:`PlacementDirector` that decides (cold place / warm fit /
  repack), applies to the placement state, and realizes batched migrations
  through ``Router.reassign_jobs``.

This package keeps the old ``repro_torch.core.control_plane`` import surface.
"""
from repro_torch.core.control_plane.director import (PlacementDirector, _JobState)
from repro_torch.core.control_plane.plan import (PHASE_OF_OP, TRAIN_PHASES,
                                           ClusterPlan, DirectorConfig,
                                           JobAssignment, plan_from_policy,
                                           trace_from_cycles)
from repro_torch.core.control_plane.reconcile import Reconciler
from repro_torch.core.scheduler.placement import JobMove, RepackPlan

__all__ = [
    "PHASE_OF_OP", "TRAIN_PHASES", "ClusterPlan", "DirectorConfig",
    "JobAssignment", "JobMove", "PlacementDirector", "Reconciler",
    "RepackPlan", "plan_from_policy", "trace_from_cycles", "_JobState",
]
