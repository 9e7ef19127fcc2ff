"""Quota-aware admission control for the multi-tenant service layer.

``Cluster.add_job`` routes every submission through here before anything is
placed or spawned. Denials are *typed outcomes*, not stack traces: an
``AdmissionDenied`` carries the tenant, job, and machine-readable reason so
a service frontend can surface "your org is at quota" versus "the cluster
is full" distinctly. A denied job can instead be parked in its tenant's
pending queue (``queue_on_deny``); quota release on ``remove_job`` drains
the queues in priority order so freed capacity flows to the most-entitled
waiting tenant first.

Feasibility is checked against the placement plane's *duty slack* (can any
existing group absorb another duty share, or may a new group still be
spawned under ``max_groups``) rather than by optimistically spawning — the
unbounded-spawn hole this subsystem exists to close.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Set

from repro_torch.core.tenancy.accounting import TenantLedger
from repro_torch.core.tenancy.model import TenantRegistry

# Machine-readable denial reasons (the full closed set).
REASON_UNKNOWN_TENANT = "unknown-tenant"
REASON_GROUP_QUOTA = "group-quota"
REASON_GPU_QUOTA = "gpu-quota"
REASON_NO_PLACEMENT = "no-feasible-placement"


class AdmissionDenied(Exception):
    """Typed admission denial: tenant + job + one of the REASON_* codes."""

    def __init__(self, tenant_id: str, job_id: str, reason: str):
        self.tenant_id = tenant_id
        self.job_id = job_id
        self.reason = reason
        super().__init__(
            f"admission denied for job {job_id!r} "
            f"(tenant {tenant_id!r}): {reason}")


@dataclasses.dataclass
class PendingJob:
    """A submission parked at quota, replayed verbatim on drain."""
    cfg: object                  # controller.JobConfig
    group_id: Optional[int]
    algo: str
    enqueued_t: float


class AdmissionController:
    """Per-tenant quota bookkeeping + pending queues.

    Tracks which jobs are *active* per tenant (admitted, not yet removed);
    each active job counts one group reservation against
    ``quota_groups``. ``quota_gpu_s`` is an admission-time gate on the
    tenant's lifetime billed gpu-seconds (ledger cursor) — already-running
    jobs are never killed for it, matching billing semantics elsewhere.
    """

    def __init__(self, registry: TenantRegistry, ledger: TenantLedger):
        self.registry = registry
        self.ledger = ledger
        self._lock = threading.Lock()
        self._active: Dict[str, Set[str]] = {}
        self._pending: Dict[str, Deque[PendingJob]] = {}

    # ------------------------------------------------------------- queries
    def active_count(self, tenant_id: str) -> int:
        with self._lock:
            return len(self._active.get(tenant_id, ()))

    def pending_depth(self, tenant_id: str) -> int:
        with self._lock:
            return len(self._pending.get(tenant_id, ()))

    def check(self, tenant_id: str, job_id: str,
              feasible: bool) -> Optional[str]:
        """Denial reason for admitting ``job_id`` now, or None if clear.
        ``feasible`` is the placement plane's duty-slack verdict."""
        spec = self.registry.get(tenant_id)
        if spec is None:
            return REASON_UNKNOWN_TENANT
        with self._lock:
            active = len(self._active.get(tenant_id, ()))
        if spec.quota_groups is not None and active >= spec.quota_groups:
            return REASON_GROUP_QUOTA
        if (spec.quota_gpu_s is not None
                and self.ledger.gpu_seconds(tenant_id) >= spec.quota_gpu_s):
            return REASON_GPU_QUOTA
        if not feasible:
            return REASON_NO_PLACEMENT
        return None

    # ----------------------------------------------------------- mutation
    def admit(self, tenant_id: str, job_id: str):
        with self._lock:
            self._active.setdefault(tenant_id, set()).add(job_id)

    def release(self, job_id: str) -> Optional[str]:
        """Drop the job's quota reservation; returns its tenant (or None
        if the job was never admitted through this controller)."""
        with self._lock:
            for tenant_id, jobs in self._active.items():
                if job_id in jobs:
                    jobs.discard(job_id)
                    return tenant_id
        return None

    def enqueue(self, tenant_id: str, pending: PendingJob):
        with self._lock:
            self._pending.setdefault(tenant_id, deque()).append(pending)
        self.ledger.set_pending(tenant_id, self.pending_depth(tenant_id))

    def drain(self, feasible: Callable[[], bool]) -> List[PendingJob]:
        """Pop every pending job that can be admitted *now*.

        Tenants are visited in priority-desc (then tenant_id) order so
        freed capacity flows to the most-entitled queue first; within a
        tenant the queue is FIFO and draining stops at the first job that
        still fails its check (quota or feasibility) — admission order
        within a tenant is preserved, no queue-jumping.
        The caller launches the returned jobs and must ``admit`` each
        (this method reserves quota itself to keep check+admit atomic).
        """
        ready: List[PendingJob] = []
        with self._lock:
            tenants = sorted(
                (t for t, q in self._pending.items() if q),
                key=lambda t: (-(self.registry.get(t).priority
                                 if self.registry.get(t) else 0.0), t))
        for tenant_id in tenants:
            while True:
                with self._lock:
                    q = self._pending.get(tenant_id)
                    if not q:
                        break
                    head = q[0]
                reason = self.check(tenant_id, head.cfg.job_id, feasible())
                if reason is not None:
                    break
                with self._lock:
                    q.popleft()
                    self._active.setdefault(tenant_id, set()).add(
                        head.cfg.job_id)
                ready.append(head)
            self.ledger.set_pending(tenant_id,
                                    self.pending_depth(tenant_id))
        return ready
