"""Per-tenant accounting: gpu-seconds, step latency, SLO attainment.

The billing plane already meters per-group busy/switch seconds from the
executor's logs; this module folds those cursors up to the *tenant* — the
unit that is actually quota'd and billed in a multi-tenant service. It also
owns the rolling step-latency window the director's SLO trigger reads:
step walls are folded from the existing ``PhaseRecord`` stream (one wall =
one closed train cycle), appended here per tenant, and summarised as a
rolling p95.

Thread-safety: the executor's completion path, the cluster's billing sweep,
and the director's fold all touch the ledger from different threads, so
every mutator takes the internal lock. All methods are O(window) or better —
this sits on the dispatch hot path's shoulder, not in it.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Deque, Dict, Optional

from repro_torch.core.tenancy.model import (DEFAULT_TENANT, TenantClass,
                                      TenantRegistry, TenantSpec)


def p95(samples) -> Optional[float]:
    """Nearest-rank p95 (deterministic, no interpolation)."""
    xs = sorted(samples)
    if not xs:
        return None
    rank = max(0, math.ceil(0.95 * len(xs)) - 1)
    return xs[rank]


class TenantLedger:
    """Mutable per-tenant runtime state: job bindings, billed gpu-seconds,
    step-latency windows, SLO attainment counters, pending-queue depth.

    The registry is consulted live (not snapshotted) so a re-registered
    spec — e.g. an operator tightening an SLO mid-serve — takes effect on
    the next read.
    """

    def __init__(self, registry: TenantRegistry, slo_window: int = 16,
                 slo_min_samples: int = 4):
        self.registry = registry
        self.slo_window = max(1, slo_window)
        self.slo_min_samples = max(1, slo_min_samples)
        self._lock = threading.Lock()
        self._job_tenant: Dict[str, str] = {}
        self._gpu_seconds: Dict[str, float] = {}
        self._steps: Dict[str, Deque[float]] = {}
        self._steps_total: Dict[str, int] = {}
        self._steps_ok: Dict[str, int] = {}
        self._pending: Dict[str, int] = {}

    # ------------------------------------------------------------ bindings
    def bind_job(self, job_id: str, tenant_id: str):
        with self._lock:
            self._job_tenant[job_id] = tenant_id

    def unbind_job(self, job_id: str):
        with self._lock:
            self._job_tenant.pop(job_id, None)

    def tenant_of(self, job_id: str) -> str:
        with self._lock:
            return self._job_tenant.get(job_id, DEFAULT_TENANT)

    def spec_of_job(self, job_id: str) -> TenantSpec:
        spec = self.registry.get(self.tenant_of(job_id))
        if spec is None:                       # tenant deregistered mid-run
            spec = self.registry.get(DEFAULT_TENANT)
        return spec

    def is_best_effort(self, job_id: str) -> bool:
        return self.spec_of_job(job_id).class_ == TenantClass.BEST_EFFORT

    # ------------------------------------------------------------- billing
    def add_gpu_seconds(self, tenant_id: str, seconds: float):
        if seconds <= 0.0:
            return
        with self._lock:
            self._gpu_seconds[tenant_id] = (
                self._gpu_seconds.get(tenant_id, 0.0) + seconds)

    def gpu_seconds(self, tenant_id: str) -> float:
        with self._lock:
            return self._gpu_seconds.get(tenant_id, 0.0)

    # --------------------------------------------------------- step window
    def record_step(self, job_id: str, wall_s: float):
        """Fold one closed train-cycle wall into the job's tenant window
        and update SLO attainment against the tenant's current spec."""
        tenant_id = self.tenant_of(job_id)
        spec = self.registry.get(tenant_id)
        with self._lock:
            win = self._steps.get(tenant_id)
            if win is None:
                win = self._steps[tenant_id] = deque(maxlen=self.slo_window)
            win.append(wall_s)
            self._steps_total[tenant_id] = \
                self._steps_total.get(tenant_id, 0) + 1
            slo = spec.slo_step_latency_s if spec is not None else None
            if slo is None or wall_s <= slo:
                self._steps_ok[tenant_id] = \
                    self._steps_ok.get(tenant_id, 0) + 1

    def step_p95(self, tenant_id: str) -> Optional[float]:
        """Rolling p95 step latency; None until ``slo_min_samples`` walls
        have been folded (no trigger-happy preemption off one sample)."""
        with self._lock:
            win = self._steps.get(tenant_id)
            if win is None or len(win) < self.slo_min_samples:
                return None
            return p95(win)

    def slo_breach(self, job_id: str) -> bool:
        """True when the job's tenant is GUARANTEED, has an SLO, and its
        rolling p95 step latency exceeds it."""
        spec = self.spec_of_job(job_id)
        if (spec.class_ != TenantClass.GUARANTEED
                or spec.slo_step_latency_s is None):
            return False
        p = self.step_p95(spec.tenant_id)
        return p is not None and p > spec.slo_step_latency_s

    # ------------------------------------------------------------- pending
    def set_pending(self, tenant_id: str, depth: int):
        with self._lock:
            if depth <= 0:
                self._pending.pop(tenant_id, None)
            else:
                self._pending[tenant_id] = depth

    # ------------------------------------------------------------ snapshot
    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Per-tenant accounting view merged into Router.tenant_telemetry."""
        with self._lock:
            tenants = (set(self._gpu_seconds) | set(self._steps)
                       | set(self._steps_total) | set(self._pending)
                       | set(self._job_tenant.values()))
            out: Dict[str, Dict[str, object]] = {}
            for t in tenants:
                total = self._steps_total.get(t, 0)
                ok = self._steps_ok.get(t, 0)
                win = self._steps.get(t)
                out[t] = {
                    "gpu_seconds": self._gpu_seconds.get(t, 0.0),
                    "steps_total": total,
                    "slo_attainment": (ok / total) if total else None,
                    "step_p95_s": (p95(win) if win and
                                   len(win) >= self.slo_min_samples
                                   else None),
                    "pending_jobs": self._pending.get(t, 0),
                }
            return out
