"""Tenant model for the multi-tenant service layer (paper §2; MARLaaS).

PlexRL multiplexes one serviceized LLM plane across jobs from *different
users* — the whole premise is that idle gaps are anti-correlated across
tenants. This module is the policy vocabulary that makes that sharing safe:
who a tenant is (``TenantSpec``), what they are entitled to (quotas), how
urgently their work ages in HRRS admission (``priority``), and what the
plane owes them (``slo_step_latency_s``, enforced for GUARANTEED tenants by
the director's SLO preemption trigger).

Every pre-tenancy call site maps onto the implicit ``DEFAULT_TENANT``:
priority 1.0, BEST_EFFORT, unlimited quotas, no SLO — so the default tenant
is bit-identical to the untenanted plane (1.0 is the multiplicative
identity on the HRRS score line, and unlimited quotas never queue or deny).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional


DEFAULT_TENANT = "default"


class TenantClass(str, enum.Enum):
    """Service class (RL-in-the-Wild's production/experiment split).

    GUARANTEED tenants carry an SLO the director actively defends by
    preempting BEST_EFFORT work; BEST_EFFORT tenants absorb the slack and
    may be held/shed whenever a GUARANTEED SLO is breached.
    """

    GUARANTEED = "guaranteed"
    BEST_EFFORT = "best_effort"


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Declarative per-tenant policy.

    quota_groups     max concurrently admitted jobs (each job reserves one
                     node-group placement); None = unlimited.
    quota_gpu_s      lifetime budget of billed gpu-seconds (busy + switch);
                     admission-time check, None = unlimited.
    slo_step_latency_s
                     rolling-p95 step-latency objective; only enforced for
                     GUARANTEED tenants (the director's fourth reconcile
                     trigger). None = no SLO.
    """

    tenant_id: str
    priority: float = 1.0
    class_: TenantClass = TenantClass.BEST_EFFORT
    quota_groups: Optional[int] = None
    quota_gpu_s: Optional[float] = None
    slo_step_latency_s: Optional[float] = None

    def __post_init__(self):
        if not self.tenant_id:
            raise ValueError("tenant_id must be non-empty")
        if not (self.priority > 0.0):
            raise ValueError(
                f"priority must be > 0 (got {self.priority}); the HRRS "
                "score line needs a positive slope for starvation-freedom")
        if self.quota_groups is not None and self.quota_groups < 0:
            raise ValueError("quota_groups must be >= 0")
        if self.quota_gpu_s is not None and self.quota_gpu_s < 0:
            raise ValueError("quota_gpu_s must be >= 0")


def default_spec() -> TenantSpec:
    return TenantSpec(tenant_id=DEFAULT_TENANT, priority=1.0,
                      class_=TenantClass.BEST_EFFORT)


class TenantRegistry:
    """Registry of known tenants. Auto-creates only the default tenant;
    any other tenant must be registered before its jobs are admitted
    (unknown tenants are an admission *denial*, not a KeyError — the
    service layer's contract is typed outcomes).

    Re-registering an existing tenant replaces its spec — this is how an
    operator tightens a live tenant's SLO or priority (the director picks
    up the new spec on its next fold).
    """

    def __init__(self):
        self._specs: Dict[str, TenantSpec] = {
            DEFAULT_TENANT: default_spec()}

    def register(self, spec: TenantSpec) -> TenantSpec:
        self._specs[spec.tenant_id] = spec
        return spec

    def get(self, tenant_id: str) -> Optional[TenantSpec]:
        return self._specs.get(tenant_id)

    def known(self, tenant_id: str) -> bool:
        return tenant_id in self._specs

    def all(self) -> Dict[str, TenantSpec]:
        return dict(self._specs)
