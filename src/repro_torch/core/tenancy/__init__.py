"""core.tenancy — multi-tenant service layer: tenant registry, quotas,
priority-weighted admission, SLO enforcement inputs, per-tenant accounting.

Mechanism lives in the scheduler / placement / control planes; this package
is the *policy* layer threaded through them (MARLaaS's framing: RL as a
multi-tenant service where the missing piece is policy, not mechanism).
"""
from repro_torch.core.tenancy.accounting import TenantLedger, p95
from repro_torch.core.tenancy.admission import (REASON_GPU_QUOTA,
                                          REASON_GROUP_QUOTA,
                                          REASON_NO_PLACEMENT,
                                          REASON_UNKNOWN_TENANT,
                                          AdmissionController,
                                          AdmissionDenied, PendingJob)
from repro_torch.core.tenancy.model import (DEFAULT_TENANT, TenantClass,
                                      TenantRegistry, TenantSpec,
                                      default_spec)

__all__ = [
    "DEFAULT_TENANT",
    "TenantClass",
    "TenantRegistry",
    "TenantSpec",
    "default_spec",
    "TenantLedger",
    "p95",
    "AdmissionController",
    "AdmissionDenied",
    "PendingJob",
    "REASON_GROUP_QUOTA",
    "REASON_GPU_QUOTA",
    "REASON_NO_PLACEMENT",
    "REASON_UNKNOWN_TENANT",
]
