"""serving/frontdoor/ — the tenant dimension ahead of the serving engine
(counterpart of ``deepspeed_tpu/serving/frontdoor``).

``tenants.py``: token-bucket admission rates, weighted-fair queueing
ahead of the priority tiers, SLO classes mapped onto scheduler
priorities, paged-KV page / pinned-prefix quotas, and tenant-attributed
accounting that reconciles exactly against the request journal across a
crash.  The RPC transport and the HTTP front door are not ported yet
(ROADMAP A8).
"""
from deepspeed_tpu_torch.serving.frontdoor.tenants import (
    DEFAULT_TENANT,
    SLO_CLASSES,
    TenantRegistry,
    TenantThrottled,
    journal_tenant_totals,
)

__all__ = [
    "DEFAULT_TENANT",
    "SLO_CLASSES",
    "TenantRegistry",
    "TenantThrottled",
    "journal_tenant_totals",
]
