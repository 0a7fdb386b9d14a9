"""Per-tenant QoS plane: identity, weighted-fair budgets, SLO-aware
admission (docs/robustness.md "Per-tenant QoS"); the port's own copy of
`dynamo_tpu/qos`."""

from dynamo_tpu_torch.qos.tenancy import (  # noqa: F401
    DEFAULT_TENANT,
    MAX_DYNAMIC_TENANTS,
    OVER_BUDGET_PENALTY,
    PRIORITY_MAX,
    PRIORITY_MIN,
    RESOLVED_HEADER,
    TENANTS_ENV,
    TenantAccountant,
    TenantAdmission,
    TenantClass,
    TenantRegistry,
    sanitize_tenant,
    tenant_from_dict,
)
