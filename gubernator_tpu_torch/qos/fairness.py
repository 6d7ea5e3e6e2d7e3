"""Tenant identity (the JAX package's qos/fairness.py `tenant_of`).

The traffic analytics' per-tenant accounting keys on it (the serving
pipeline stages each lane's tenant id from it), and the tenant-fair
slotting of the JAX package's QoS subsystem does too, so "tenant" means the
same thing in the scheduler and on the dashboard.  The rest of the QoS
subsystem is not part of the port yet.
"""

from __future__ import annotations


def tenant_of(req) -> str:
    """Canonical tenant identity of one request: the rate-limit `name`
    (the reference's metric/limit family; `unique_key` is the principal
    within a tenant)."""
    return req.name or "default"
