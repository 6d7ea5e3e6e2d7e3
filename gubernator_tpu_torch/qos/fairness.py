"""Per-tenant weighted fair slotting for device windows.

A device window has a fixed number of lanes; filling it FIFO means one
hot tenant's burst occupies every lane and everyone else waits a full
window cycle per burst.  `interleave_by_tenant` reorders a pending list
round-robin across `name` (tenant) groups — stable WITHIN each tenant, so
per-key sequential semantics are untouched (two requests for the same key
share a tenant and keep their relative order; reordering across different
keys is always commutative for the engine).

Weighted: a tenant's integer weight (default 1) is how many slots it
takes per round-robin pass, so operators can deliberately favor a tenant
without letting it starve the rest.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, TypeVar

T = TypeVar("T")


def tenant_of(req) -> str:
    """Canonical tenant identity of one request: the rate-limit `name`
    (the reference's metric/limit family; `unique_key` is the principal
    WITHIN a tenant).  The fair-slotting call sites and the traffic
    analytics' per-tenant accounting both key on THIS, so "tenant" means
    the same thing in the scheduler and on the dashboard."""
    return req.name or "default"


def interleave_by_tenant(
    items: Sequence[T],
    tenant_of: Callable[[T], str],
    weight_of: Optional[Callable[[str], int]] = None,
) -> List[T]:
    """Round-robin interleave across tenant groups (first-seen tenant
    order), stable within each group.  Single-tenant input returns the
    original order unchanged (and unallocated)."""
    groups: dict = {}
    order: List[str] = []
    for it in items:
        t = tenant_of(it)
        g = groups.get(t)
        if g is None:
            groups[t] = g = []
            order.append(t)
        g.append(it)
    if len(order) <= 1:
        return list(items)
    weights = [max(1, int(weight_of(t))) if weight_of else 1
               for t in order]
    out: List[T] = []
    # passes over the tenants that still hold items, in first-seen order:
    # the JAX loop's order, without its walk over exhausted groups (one
    # hot tenant made that O(its items x tenants)); the last tenant left
    # takes the rest at once
    active = [(groups[t], w) for t, w in zip(order, weights)]
    i = 0
    while len(active) > 1:
        nxt = []
        for g, w in active:
            out.extend(g[i * w:(i + 1) * w])
            if len(g) > (i + 1) * w:
                nxt.append((g, w))
        active = nxt
        i += 1
    for g, w in active:
        out.extend(g[i * w:])
    return out
