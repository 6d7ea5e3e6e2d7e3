"""Runtime introspection: the debug snapshot.

`build_debug_snapshot` (JAX `observability/introspect.py`) assembles the
one-read operator view served by `GET /v1/admin/debug`
(api/http_gateway.py): arena occupancy, the admission queue, the
congestion window, per-peer breaker states, the GLOBAL plane's errors and
hints, the failure detector, the front door, the fault rules, the serving
pipeline, traffic analytics, the warm tier, per-stage latency quantiles
and recent traces.  Every number comes from the accessor the control
loops read, so what the operator sees is what the controllers saw.  The
JAX snapshot's `slo`, `profile` and `devprof` sections come with the
device profiler's port (observability/devprof.py, ROADMAP item 7) and are
left out until then.
"""

from __future__ import annotations


def _jsonable(d: dict) -> dict:
    """Coerce numpy scalars (engine counters) to plain Python types so the
    snapshot always survives json.dumps."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = _jsonable(v)
        elif isinstance(v, (bool, int, float, str)) or v is None:
            out[k] = v
        elif hasattr(v, "item"):
            out[k] = v.item()
        else:
            out[k] = str(v)
    return out


def build_debug_snapshot(instance) -> dict:
    """One coherent operator view of a core.service.Instance."""
    out: dict = {
        "address": instance.advertise_address,
        "mesh_mode": instance.mesh_mode,
        "standalone": instance.standalone,
        "engine": _jsonable(instance.engine.cache_stats()),
    }
    if instance.qos is not None:
        adm = instance.qos.admission
        cong = instance.qos.congestion
        out["admission"] = {
            "pending": adm.pending,
            "pending_peak": adm.pending_peak,
            "max_pending": adm.max_pending,
            "saturated": adm.saturated,
            "inflight_windows": adm.inflight_windows,
            "shed_counts": dict(adm.shed_counts),
        }
        out["congestion"] = {
            "effective_window": cong.effective_window(),
            "latency_ewma_ms": cong.latency_ewma * 1000.0,
            "depth_ewma": cong.depth_ewma,
            "congested": cong.congested,
            "increases": cong.increases,
            "decreases": cong.decreases,
            "stage_ewma_ms": {k: v * 1000.0
                              for k, v in cong.stage_ewma.items()},
        }
    out["peers"] = [
        {"host": p.host, "is_owner": p.is_owner,
         "breaker": p.breaker.state}
        for p in instance.peer_list()
    ]
    gm = instance.global_mgr
    out["global_sync"] = {
        "send_errors": dict(gm.send_errors),
        "broadcast_errors": dict(gm.broadcast_errors),
        "hints": gm.hints.snapshot(),
    }
    if instance.monitor is not None:
        out["health"] = instance.monitor.snapshot()
    if instance.frontdoor is not None:
        out["frontdoor"] = _jsonable(instance.frontdoor.debug_snapshot())
    from gubernator_tpu_torch.net.faults import FAULTS
    if FAULTS.enabled:
        out["faults"] = FAULTS.describe()
    pipe = instance.batcher.pipeline
    if pipe is not None:
        out["pipeline"] = {
            "in_flight": pipe._in_flight,
            "rpc_staged": pipe.rpc_staged,
            "rpc_leftover": pipe.rpc_leftover,
            "rpc_refused": pipe.rpc_refused,
            "decisions_staged": pipe.decisions_staged,
            "lanes_staged": pipe.lanes_staged,
            "drains": pipe.drains,
            "depth": pipe.depth,
            "overlap": pipe.overlap_snapshot(),
        }
    if instance.analytics is not None:
        snap = instance.analytics.snapshot()
        out["analytics"] = {
            "totals": snap["totals"],
            "occupancy": snap["occupancy"],
            "tenants": snap["tenants"],
            "topk": snap["topk"][:10],  # the full table lives at /topk
        }
    tiers = instance.engine.tier_stats()
    if tiers is not None:
        out["tiers"] = tiers
    out["stages"] = (instance.metrics.stage_snapshot()
                     if instance.metrics is not None else {})
    if instance.tracer is not None:
        out["tracing"] = {
            "sample": instance.tracer.sample,
            "recent_traces": instance.tracer.recent_traces(),
        }
    return out
