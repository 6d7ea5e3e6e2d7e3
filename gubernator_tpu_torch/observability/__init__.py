"""Observability subsystem: metrics, tracing, device profiling and runtime
introspection.

Public API (the names of `gubernator_tpu/observability/__init__.py`):

  * `Metrics`, `STAGES`, `CONTENT_TYPE_LATEST`: the per-instance Prometheus
    registry with the reference's metric names (metrics.py);
  * `Tracer` / `get_tracer`, `SpanContext`, `NOOP_SPAN`,
    `current_context`, `parse_traceparent`: the span recorder
    (tracing.py);
  * `Devprof`, `DevprofController`, `KernelTable`, `WindowClock`: the
    device-time flight recorder on torch.profiler (devprof.py);
  * `ProfileCapture` / `build_debug_snapshot`: the on-demand capture and
    the `/v1/admin/debug` view (introspect.py);
  * `TrafficAnalytics` / `SLOEngine`: the host side of the traffic
    analytics and the burn-rate alerting engine (analytics.py).

The names load on first use: the serving core imports tracing.py through
this package and must not load prometheus_client (metrics.py), and the
front door's workers load no torch.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "CONTENT_TYPE_LATEST": "metrics",
    "STAGES": "metrics",
    "Metrics": "metrics",
    "Devprof": "devprof",
    "DevprofController": "devprof",
    "KernelTable": "devprof",
    "WindowClock": "devprof",
    "ProfileCapture": "introspect",
    "build_debug_snapshot": "introspect",
    "SLOEngine": "analytics",
    "TrafficAnalytics": "analytics",
    "NOOP_SPAN": "tracing",
    "SpanContext": "tracing",
    "Tracer": "tracing",
    "current_context": "tracing",
    "get_tracer": "tracing",
    "parse_traceparent": "tracing",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
