"""Prometheus metrics with the reference's metric names: the wire's subset.

The part of `gubernator_tpu/observability/metrics.py` the transport needs,
with the same names and labels:

  cache_size, cache_access_count{type}          reference cache/lru.go:56-59
  grpc_request_counts{status,method},
  grpc_request_duration_milliseconds{method}    reference prometheus.go:52-59

The cache families are read from the native router (its resident key
count, hits and misses) at scrape time.  This module imports
prometheus_client, so the serving core never imports it: an Instance has
no registry unless one is given (`Instance(metrics=Metrics())`, which the
daemon always does).  The JAX package's other families (GLOBAL, pipeline,
QoS, analytics, tiers, leases, devprof) are left for the observability
item of the port's ROADMAP.
"""

from __future__ import annotations

import time
from typing import Optional

from prometheus_client import (  # noqa: F401  (CONTENT_TYPE_LATEST re-exported)
    CONTENT_TYPE_LATEST,
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)


class Metrics:
    """Per-instance metric registry (instances in one process each get
    their own, like each reference node's prometheus.Registry,
    main.go:53)."""

    def __init__(self, registry: Optional[CollectorRegistry] = None):
        self.registry = registry or CollectorRegistry()
        self._scrape_hooks = []
        self.cache_size = Gauge(
            "cache_size",
            "Size of the cache which holds the rate limits.",
            registry=self.registry,
        )
        self.cache_access_count = Counter(
            "cache_access_count",
            "Cache access counts.",
            ["type"],
            registry=self.registry,
        )
        self.grpc_request_counts = Counter(
            "grpc_request_counts",
            "The count of gRPC requests.",
            ["status", "method"],
            registry=self.registry,
        )
        self.grpc_request_duration = Histogram(
            "grpc_request_duration_milliseconds",
            "The timings of gRPC requests in milliseconds.",
            ["method"],
            registry=self.registry,
        )

    def watch_engine(self, engine) -> None:
        """Export the engine's cache counters at scrape time: the
        cache_size gauge, and the hit/miss counters advanced by their
        change since the last scrape."""
        last = {"hit": 0, "miss": 0}

        def refresh():
            self.cache_size.set(engine.cache_size)
            for kind, now in (("hit", engine.cache_hits),
                              ("miss", engine.cache_misses)):
                if now > last[kind]:
                    self.cache_access_count.labels(type=kind).inc(
                        now - last[kind])
                    last[kind] = now

        self._scrape_hooks.append(refresh)

    def expose(self) -> bytes:
        for fn in self._scrape_hooks:
            fn()
        return generate_latest(self.registry)

    def observe_rpc(self, method: str, start: float, ok: bool) -> None:
        """Per-RPC accounting (replaces the reference's gRPC stats-handler
        channel pipeline, prometheus.go:65-134)."""
        self.grpc_request_counts.labels(
            status="success" if ok else "failed", method=method
        ).inc()
        self.grpc_request_duration.labels(method=method).observe(
            (time.monotonic() - start) * 1000.0
        )
