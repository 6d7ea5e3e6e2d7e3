"""Prometheus metrics with the reference's metric names: the port's subset.

The part of `gubernator_tpu/observability/metrics.py` the port serves,
with the same names and labels:

  cache_size, cache_access_count{type}          reference cache/lru.go:56-59
  grpc_request_counts{status,method},
  grpc_request_duration_milliseconds{method}    reference prometheus.go:52-59
  guber_tpu_snapshot_duration_seconds, guber_tpu_snapshot_bytes,
  guber_tpu_snapshots_total{status}, guber_tpu_restore_age_seconds
                                                the state lifecycle
  guber_tpu_tier_events_total{event}, guber_tpu_tier_warm_rows,
  guber_tpu_tier_warm_bytes                     the warm tier (watch_tiers)
  guber_qos_queue_depth, guber_qos_shed_total{reason},
  guber_qos_effective_window, guber_qos_drain_latency_ewma_seconds,
  guber_qos_drain_depth_ewma, guber_qos_breaker_state{peer}
                                                QoS (watch_qos, observe_shed)
  guber_tpu_decisions_total{algorithm}, guber_tpu_lease_held_slots,
  guber_tpu_lease_clients, guber_tpu_lease_keys,
  guber_tpu_lease_releases_total{reason}        the algorithm plane and the
                                                lease book (watch_leases)
  async_durations, broadcast_durations          reference global.go:44-51
  guber_tpu_cluster_peers,
  guber_tpu_cluster_forwarded_total,
  guber_qos_peer_retries_total{peer},
  guber_qos_fail_open_total,
  global_send_errors_total{peer},
  broadcast_errors_total{peer},
  guber_hints_total{event,peer},
  guber_tpu_stage_duration_ms{stage}            the peer ring (its stages
                                                peer_forward and
                                                global_broadcast)
  guber_tpu_migrated_keys_total{direction},
  guber_tpu_migration_skipped_stale_total,
  guber_peer_health_state{peer},
  guber_ring_rehomes_total{direction}           failure handling and live
                                                migration

The cache families are read from the native router (its resident key
count, hits and misses) at scrape time.  This module imports
prometheus_client, so the serving core never imports it: an Instance has
no registry unless one is given (`Instance(metrics=Metrics())`, which the
daemon always does).  The JAX package's other families (pipeline,
analytics, devprof, the drain stages and their rolling
quantiles) are left for the observability item of the port's ROADMAP.  `observe_shed` only counts: the admission controller
feeds each shed to the SLO engine itself.
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
        # the state lifecycle (state/snapshot.py)
        self.snapshot_duration = Histogram(
            "guber_tpu_snapshot_duration_seconds",
            "Wall time of one arena snapshot (export + serialize + write).",
            registry=self.registry,
        )
        self.snapshot_size = Gauge(
            "guber_tpu_snapshot_bytes",
            "Size of the last written snapshot in bytes.",
            registry=self.registry,
        )
        self.snapshot_total = Counter(
            "guber_tpu_snapshots_total",
            "Snapshot attempts.",
            ["status"],  # success | failed
            registry=self.registry,
        )
        self.restore_age = Gauge(
            "guber_tpu_restore_age_seconds",
            "Age of the snapshot restored at boot (0 when cold-started).",
            registry=self.registry,
        )
        # tiered key state (state/tiers.py): hot arena <-> warm store
        self.tier_events = Counter(
            "guber_tpu_tier_events_total",
            "Tiered key-state events by kind: promote/demote row moves, "
            "warm_hit/cold_miss on staging lookups behind a table miss, "
            "warm_evict overflow drops, demote_drop dead-or-expired spills, "
            "demote_stale same-drain victims dropped to cold.",
            ["event"],
            registry=self.registry,
        )
        self.tier_warm_rows = Gauge(
            "guber_tpu_tier_warm_rows",
            "Rows resident in the warm tier.",
            registry=self.registry,
        )
        self.tier_warm_bytes = Gauge(
            "guber_tpu_tier_warm_bytes",
            "Host bytes allocated to the warm tier's SoA store.",
            registry=self.registry,
        )
        # QoS (qos/): admission queue, sheds by reason, the AIMD window,
        # and per-peer breaker state
        self.qos_queue_depth = Gauge(
            "guber_qos_queue_depth",
            "Pending decisions held in the bounded admission queue.",
            registry=self.registry,
        )
        self.qos_shed = Counter(
            "guber_qos_shed_total",
            "Requests shed by admission control, by reason.",
            ["reason"],  # queue_full | deadline | breaker_open
            registry=self.registry,
        )
        self.qos_effective_window = Gauge(
            "guber_qos_effective_window",
            "Congestion-adaptive window size (decisions per dispatch).",
            registry=self.registry,
        )
        self.qos_drain_latency_ewma = Gauge(
            "guber_qos_drain_latency_ewma_seconds",
            "EWMA of observed drain wall time feeding the AIMD.",
            registry=self.registry,
        )
        self.qos_drain_depth_ewma = Gauge(
            "guber_qos_drain_depth_ewma",
            "EWMA of occupied drain depth feeding the AIMD.",
            registry=self.registry,
        )
        self.breaker_state = Gauge(
            "guber_qos_breaker_state",
            "Per-peer circuit breaker state "
            "(0=closed, 1=half_open, 2=open).",
            ["peer"],
            registry=self.registry,
        )
        # the peer ring (net/peers.py, core/global_sync.py,
        # core/service.py): GLOBAL sends and broadcasts, membership, the
        # forwarding tax, the peer lane's resilience and hinted handoff
        self.async_durations = Histogram(
            "async_durations",
            "The duration of GLOBAL async sends in seconds.",
            registry=self.registry,
        )
        self.broadcast_durations = Histogram(
            "broadcast_durations",
            "The duration of GLOBAL broadcasts to peers in seconds.",
            registry=self.registry,
        )
        self.cluster_peers = Gauge(
            "guber_tpu_cluster_peers",
            "Peers in the installed consistent-hash ring, self included "
            "(0 until the first membership update).",
            registry=self.registry,
        )
        self.cluster_forwarded = Counter(
            "guber_tpu_cluster_forwarded_total",
            "Rate-limit items forwarded to their owning peer (both the "
            "per-item path and the native lane's spliced batches).",
            registry=self.registry,
        )
        self.peer_retries = Counter(
            "guber_qos_peer_retries_total",
            "Peer-lane RPC retries after transient failures.",
            ["peer"],
            registry=self.registry,
        )
        self.fail_open_served = Counter(
            "guber_qos_fail_open_total",
            "Forwards answered locally (non-authoritative) while the "
            "owner's breaker was open.",
            registry=self.registry,
        )
        self.global_send_errors = Counter(
            "global_send_errors_total",
            "Failed per-peer GLOBAL aggregated-hit sends (after the peer "
            "lane's own retries).",
            ["peer"],
            registry=self.registry,
        )
        self.broadcast_errors = Counter(
            "broadcast_errors_total",
            "Failed per-peer GLOBAL owner-broadcast sends.",
            ["peer"],
            registry=self.registry,
        )
        self.hints = Counter(
            "guber_hints_total",
            "Hinted-handoff buffer events, by event "
            "(queued | replayed | expired).",
            ["event", "peer"],
            registry=self.registry,
        )
        # failure handling and live key migration (state/migrate.py,
        # net/health.py)
        self.migrated_keys = Counter(
            "guber_tpu_migrated_keys_total",
            "Bucket rows shipped or imported by live key migration.",
            ["direction"],  # out | in
            registry=self.registry,
        )
        self.migration_skipped_stale = Counter(
            "guber_tpu_migration_skipped_stale_total",
            "Incoming migrated rows dropped because a fresher local entry "
            "existed.",
            registry=self.registry,
        )
        self.peer_health_state = Gauge(
            "guber_peer_health_state",
            "Failure-detector verdict per peer (0=up, 1=suspect, 2=down).",
            ["peer"],
            registry=self.registry,
        )
        self.ring_rehomes = Counter(
            "guber_ring_rehomes_total",
            "Automatic ring membership changes driven by the failure "
            "detector, by direction (down | up).",
            ["direction"],
            registry=self.registry,
        )
        self.stage_duration = Histogram(
            "guber_tpu_stage_duration_ms",
            "Wall time of one request-lifecycle stage in milliseconds.",
            ["stage"],
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100,
                     250, 500, 1000, 2500),
            registry=self.registry,
        )
        # the algorithm plane (algorithms/): per-algorithm decision mix,
        # and the host-side concurrency-lease book
        self.algo_decisions = Counter(
            "guber_tpu_decisions_total",
            "Rate-limit decisions served, by algorithm "
            "(token_bucket | leaky_bucket | gcra | sliding_window | "
            "concurrency).",
            ["algorithm"],
            registry=self.registry,
        )
        self.lease_held = Gauge(
            "guber_tpu_lease_held_slots",
            "Concurrency-lease slots currently held across all keys "
            "(host lease book; the device free-slot counters are the "
            "admission truth).",
            registry=self.registry,
        )
        self.lease_clients = Gauge(
            "guber_tpu_lease_clients",
            "Distinct clients holding at least one concurrency lease.",
            registry=self.registry,
        )
        self.lease_keys = Gauge(
            "guber_tpu_lease_keys",
            "Distinct keys with at least one live concurrency lease.",
            registry=self.registry,
        )
        self.lease_releases = Counter(
            "guber_tpu_lease_releases_total",
            "Lease slots released on behalf of clients, by reason "
            "(explicit | stream_close | peer_down | expired).",
            ["reason"],
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

    def watch_tiers(self, engine) -> None:
        """Export the warm tier's occupancy and event counters at scrape
        time from one engine.tier_stats read (the TierManager keeps plain
        ints; the scrape advances the counters by their change)."""
        events = {
            "promote": "promotions",
            "demote": "demotions",
            "warm_hit": "warm_hits",
            "cold_miss": "cold_misses",
            "warm_evict": "warm_evictions",
            "demote_drop": "demote_dropped_expired",
            "demote_stale": "demote_dropped_stale",
        }
        last = {k: 0 for k in events}

        def refresh():
            st = engine.tier_stats()
            if st is None:
                return
            self.tier_warm_rows.set(st["warm_rows"])
            self.tier_warm_bytes.set(st["warm_bytes"])
            for label, name in events.items():
                cur = st[name]
                if cur > last[label]:
                    self.tier_events.labels(event=label).inc(
                        cur - last[label])
                    last[label] = cur

        self._scrape_hooks.append(refresh)

    def watch_leases(self, book) -> None:
        """Export the lease book's occupancy at scrape time from one
        book.stats() read (keys, clients and held move together)."""

        def refresh():
            keys, clients, held = book.stats()
            self.lease_keys.set(keys)
            self.lease_clients.set(clients)
            self.lease_held.set(held)

        self._scrape_hooks.append(refresh)

    def observe_algorithm(self, algorithm: str, n: int = 1) -> None:
        self.algo_decisions.labels(algorithm=algorithm).inc(n)

    def observe_lease_release(self, reason: str, n: int) -> None:
        if n > 0:
            self.lease_releases.labels(reason=reason).inc(n)

    def watch_qos(self, qos) -> None:
        """Export the QoS control state at scrape time: queue depth, the
        adaptive window and the drain EWMAs from one QoSManager read."""

        def refresh():
            self.qos_queue_depth.set(qos.admission.pending)
            self.qos_effective_window.set(qos.congestion.effective_window())
            self.qos_drain_latency_ewma.set(qos.congestion.latency_ewma)
            self.qos_drain_depth_ewma.set(qos.congestion.depth_ewma)

        self._scrape_hooks.append(refresh)

    def observe_shed(self, reason: str, n: int = 1) -> None:
        self.qos_shed.labels(reason=reason).inc(n)

    _BREAKER_STATES = {"closed": 0, "half_open": 1, "open": 2}

    def observe_breaker(self, peer: str, state: str) -> None:
        self.breaker_state.labels(peer=peer).set(
            self._BREAKER_STATES.get(state, 0))

    def observe_peer_retry(self, peer: str) -> None:
        self.peer_retries.labels(peer=peer).inc()

    def observe_global_error(self, peer: str, kind: str,
                             queued: int = 0) -> None:
        """One failed per-peer GLOBAL send (kind: hits|update), plus how
        many NEW hint entries it buffered."""
        if kind == "update":
            self.broadcast_errors.labels(peer=peer).inc()
        else:
            self.global_send_errors.labels(peer=peer).inc()
        if queued > 0:
            self.hints.labels(event="queued", peer=peer).inc(queued)

    def observe_hints(self, peer: str, replayed: int = 0,
                      expired: int = 0) -> None:
        if replayed:
            self.hints.labels(event="replayed", peer=peer).inc(replayed)
        if expired:
            self.hints.labels(event="expired", peer=peer).inc(expired)

    _HEALTH_STATES = {"up": 0, "suspect": 1, "down": 2}

    def observe_peer_health(self, peer: str, state: str) -> None:
        self.peer_health_state.labels(peer=peer).set(
            self._HEALTH_STATES.get(state, 0))

    def observe_rehome(self, direction: str) -> None:
        self.ring_rehomes.labels(direction=direction).inc()

    def observe_migration(self, moved: int = 0, imported: int = 0,
                          skipped_stale: int = 0) -> None:
        if moved:
            self.migrated_keys.labels(direction="out").inc(moved)
        if imported:
            self.migrated_keys.labels(direction="in").inc(imported)
        if skipped_stale:
            self.migration_skipped_stale.inc(skipped_stale)

    def observe_stage(self, stage: str, seconds: float) -> None:
        """One stage's wall time (peer_forward, global_broadcast) into the
        stage histogram, in milliseconds."""
        self.stage_duration.labels(stage=stage).observe(
            max(0.0, seconds) * 1000.0)

    def observe_snapshot(self, seconds: float, size_bytes: int,
                         ok: bool) -> None:
        self.snapshot_total.labels(
            status="success" if ok else "failed").inc()
        if ok:
            self.snapshot_duration.observe(seconds)
            self.snapshot_size.set(size_bytes)

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
