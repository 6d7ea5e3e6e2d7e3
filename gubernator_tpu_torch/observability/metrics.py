"""Prometheus metrics with the reference's metric names.

The port of `gubernator_tpu/observability/metrics.py`: every family of
the JAX `Metrics`, with the same names, labels and buckets
(tests/test_torch_metric_names.py holds them against it):

  cache_size, cache_access_count{type}          reference cache/lru.go:56-59
  grpc_request_counts{status,method},
  grpc_request_duration_milliseconds{method}    reference prometheus.go:52-59
  guber_tpu_windows_total, guber_tpu_window_occupancy,
  guber_tpu_aggregation_{decisions,lanes}_total,
  guber_tpu_window_duration_seconds, guber_tpu_fused_drains_total,
  guber_tpu_drain_depth_windows,
  guber_tpu_pipeline_inflight_windows, guber_tpu_pipeline_overlap_ratio,
  guber_tpu_window_buffer_reuse_total{event},
  guber_tpu_chain_fetch_stride, guber_tpu_chain_inflight_windows,
  guber_tpu_chain_fetch_elided_total            the pipelined drain
                                                (core/pipeline.py)
  guber_tpu_kernels_per_window,
  guber_tpu_device_window_ms{arm}, guber_tpu_device_window_ewma_ms{arm},
  guber_tpu_devprof_captures_total{status}      device profiling
                                                (observability/devprof.py)
  guber_tpu_stage_duration_ms{stage}            the request-lifecycle
                                                stages (STAGES, chain_fetch)
  guber_tpu_cache_slots{state}                  slot occupancy (watch_engine)
  guber_tpu_hot_key_hits_total{key},
  guber_tpu_tenant_decisions_total{tenant,outcome},
  guber_tpu_arena_churn_total, guber_tpu_arena_occupancy_slots{state},
  guber_slo_burn_rate{slo,window}, guber_slo_firing{slo}
                                                traffic analytics and the
                                                SLO engine (watch_analytics)
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
  guber_tpu_cluster_peers, guber_tpu_cluster_forwarded_total,
  guber_qos_peer_retries_total{peer}, guber_qos_fail_open_total,
  global_send_errors_total{peer}, broadcast_errors_total{peer},
  guber_hints_total{event,peer}                 the peer ring
  guber_tpu_migrated_keys_total{direction},
  guber_tpu_migration_skipped_stale_total,
  guber_peer_health_state{peer},
  guber_ring_rehomes_total{direction}           failure handling and live
                                                migration
  guber_tpu_frontdoor_workers, guber_tpu_frontdoor_rpcs_total{worker},
  guber_tpu_frontdoor_sheds_total{worker},
  guber_tpu_frontdoor_restarts_total,
  guber_tpu_frontdoor_encode_total{worker,path},
  guber_tpu_frontdoor_batched_rpcs_total{worker},
  guber_tpu_frontdoor_batch_flushes_total{worker},
  guber_tpu_frontdoor_trace_drops_total{worker},
  guber_tpu_shm_ring_depth{worker},
  guber_tpu_shm_ring_stalls_total{worker}       the front door
                                                (watch_frontdoor)

The stage histogram's rolling p50/p95/p99 per stage (`stage_snapshot`,
the `stages` section of /v1/admin/debug) come from `_StageRing`s fed by
observe_stage.

This module imports prometheus_client, so the serving core never imports
it, and `Instance(metrics=None)` stays the Instance's default (the JAX
Instance always builds a registry): a card's machine may lack
prometheus_client, and every family is guarded by a `metrics is not None`
check where it is fed.  The daemon always builds `Metrics()`.
`observe_shed` only counts: the admission controller feeds each shed to
the SLO engine itself.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Optional

from prometheus_client import (  # noqa: F401  (CONTENT_TYPE_LATEST re-exported)
    CONTENT_TYPE_LATEST,
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)


# Canonical request-lifecycle stage names (JAX observability/metrics.py
# STAGES): the stage histogram and the rolling quantile snapshot order by
# them; chain_fetch (the deferred-fetch chain's shared fetch) comes after.
STAGES = (
    "enqueue",          # submit -> appended to the pending window
    "admission_wait",   # time queued before a dispatch takes the request
    "window_fill",      # host-side window build (pack keys, stage cols)
    "device_dispatch",  # engine thread: device step launch through done
    "drain_commit",     # fetch thread: device->host readback + replies
    "peer_forward",     # non-owner hop: peer-lane RPC round trip
    "global_broadcast", # GLOBAL lane: owner's broadcast to all peers
)


class _StageRing:
    """Fixed-size ring of recent stage durations (seconds) behind one
    lock: the rolling-window source of the p50/p95/p99 snapshot that
    /v1/admin/debug reads in-process."""

    __slots__ = ("_buf", "_size", "_idx", "_count", "_lock")

    def __init__(self, size: int = 1024):
        self._buf = [0.0] * size
        self._size = size
        self._idx = 0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._idx] = seconds
            self._idx = (self._idx + 1) % self._size
            if self._count < self._size:
                self._count += 1

    def snapshot(self) -> Optional[dict]:
        with self._lock:
            n = self._count
            if n == 0:
                return None
            samples = sorted(self._buf[:n] if n < self._size
                             else list(self._buf))

        def pct(p: float) -> float:
            return samples[min(n - 1, int(math.ceil(p * n)) - 1)] * 1000.0

        return {
            "count": n,
            "p50_ms": pct(0.50),
            "p95_ms": pct(0.95),
            "p99_ms": pct(0.99),
            "mean_ms": sum(samples) / n * 1000.0,
        }


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
        # device windows and the pipelined drain (core/pipeline.py, the
        # batcher's classic windows): rate(decisions)/rate(lanes) is the
        # live fold factor
        self.window_count = Counter(
            "guber_tpu_windows_total",
            "Device windows dispatched.",
            registry=self.registry,
        )
        self.window_occupancy = Histogram(
            "guber_tpu_window_occupancy",
            "Requests per device window.",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1000),
            registry=self.registry,
        )
        self.agg_decisions = Counter(
            "guber_tpu_aggregation_decisions_total",
            "Decisions served by the pipelined drain.",
            registry=self.registry,
        )
        self.agg_lanes = Counter(
            "guber_tpu_aggregation_lanes_total",
            "Device lanes staged by the pipelined drain.",
            registry=self.registry,
        )
        self.window_duration = Histogram(
            "guber_tpu_window_duration_seconds",
            "Wall time of one device window step.",
            registry=self.registry,
        )
        # every pipeline drain is one launch of the hand-written drain
        # kernel (the JAX package's fused megakernel counterpart); the
        # depth histogram is how many windows deep each K-stack ran
        self.fused_drains = Counter(
            "guber_tpu_fused_drains_total",
            "Pipeline drains served by the fused Pallas megakernel.",
            registry=self.registry,
        )
        self.drain_depth = Histogram(
            "guber_tpu_drain_depth_windows",
            "Occupied window depth K per pipeline drain.",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
            registry=self.registry,
        )
        # hand-kernel launches a window of the serving arm
        # (observability/devprof.py census_table): a property of the
        # program, published by the daemon and the kernels endpoint
        self.kernels_per_window = Gauge(
            "guber_tpu_kernels_per_window",
            "Executed-kernel census of the composed serving window "
            "(traced-program property; lower is better).",
            registry=self.registry,
        )
        # overlap: drains in flight, sum(stage busy) / pipeline-active
        # wall, staging arena recycling (core/window_buffers.py)
        self.pipeline_inflight_windows = Gauge(
            "guber_tpu_pipeline_inflight_windows",
            "Drain windows currently in flight between dispatch and commit.",
            registry=self.registry,
        )
        self.pipeline_overlap_ratio = Gauge(
            "guber_tpu_pipeline_overlap_ratio",
            "Aggregate stage busy time divided by pipeline-active wall time "
            "(1.0 = serial, >1 = host/device/fetch stages overlapped).",
            registry=self.registry,
        )
        self.window_buffer_reuse = Counter(
            "guber_tpu_window_buffer_reuse_total",
            "Drain staging arena acquisitions by outcome.",
            ["event"],  # reuse | alloc
            registry=self.registry,
        )
        # the deferred-fetch chain: its stride, the drains waiting on its
        # shared fetch, and the fetches it elided
        self.chain_fetch_stride = Gauge(
            "guber_tpu_chain_fetch_stride",
            "Current deferred-fetch chain stride (drains per stacked "
            "fetch; 1 = fetch every drain).",
            registry=self.registry,
        )
        self.chain_inflight_windows = Gauge(
            "guber_tpu_chain_inflight_windows",
            "Dispatched drains currently chained awaiting the shared "
            "stacked fetch.",
            registry=self.registry,
        )
        self.chain_fetch_elided = Counter(
            "guber_tpu_chain_fetch_elided_total",
            "Device-to-host fetch round trips elided by chaining drains "
            "behind one stacked fetch.",
            registry=self.registry,
        )
        # the device-time flight recorder (observability/devprof.py): the
        # dispatch -> fetch-ready window clock per arm, its EWMA, and the
        # periodic captures' outcomes
        self.device_window_ms = Histogram(
            "guber_tpu_device_window_ms",
            "Dispatch-to-fetch-ready wall time of one drain window, by "
            "executable arm.",
            ["arm"],
            buckets=(0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 1000),
            registry=self.registry,
        )
        self.device_window_ewma = Gauge(
            "guber_tpu_device_window_ewma_ms",
            "EWMA of the dispatch-to-fetch-ready window time, by "
            "executable arm.",
            ["arm"],
            registry=self.registry,
        )
        self.devprof_captures = Counter(
            "guber_tpu_devprof_captures_total",
            "Continuous-profiling capture cycles by outcome (folded = "
            "parsed into the kernel table; shed = skipped, a capture was "
            "already in flight; empty = trace parsed to nothing).",
            ["status"],  # folded | shed | empty
            registry=self.registry,
        )
        # slot occupancy, from engine.cache_stats at scrape time
        self.cache_slots = Gauge(
            "guber_tpu_cache_slots",
            "Arena slot occupancy by state.",
            ["state"],  # free | live | expired
            registry=self.registry,
        )
        # traffic analytics (observability/analytics.py): hot keys,
        # per-tenant decisions, the arena's churn and occupancy
        self.hot_key_hits = Counter(
            "guber_tpu_hot_key_hits_total",
            "Hits attributed to device-reported hot keys (top-K only; "
            "unresolved slots render as s<shard>:slot<n>).",
            ["key"],
            registry=self.registry,
        )
        self.tenant_decisions = Counter(
            "guber_tpu_tenant_decisions_total",
            "Decisions per fairness tenant, by outcome "
            "(under_limit | over_limit).",
            ["tenant", "outcome"],
            registry=self.registry,
        )
        self.arena_churn = Counter(
            "guber_tpu_arena_churn_total",
            "Bucket initializations seen by the drain reduction (slot "
            "allocations + window resets — the arena's write churn).",
            registry=self.registry,
        )
        self.arena_occupancy = Gauge(
            "guber_tpu_arena_occupancy_slots",
            "Device-computed arena slot occupancy from the last drain's "
            "expiry plane, by state (live | expired).",
            ["state"],
            registry=self.registry,
        )
        # the SLO burn-rate engine (observability/analytics.py SLOEngine)
        self.slo_burn_rate = Gauge(
            "guber_slo_burn_rate",
            "Error-budget burn rate per objective and window "
            "(1.0 = burning exactly the budget).",
            ["slo", "window"],
            registry=self.registry,
        )
        self.slo_firing = Gauge(
            "guber_slo_firing",
            "Multi-window burn-rate alert state per objective "
            "(1 = firing).",
            ["slo"],
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
        self._stage_rings: Dict[str, _StageRing] = {}
        self._stage_rings_lock = threading.Lock()
        # the multi-process front door (frontdoor.py): per-worker counters
        # live in the shared-memory status block and are read here at
        # scrape time (watch_frontdoor)
        self.frontdoor_workers = Gauge(
            "guber_tpu_frontdoor_workers",
            "Configured frontdoor acceptor worker processes "
            "(0 = classic single-process serving).",
            registry=self.registry,
        )
        self.frontdoor_rpcs = Counter(
            "guber_tpu_frontdoor_rpcs_total",
            "RPCs completed through the frontdoor shm ring, per worker.",
            ["worker"],
            registry=self.registry,
        )
        self.frontdoor_sheds = Counter(
            "guber_tpu_frontdoor_sheds_total",
            "Requests shed in-band by frontdoor workers (draining / "
            "saturated / ring_full), per worker.",
            ["worker"],
            registry=self.registry,
        )
        self.frontdoor_restarts = Counter(
            "guber_tpu_frontdoor_restarts_total",
            "Frontdoor worker crash-restarts performed by the hub.",
            registry=self.registry,
        )
        self.shm_ring_depth = Gauge(
            "guber_tpu_shm_ring_depth",
            "Published-but-unconsumed submissions in each worker's shm "
            "ring at scrape time.",
            ["worker"],
            registry=self.registry,
        )
        self.shm_ring_stalls = Counter(
            "guber_tpu_shm_ring_stalls_total",
            "Producer-side ring-full events (every slab in flight; the "
            "worker shed in-band with reason ring_full), per worker.",
            ["worker"],
            registry=self.registry,
        )
        self.frontdoor_encode = Counter(
            "guber_tpu_frontdoor_encode_total",
            "GetRateLimits responses delivered per worker, by encode "
            "path (worker = encoded from completion-ring decision "
            "columns; engine = pre-serialized on the engine).",
            ["worker", "path"],
            registry=self.registry,
        )
        self.frontdoor_batched_rpcs = Counter(
            "guber_tpu_frontdoor_batched_rpcs_total",
            "RPCs coalesced into multi-RPC columnar slab records by "
            "batched wire reads, per worker.",
            ["worker"],
            registry=self.registry,
        )
        self.frontdoor_batch_flushes = Counter(
            "guber_tpu_frontdoor_batch_flushes_total",
            "Multi-RPC batch records published to the shm ring "
            "(KIND_BATCH_COLS), per worker.",
            ["worker"],
            registry=self.registry,
        )
        self.frontdoor_trace_drops = Counter(
            "guber_tpu_frontdoor_trace_drops_total",
            "Sampled trace contexts dropped at the shm hand-off, per "
            "worker (raw-record fallback, or non-first members of a "
            "coalesced batch).",
            ["worker"],
            registry=self.registry,
        )

    def watch_engine(self, engine) -> None:
        """Export the engine's cache stats at scrape time from one
        engine.cache_stats read: the cache_size gauge, the free, live and
        expired slot gauges, and the hit/miss counters advanced by their
        change since the last scrape."""
        last = {"hit": 0, "miss": 0}

        def refresh():
            st = engine.cache_stats()
            self.cache_size.set(st["size"])
            for state in ("free", "live", "expired"):
                self.cache_slots.labels(state=state).set(st[state])
            for kind, now in (("hit", st["hits"]), ("miss", st["misses"])):
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

    def watch_analytics(self, analytics=None, slo=None) -> None:
        """Export the traffic analytics' occupancy gauges and the SLO
        engine's burn rates and alert states at scrape time.  Sheds reach
        the SLO engine through the admission controller, not here."""

        def refresh():
            if analytics is not None:
                occ = analytics.occupancy()
                for state in ("live", "expired"):
                    self.arena_occupancy.labels(state=state).set(occ[state])
            if slo is not None:
                for name, obj in slo.burn_rates().items():
                    for win, burn in obj["windows"].items():
                        self.slo_burn_rate.labels(
                            slo=name, window=win).set(burn)
                    self.slo_firing.labels(slo=name).set(
                        1 if obj["firing"] else 0)

        self._scrape_hooks.append(refresh)

    def observe_hot_key(self, key: str, hits: int) -> None:
        if hits > 0:
            self.hot_key_hits.labels(key=key).inc(hits)

    def observe_tenant(self, tenant: str, under: int, over: int) -> None:
        if under > 0:
            self.tenant_decisions.labels(
                tenant=tenant, outcome="under_limit").inc(under)
        if over > 0:
            self.tenant_decisions.labels(
                tenant=tenant, outcome="over_limit").inc(over)

    def observe_churn(self, inits: int) -> None:
        if inits > 0:
            self.arena_churn.inc(inits)

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
        stage histogram, in milliseconds, and into the stage's rolling
        ring (stage_snapshot)."""
        seconds = max(0.0, seconds)
        self.stage_duration.labels(stage=stage).observe(seconds * 1000.0)
        ring = self._stage_rings.get(stage)
        if ring is None:
            with self._stage_rings_lock:
                ring = self._stage_rings.setdefault(stage, _StageRing())
        ring.observe(seconds)

    def stage_snapshot(self) -> Dict[str, dict]:
        """Rolling per-stage quantiles: one read of every stage ring,
        keyed by stage name in STAGES order (stages with no samples yet
        omitted, stages outside STAGES last)."""
        out: Dict[str, dict] = {}
        with self._stage_rings_lock:
            rings = dict(self._stage_rings)
        for stage in STAGES:
            ring = rings.pop(stage, None)
            if ring is not None:
                snap = ring.snapshot()
                if snap is not None:
                    out[stage] = snap
        for stage, ring in rings.items():
            snap = ring.snapshot()
            if snap is not None:
                out[stage] = snap
        return out

    def watch_frontdoor(self, hub) -> None:
        """Export the front door hub's per-worker shared-memory counters at
        scrape time: the workers bump int64 cells of the status block (no
        prometheus client in the worker processes), and this hook
        advances the counters here by the change since the last scrape."""
        from gubernator_tpu_torch.core import shm_ring as sr
        last: Dict[tuple, int] = {}

        def delta(w: str, field: int, counter, **labels) -> None:
            cur = hub.status.get_w(int(w), field)
            prev = last.get((w, field), 0)
            if cur > prev:
                counter.labels(worker=w, **labels).inc(cur - prev)
                last[(w, field)] = cur

        def refresh():
            self.frontdoor_workers.set(hub.workers)
            if hub.status is None:
                return
            for i in range(hub.workers):
                w = str(i)
                delta(w, sr.W_RPCS, self.frontdoor_rpcs)
                delta(w, sr.W_SHEDS, self.frontdoor_sheds)
                delta(w, sr.W_STALLS, self.shm_ring_stalls)
                delta(w, sr.W_ENCODES, self.frontdoor_encode, path="worker")
                delta(w, sr.W_ENC_FALLBACK, self.frontdoor_encode,
                      path="engine")
                delta(w, sr.W_BATCH_RPCS, self.frontdoor_batched_rpcs)
                delta(w, sr.W_BATCH_FLUSHES, self.frontdoor_batch_flushes)
                delta(w, sr.W_TRACE_DROPS, self.frontdoor_trace_drops)
                if hub.chans:
                    self.shm_ring_depth.labels(worker=w).set(
                        hub.chans[i].sub_depth())
            cur = hub.restarts
            prev = last.get(("", "restarts"), 0)
            if cur > prev:
                self.frontdoor_restarts.inc(cur - prev)
                last[("", "restarts")] = cur

        self._scrape_hooks.append(refresh)

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
