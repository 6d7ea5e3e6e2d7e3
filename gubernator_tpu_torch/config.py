"""Configuration read by the one-node serving path and its daemon.

The subset of `gubernator_tpu/config.py` the port needs so far: the RPC
item cap, the batching behaviors (reference config.go:43-66), the
dimensions of the regular and GLOBAL arenas and their key routing, the
traffic-analytics and SLO knobs (GUBER_ANALYTICS_*, GUBER_SLO_*), the
warm tier's (TierConfig, GUBER_TIER_*), QoS (QoSConfig, GUBER_QOS_*:
admission, the congestion window, fair slotting, the breaker knobs), the
concurrency-lease book (LeaseConfig, GUBER_LEASE_*), the peer ring's
(GUBER_STATIC_PEERS, GUBER_ADVERTISE_ADDRESS, GUBER_BATCH_TIMEOUT, the
GLOBAL manager's GUBER_GLOBAL_SYNC_WAIT / _TIMEOUT / _BATCH_LIMIT, the
heartbeat detector's GUBER_HEARTBEAT_*, the hinted handoff's
GUBER_HINT_*, tracing's GUBER_TRACE_*; GUBER_FAULTS is
read by the daemon at boot, net/faults.py), the engine's lowering
(GUBER_PALLAS), the serving pipeline's knobs, the env readers they use,
and the daemon's env config (DaemonConfig with GUBER_SNAPSHOT_DIR and
GUBER_SNAPSHOT_INTERVAL_MS, the front door's GUBER_FRONTDOOR_* and
GUBER_SHM_*, the discovery backends' GUBER_K8S_* and GUBER_ETCD_* with
etcd's TLS, mesh serving's GUBER_LOCKSTEP_STACK and GUBER_SKIP_GLOBAL,
load_env_file, config_from_env: reference cmd/gubernator/config.go:59-147,
the same GUBER_* names and values as the JAX package's for every knob).
GUBER_MESH_* are read by parallel/distributed.py and the daemon, and
GUBER_GLOBAL_KEYS_FILE by the daemon, where the JAX package reads them.
GUBER_TORCH_DEVICE names the daemon's device (default `cuda`; `cpu` runs
the plain versions), the port's counterpart of the JAX daemon's
GUBER_JAX_PLATFORM.  A knob of a subsystem the port had not ported raised
ValueError, naming its ROADMAP item (_UNPORTED, empty now that every
subsystem is served).  QoS is on at
the defaults, as in the JAX package (GUBER_QOS_ENABLED=0 turns it off);
its peer-lane knobs (retries, breaker, fail-open) act on the peer ring.

Environment read by the engine itself, once, when it is built:

  GUBER_PALLAS=1        the per-op lowering (per_op_lowering below).
                        Default: the hand-written drain, which answers to
                        the JAX package's fused and staged lowerings.
  GUBER_EXACT_KEYS=1    the native router's exact-key guard
                        (exact_keys_env below).
  GUBER_REPLAY_CAP      the replay-bound guard (replay_cap_override).
  GUBER_PIPELINE_KMAX   the deepest stacked drain (core/engine.py
                        PIPELINE_K_BUCKETS), read when the engine module
                        is imported.

Read by the serving pipeline (core/pipeline.py) when it is built:

  GUBER_PIPELINE_DEPTH      drains in flight at once (default 3);
  GUBER_PIPELINE_GATE       the occupancy gate on/off (default on);
  GUBER_PIPELINE_GATE_FRAC  the share of one window's lanes the gate
                            waits for (default 1.0);
  GUBER_FETCH_WORKERS       fetch threads (default 2);
  GUBER_FETCH_STRIDE        drains that share one fetch at least
                            (default FETCH_STRIDE_DEFAULT);
  GUBER_FETCH_STRIDE_MAX    how far the QoS stride controller may grow
                            it (FETCH_STRIDE_MAX_DEFAULT);
  GUBER_CHAIN_LINGER_MS     how long a chained drain waits for companions
                            (CHAIN_LINGER_MS_DEFAULT).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import List, Optional

# Hard cap on items per RPC (reference gubernator.go:34).
MAX_BATCH_SIZE = 1000

# The serving pipeline's deferred-fetch chain (core/pipeline.py): how
# many drains share one fetch task at least (1 = fetch every drain), how
# far the QoS stride controller (qos/congestion.py observe_chain) may grow
# that as the backlog deepens, and how long a chained drain waits for
# companions before the pipeline fetches anyway.
FETCH_STRIDE_DEFAULT = 1
FETCH_STRIDE_MAX_DEFAULT = 8
CHAIN_LINGER_MS_DEFAULT = 2.0


@dataclass
class BehaviorConfig:
    """Batching and GLOBAL windows (reference config.go:43-57, defaults
    :59-66): the peer lane's RPC timeout and batching window
    (net/peers.py), the classic lane's window, and the GLOBAL manager's
    sync interval, broadcast timeout and batch bound (core/global_sync.py).

    Durations are seconds (float); 0.0005 is the reference's 500us default.
    """

    batch_timeout: float = 0.5
    batch_wait: float = 0.0005
    batch_limit: int = MAX_BATCH_SIZE
    global_sync_wait: float = 0.0005
    global_timeout: float = 0.5
    global_batch_limit: int = MAX_BATCH_SIZE
    # mesh (lockstep) serving only: windows of the tick's stacked step
    # (engine.step_stacked); every rank must use the same value, since each
    # window's GLOBAL all-reduce is part of the tick's collective sequence.
    # 1 = one-window ticks
    lockstep_stack: int = 1

    def validate(self) -> None:
        if self.batch_limit > MAX_BATCH_SIZE:
            raise ValueError(
                f"Behaviors.BatchLimit cannot exceed '{MAX_BATCH_SIZE}'")
        if self.lockstep_stack < 1:
            raise ValueError("Behaviors.lockstep_stack must be >= 1")


@dataclass
class EngineConfig:
    """Dimensions of the device arena (replaces the reference's LRU cache
    size knob GUBER_CACHE_SIZE, cache/lru.go:50)."""

    capacity_per_shard: int = 65536
    batch_per_shard: int = 1024
    # shards of the regular arena on the one device (the JAX package's mesh
    # size); keys spread over them by crc32
    num_shards: int = 1
    # the replicated GLOBAL arena: slots, lanes per shard per window, and
    # distinct GLOBAL keys per window
    global_capacity: int = 4096
    global_batch_per_shard: int = 256
    max_global_updates: int = 256
    # Regular-key routing: "auto" uses the native C++ router
    # (gubernator_tpu_torch/native) when it builds and the Python slot
    # tables otherwise; "on" requires the router; False forces the tables.
    use_native: object = "auto"
    # Opt-in exact-key collision guard in the native router (env:
    # GUBER_EXACT_KEYS=1): stores full key bytes so a 64-bit fingerprint
    # collision probes onward instead of merging two keys' counters.
    exact_keys: bool = False
    # Replay-bound guard: max lanes of a NON-uniform duplicate-key run per
    # window before the window is cut there; 0 disables.
    replay_cap: int = 128
    # Config-level promise of zero GLOBAL traffic (GUBER_SKIP_GLOBAL=1):
    # GLOBAL windows are skipped on every rank alike, and a GLOBAL lane
    # raises
    skip_global: bool = False


@dataclass
class QoSConfig:
    """QoS / overload-control knobs (qos/): admission control, the AIMD
    congestion window, per-tenant fair slotting, and the peer-lane
    resilience layer.  No reference analog: the reference queues
    unboundedly and surfaces peer failures as raw gRPC errors."""

    enabled: bool = True
    # ---- admission (qos/admission.py)
    # Bounded pending queue, in decisions; 0 disables the bound.
    max_pending: int = 8192
    # Implicit per-request deadline (seconds) when the client sends none;
    # 0 = requests without a deadline never deadline-shed.
    default_deadline: float = 0.0
    # ---- congestion window (qos/congestion.py)
    min_window: int = 64
    max_window: int = 8192
    # Drain-latency target the AIMD tracks (seconds).  Above it: cwnd *=
    # aimd_decrease (once per cooldown); below: cwnd += aimd_increase.
    target_drain_latency: float = 0.1
    aimd_increase: float = 64.0
    aimd_decrease: float = 0.5
    latency_ewma_alpha: float = 0.3
    # ---- fair slotting (qos/fairness.py)
    fair_slotting: bool = True
    # ---- peer lane (qos/breaker.py; acts with the peer ring)
    peer_retries: int = 2          # retries after the first attempt
    retry_base: float = 0.025      # seconds; doubles per attempt, jittered
    retry_cap: float = 0.25
    breaker_fail_threshold: int = 5
    breaker_open_duration: float = 2.0
    breaker_half_open_probes: int = 1
    # While a peer's breaker is open: True = fail open (answer locally,
    # non-authoritative, flagged in metadata); False = fail closed
    # (in-band shed with reason breaker_open).
    fail_open: bool = True

    def validate(self) -> None:
        if self.max_pending < 0:
            raise ValueError("QoS.max_pending must be >= 0")
        if self.min_window < 1 or self.max_window < self.min_window:
            raise ValueError(
                "QoS window bounds need 1 <= min_window <= max_window")
        if not (0.0 < self.aimd_decrease < 1.0):
            raise ValueError("QoS.aimd_decrease must be in (0, 1)")
        if not (0.0 < self.latency_ewma_alpha <= 1.0):
            raise ValueError("QoS.latency_ewma_alpha must be in (0, 1]")
        if self.target_drain_latency <= 0:
            raise ValueError("QoS.target_drain_latency must be > 0")
        if self.peer_retries < 0:
            raise ValueError("QoS.peer_retries must be >= 0")


@dataclass
class LeaseConfig:
    """Concurrency-lease book knobs (algorithms/leases.py).  The device
    free-slot counters stay authoritative regardless; these govern the
    host-side book that attributes held slots to clients.  Defaults read
    GUBER_LEASE_* at construction, as in the JAX package."""

    # Release a vanished client's held slots when the RPC that carried its
    # acquires is torn down before the response is delivered (server.py
    # stream-close hook).  Off leaves reclaim to bucket expiry alone.
    release_on_stream_close: bool = field(
        default_factory=lambda: env_bool("GUBER_LEASE_RELEASE_ON_CLOSE",
                                         True))
    # Periodic sweep of expired grants out of the book, ms (0 disables;
    # the device already expired those buckets, the sweep only keeps the
    # lease gauges honest).
    sweep_interval_ms: int = field(
        default_factory=lambda: env_int("GUBER_LEASE_SWEEP_MS", 5000,
                                        minimum=0))
    # Cap on slots one client may hold per key (0 = unlimited): an acquire
    # that would exceed it is answered OVER_LIMIT on the host, before the
    # device sees it.
    max_per_client: int = field(
        default_factory=lambda: env_int("GUBER_LEASE_MAX_PER_CLIENT", 0,
                                        minimum=0))

    def validate(self) -> None:
        if self.sweep_interval_ms < 0:
            raise ValueError("Lease.sweep_interval_ms must be >= 0")
        if self.max_per_client < 0:
            raise ValueError("Lease.max_per_client must be >= 0")


@dataclass
class HealthConfig:
    """Self-healing ring knobs: the heartbeat failure detector
    (net/health.py, GUBER_HEARTBEAT_*) and the hinted-handoff buffer of
    core/global_sync.py (GUBER_HINT_TTL_MS, GUBER_HINT_MAX), as in the JAX
    package's HealthConfig; its drain ceiling is the port's
    DaemonConfig.drain_timeout.  No reference analog: the reference leans
    on its discovery backend to remove dead peers, which
    GUBER_STATIC_PEERS never does."""

    # ---- heartbeat failure detector (net/health.py)
    heartbeat_enabled: bool = True
    # probe cadence and per-probe deadline (seconds)
    heartbeat_interval: float = 1.0
    heartbeat_timeout: float = 0.5
    # consecutive probe failures before a peer is confirmed DOWN (and the
    # ring re-homes around it); consecutive successes before a DOWN peer
    # is confirmed UP again: the two-sided hysteresis keeps a flapping
    # peer from churning the ring on every blip
    suspect_after: int = 3
    recover_after: int = 2
    # ---- hinted handoff (core/global_sync.py)
    # how long a failed peer's GLOBAL hits/updates are buffered before
    # being dropped as expired (seconds), and the per-peer entry bound
    # (oldest evicted first, counted as expired)
    hint_ttl: float = 30.0
    hint_max: int = 1024

    def validate(self) -> None:
        if self.heartbeat_interval <= 0 or self.heartbeat_timeout <= 0:
            raise ValueError("Health heartbeat interval/timeout must be > 0")
        if self.suspect_after < 1 or self.recover_after < 1:
            raise ValueError("Health suspect_after/recover_after must be >= 1")
        if self.hint_ttl < 0 or self.hint_max < 0:
            raise ValueError("Health hint_ttl/hint_max must be >= 0")


@dataclass
class PeerInfo:
    # reference etcd.go:29-32
    address: str = ""
    is_owner: bool = False


@dataclass
class AnalyticsConfig:
    """Device-computed traffic analytics (ops/analytics.py +
    observability/analytics.py): per-drain outcome counts, count-min
    sketch + hot-key top-K, per-tenant usage rows, arena occupancy/churn.
    Defaults read GUBER_ANALYTICS_* at construction, as in the JAX
    package.  No reference analog: the reference exposes only cache
    hit/miss."""

    enabled: bool = field(
        default_factory=lambda: env_bool("GUBER_ANALYTICS", False))
    # Candidate rows per shard per drain AND the host's rolling table size.
    topk: int = field(
        default_factory=lambda: env_int("GUBER_ANALYTICS_TOPK", 32))
    # Count-min sketch geometry (per shard, resident on device).
    sketch_width: int = field(
        default_factory=lambda: env_int("GUBER_ANALYTICS_SKETCH_WIDTH", 2048))
    sketch_depth: int = field(
        default_factory=lambda: env_int("GUBER_ANALYTICS_SKETCH_DEPTH", 4))
    # Sketch + rolling-table halving cadence (ms); 0 disables decay.
    decay_ms: int = field(
        default_factory=lambda: env_int("GUBER_ANALYTICS_DECAY_MS", 10_000,
                                        minimum=0))
    # Distinct tenants tracked on device; id 0 is the shared
    # "other/unattributed" row.
    tenant_slots: int = field(
        default_factory=lambda: env_int("GUBER_ANALYTICS_TENANTS", 64,
                                        minimum=2))
    # Hot-key score = hits + over_weight * over_limit decisions: keys
    # burning their limit rank above merely chatty ones.
    over_weight: int = field(
        default_factory=lambda: env_int("GUBER_ANALYTICS_OVER_WEIGHT", 4,
                                        minimum=0))

    def validate(self) -> None:
        from gubernator_tpu_torch.ops.analytics import MAX_SKETCH_DEPTH
        if self.sketch_depth > MAX_SKETCH_DEPTH:
            raise ValueError(
                f"Analytics.sketch_depth cannot exceed {MAX_SKETCH_DEPTH}")
        if self.topk < 1 or self.sketch_width < 16:
            raise ValueError("Analytics.topk >= 1 and sketch_width >= 16 required")


@dataclass
class TierConfig:
    """Tiered key state (state/tiers.py): a host warm store behind the
    fixed arena on the device, turning slot exhaustion into a cache-miss
    cost over an unbounded key space.  Off by default (warm_rows=0): the
    engine's path is then the single-tier one.  Requires the Python
    routing tables (config_from_env forces use_native=False when tiers are
    on).  Defaults read GUBER_TIER_* at construction, as in the JAX
    package.  No reference analog: the reference's LRU drops the coldest
    bucket's counters."""

    # Warm-store capacity in rows; 0 disables tiers.
    warm_rows: int = field(
        default_factory=lambda: env_int("GUBER_TIER_WARM", 0, minimum=0))
    # Warm row layout: "int64" (absolute times) or "compact32" (int32
    # values, times as int32 deltas from the store's epoch: half the
    # bytes; rows outside that range keep an int64 side map, so the
    # choice is never lossy).
    layout: str = field(
        default_factory=lambda: _env("GUBER_TIER_LAYOUT", "int64"))
    # LRU-head candidates ranked by analytics heat when picking a live
    # demotion victim (1 = strict LRU).
    victim_sample: int = field(
        default_factory=lambda: env_int("GUBER_TIER_VICTIM_SAMPLE", 8))
    # Proactive demotion: tier_maintain spills cold entries once a shard's
    # table runs above this occupancy fraction, demote_batch rows a pass.
    demote_watermark: float = field(
        default_factory=lambda: env_float("GUBER_TIER_DEMOTE_WATERMARK",
                                          0.9, minimum=0.1))
    demote_batch: int = field(
        default_factory=lambda: env_int("GUBER_TIER_DEMOTE_BATCH", 64))

    @property
    def enabled(self) -> bool:
        return self.warm_rows > 0

    def validate(self) -> None:
        if self.layout not in ("int64", "compact32"):
            raise ValueError(
                f"GUBER_TIER_LAYOUT must be int64 or compact32, "
                f"got {self.layout!r}")
        if not (0.1 <= self.demote_watermark <= 1.0):
            raise ValueError("Tier.demote_watermark must be in [0.1, 1.0]")


@dataclass
class SLOConfig:
    """SLO burn-rate engine (observability/analytics.py SLOEngine):
    multi-window multi-burn-rate alerting over configured objectives.
    Each burn window pairs with a short window (window/12); an alert fires
    only when BOTH exceed the threshold (Google SRE workbook ch.5)."""

    enabled: bool = field(
        default_factory=lambda: env_bool("GUBER_SLO", False))
    # drain p99 objective: fraction of drains allowed over the target.
    drain_p99_ms: float = field(
        default_factory=lambda: env_float("GUBER_SLO_DRAIN_P99_MS", 100.0,
                                          minimum=1e-3))
    drain_budget: float = field(
        default_factory=lambda: env_float("GUBER_SLO_DRAIN_BUDGET", 0.01))
    # shed-rate objective: fraction of decisions allowed to shed.
    shed_budget: float = field(
        default_factory=lambda: env_float("GUBER_SLO_SHED_BUDGET", 0.01))
    # availability objective: 1 - availability is the error budget over
    # decisions (sheds + errors count as bad).
    availability: float = field(
        default_factory=lambda: env_float("GUBER_SLO_AVAILABILITY", 0.999))
    # "window_seconds:threshold" pairs, comma-separated (page = 14.4x over
    # 5m, ticket = 6x over 30m, trend = 1x over 2h).
    burn_windows: str = field(
        default_factory=lambda: _env("GUBER_SLO_BURN_WINDOWS",
                                     "300:14.4,1800:6,7200:1"))

    def windows(self) -> List[tuple]:
        """Parse burn_windows -> [(seconds, threshold)], skipping malformed
        pairs (observability knobs must never crash a boot)."""
        out = []
        for part in self.burn_windows.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                w, _, t = part.partition(":")
                sec, thr = float(w), float(t) if t else 1.0
                if sec > 0 and thr > 0:
                    out.append((sec, thr))
            except ValueError:
                continue
        return out or [(300.0, 14.4), (1800.0, 6.0), (7200.0, 1.0)]

    def validate(self) -> None:
        if not (0.0 < self.drain_budget <= 1.0):
            raise ValueError("SLO.drain_budget must be in (0, 1]")
        if not (0.0 < self.shed_budget <= 1.0):
            raise ValueError("SLO.shed_budget must be in (0, 1]")
        if not (0.0 < self.availability < 1.0):
            raise ValueError("SLO.availability must be in (0, 1)")


@dataclass
class DaemonConfig:
    """Daemon env config (reference cmd/gubernator/config.go:42-57): the
    knobs the port serves, with the JAX package's defaults."""

    grpc_listen_address: str = "localhost:81"
    http_listen_address: str = "localhost:80"
    # the address the peer ring knows this node by (GUBER_ADVERTISE_ADDRESS,
    # default the gRPC address) and the static peer list
    # (GUBER_STATIC_PEERS, comma-separated; empty = standalone)
    advertise_address: str = ""
    static_peers: List[str] = field(default_factory=list)
    cache_size: int = 50000  # reference default, example.conf:11
    debug: bool = False
    # the device the engine runs on (GUBER_TORCH_DEVICE)
    device: str = "cuda"
    # ceiling on the graceful stop's drain phase, seconds (the JAX
    # package's HealthConfig.drain_timeout, GUBER_DRAIN_TIMEOUT_MS)
    drain_timeout: float = 5.0
    # State lifecycle (state/snapshot.py): with snapshot_dir set, the
    # daemon restores the arenas from it at boot, saves every
    # snapshot_interval_ms and once more at a clean stop.
    snapshot_dir: str = ""
    snapshot_interval_ms: int = 60_000
    # request tracing (observability/tracing.py): the probability a
    # request roots a trace (0 disables) and the OTLP/HTTP export endpoint
    trace_sample: float = field(
        default_factory=lambda: env_float("GUBER_TRACE_SAMPLE", 0.0))
    trace_export: str = field(
        default_factory=lambda: _env("GUBER_TRACE_EXPORT"))
    # Device-time flight recorder (observability/devprof.py), read as the
    # JAX package's Config reads them (gubernator_tpu/config.py:416-431).
    # Mode "" = off (the window clock still runs; the kernel table fills
    # only from explicit captures); "periodic" re-arms an N-drain
    # torch.profiler capture every interval on a shedding background
    # thread and folds the parsed kernel table.
    devprof_mode: str = field(
        default_factory=lambda: _env("GUBER_DEVPROF"))
    devprof_interval_s: float = field(
        default_factory=lambda: env_float("GUBER_DEVPROF_INTERVAL_S", 30.0,
                                          minimum=0.05))
    devprof_drains: int = field(
        default_factory=lambda: env_int("GUBER_DEVPROF_DRAINS", 8))
    devprof_ring: int = field(
        default_factory=lambda: env_int("GUBER_DEVPROF_RING", 64))
    devprof_slow_ms: float = field(
        default_factory=lambda: env_float("GUBER_DEVPROF_SLOW_MS", 50.0))

    # The multi-process front door (frontdoor.py): 0 = the in-process gRPC
    # server; N >= 1 starts N acceptor worker processes sharing the gRPC
    # listen port via SO_REUSEPORT, each handing parsed request columns to
    # this engine process over a shared-memory ring (core/shm_ring.py).
    frontdoor_workers: int = 0
    # slabs a worker ring = RPCs in flight a worker; beyond it workers
    # shed in-band with shed_reason=ring_full
    shm_ring_slots: int = 64
    # the slab size: fits a max-size (1 MB) gRPC message in either record
    # shape (raw bytes, or 1000-item columns and keys)
    shm_slab_bytes: int = (1 << 20) + (1 << 16)
    # the response encode's side: "worker" ships decision columns and each
    # worker serializes the protobuf; "engine" serializes here
    frontdoor_encode: str = "worker"
    # wire-read coalescing: up to N RPCs of one worker event-loop tick
    # share one slab and one ring publish; 0/1 = off
    frontdoor_batch_reads: int = 8

    # Kubernetes discovery (discovery/kubernetes.py)
    k8s_namespace: str = ""
    k8s_pod_ip: str = ""
    k8s_pod_port: str = ""
    k8s_endpoints_selector: str = ""
    # etcd discovery (discovery/etcd.py); any GUBER_ETCD_TLS_* variable
    # enables TLS (reference cmd/gubernator/config.go:149-192), its CA,
    # cert and key file paths
    etcd_addresses: List[str] = field(default_factory=list)
    etcd_prefix: str = "/gubernator/peers/"
    etcd_dial_timeout: float = 5.0
    etcd_username: str = ""
    etcd_password: str = ""
    etcd_tls_enabled: bool = False
    etcd_tls_cert: str = ""
    etcd_tls_key: str = ""
    etcd_tls_ca: str = ""
    etcd_tls_skip_verify: bool = False

    behaviors: BehaviorConfig = field(default_factory=BehaviorConfig)
    health: HealthConfig = field(default_factory=HealthConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    qos: QoSConfig = field(default_factory=QoSConfig)
    analytics: AnalyticsConfig = field(default_factory=AnalyticsConfig)
    slo: SLOConfig = field(default_factory=SLOConfig)
    tiers: TierConfig = field(default_factory=TierConfig)
    leases: LeaseConfig = field(default_factory=LeaseConfig)

    def etcd_ssl_context(self):
        """The ssl.SSLContext of the etcd gateway connection, or None when
        TLS is off (the reference's setupTLS, config.go:149-192)."""
        if not self.etcd_tls_enabled:
            return None
        import ssl

        ctx = ssl.create_default_context()
        if self.etcd_tls_ca:
            ctx.load_verify_locations(cafile=self.etcd_tls_ca)
        if self.etcd_tls_cert and self.etcd_tls_key:
            ctx.load_cert_chain(self.etcd_tls_cert, self.etcd_tls_key)
        if self.etcd_tls_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        return ctx

    @property
    def k8s_enabled(self) -> bool:
        return bool(self.k8s_namespace)

    @property
    def etcd_enabled(self) -> bool:
        return bool(self.etcd_addresses)


def _env(name: str, default: str = "") -> str:
    v = os.environ.get(name)
    return v if v not in (None, "") else default


def env_int(name: str, default: int, minimum: int = 1) -> int:
    """Integer GUBER_* knob with a floor; malformed values fall back to
    the default."""
    try:
        return max(minimum, int(os.environ.get(name, default)))
    except ValueError:
        return default


def env_float(name: str, default: float, minimum: float = 0.0) -> float:
    """Float GUBER_* knob with a floor; malformed values fall back to the
    default."""
    try:
        return max(minimum, float(os.environ.get(name, default)))
    except ValueError:
        return default


_TRUTHY = frozenset(("1", "true", "yes", "on"))
_FALSY = frozenset(("0", "false", "no", "off", ""))
_warned_env: set = set()


def env_bool(name: str, default: bool = False) -> bool:
    """Boolean GUBER_* knob: 0/1/true/false/yes/no/on/off
    (case-insensitive); unset means `default`.  An unrecognized value
    warns once per (name, value) and falls back to the default."""
    v = os.environ.get(name)
    if v is None:
        return default
    s = v.strip().lower()
    if s in _TRUTHY:
        return True
    if s in _FALSY:
        return False
    if (name, v) not in _warned_env:
        _warned_env.add((name, v))
        logging.getLogger("gubernator.config").warning(
            "unrecognized boolean value %r for %s (expected 0/1/true/false); "
            "using default %s", v, name, default)
    return default


def replay_cap_override():
    """GUBER_REPLAY_CAP: the replay-bound guard's cap in lanes, or None
    when the variable is unset.  As in the JAX engine
    (gubernator_tpu/core/engine.py:281-294), a set value overrides the
    engine's argument and the config whatever they say, 0 disables the
    guard, and a value that is not an integer raises."""
    v = os.environ.get("GUBER_REPLAY_CAP")
    if v is None:
        return None
    try:
        return int(v)
    except ValueError:
        raise ValueError(
            f"GUBER_REPLAY_CAP must be an integer (lanes; 0 "
            f"disables the replay-bound guard), got {v!r}") from None


def exact_keys_env() -> bool:
    """GUBER_EXACT_KEYS=1: turn the native router's exact-key guard on
    whatever the engine's argument says (the JAX engine's test,
    gubernator_tpu/core/engine.py:303-309: the value "1" and nothing
    else)."""
    return os.environ.get("GUBER_EXACT_KEYS") == "1"


def per_op_lowering() -> bool:
    """GUBER_PALLAS: does the engine take the per-op lowering?

    In the JAX package GUBER_PALLAS=1 selects its per-op Pallas kernels
    (gubernator_tpu/config.py:40): XLA sorts, segments and gathers each
    window, window_step_pallas runs the window math and global_apply_pallas
    the GLOBAL apply.  In the port it selects the same split: torch ops
    around the window-math kernel (ops/window_math_kernel.py) and the
    GLOBAL apply kernel (ops/global_kernel.py global_apply), with the
    drain's analytics as torch ops (ops/analytics.py shard_stats).  Off
    (the default), every window runs in the hand-written drain
    (ops/drain_kernel.py) and the GLOBAL window in global_combined.  The
    engine reads it once, at construction."""
    return env_bool("GUBER_PALLAS", False)


# Knobs of subsystems the port has not ported yet: (variable, or a prefix
# ending in "_", its default (None: any value), ROADMAP Queue 1 item).
# config_from_env raises when one is set to anything but its default.
# Every subsystem is served now, mesh serving last (GUBER_MESH_* are read
# in parallel/distributed.py and daemon.py, GUBER_GLOBAL_KEYS_FILE in
# daemon.py, as in the JAX package), so the table is empty; it stays for a
# subsystem a later JAX change may add.
_UNPORTED: tuple = ()
_UNPORTED_EXACT = {n: (d, i) for n, d, i in _UNPORTED if not n.endswith("_")}
_UNPORTED_PREFIX = tuple((n, d, i) for n, d, i in _UNPORTED if n.endswith("_"))


def _at_default(value: str, default) -> bool:
    v = value.strip()
    if isinstance(default, bool):
        s = v.lower()
        return s in (_TRUTHY if default else _FALSY)
    if isinstance(default, (int, float)):
        try:
            return float(v) == float(default)
        except ValueError:
            return False
    return v == default


def check_unported() -> None:
    """Raise ValueError for the first knob of an unported subsystem set to
    anything but its default (an empty value counts as unset, as _env
    reads it)."""
    for name in sorted(os.environ):
        value = os.environ[name]
        if not name.startswith("GUBER_") or value == "":
            continue
        if name in _UNPORTED_EXACT:
            default, item = _UNPORTED_EXACT[name]
        else:
            hit = next(((d, i) for p, d, i in _UNPORTED_PREFIX
                        if name.startswith(p)), None)
            if hit is None:
                continue
            default, item = hit
        if default is None or not _at_default(value, default):
            raise ValueError(
                f"{name}={value!r}: this knob's subsystem is not ported to "
                f"gubernator_tpu_torch yet (ROADMAP.md Queue 1 item {item})")


def load_env_file(path: str) -> None:
    """Load a KEY=value file into the process env (reference
    cmd/gubernator/config.go:239-267): '#' comments, blank lines skipped,
    malformed lines rejected."""
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if "=" not in line:
                raise ValueError(f"malformed key=value on line '{ln}'")
            k, _, v = line.partition("=")
            os.environ[k.strip()] = v.strip()


def config_from_env(env_file: Optional[str] = None) -> DaemonConfig:
    """Assemble DaemonConfig from GUBER_* env vars (reference
    cmd/gubernator/config.go:59-147), as the JAX package's config_from_env
    does for the knobs the port serves; a knob of an unported subsystem
    raises (check_unported)."""
    if env_file:
        load_env_file(env_file)
    check_unported()

    c = DaemonConfig()
    c.grpc_listen_address = _env("GUBER_GRPC_ADDRESS", c.grpc_listen_address)
    c.http_listen_address = _env("GUBER_HTTP_ADDRESS", c.http_listen_address)
    c.advertise_address = _env("GUBER_ADVERTISE_ADDRESS",
                               c.grpc_listen_address)
    c.static_peers = [a.strip() for a in _env("GUBER_STATIC_PEERS").split(",")
                      if a.strip()]
    c.cache_size = int(_env("GUBER_CACHE_SIZE", str(c.cache_size)))
    c.debug = _env("GUBER_DEBUG") in ("true", "1", "yes")
    c.device = _env("GUBER_TORCH_DEVICE", c.device)
    c.drain_timeout = env_float("GUBER_DRAIN_TIMEOUT_MS",
                                c.drain_timeout * 1000.0,
                                minimum=0.0) / 1000.0
    c.snapshot_dir = _env("GUBER_SNAPSHOT_DIR")
    c.snapshot_interval_ms = env_int("GUBER_SNAPSHOT_INTERVAL_MS",
                                     c.snapshot_interval_ms, minimum=100)

    # the front door, read as the JAX package reads it
    c.frontdoor_workers = env_int("GUBER_FRONTDOOR_WORKERS",
                                  c.frontdoor_workers, minimum=0)
    c.shm_ring_slots = env_int("GUBER_SHM_RING_SLOTS", c.shm_ring_slots,
                               minimum=2)
    c.shm_slab_bytes = env_int("GUBER_SHM_SLAB_BYTES", c.shm_slab_bytes,
                               minimum=1 << 16)
    enc = _env("GUBER_FRONTDOOR_ENCODE", c.frontdoor_encode)
    c.frontdoor_encode = enc if enc in ("worker", "engine") else "worker"
    c.frontdoor_batch_reads = env_int("GUBER_FRONTDOOR_BATCH_READS",
                                      c.frontdoor_batch_reads, minimum=0)

    # the discovery backends
    c.k8s_namespace = _env("GUBER_K8S_NAMESPACE")
    c.k8s_pod_ip = _env("GUBER_K8S_POD_IP")
    c.k8s_pod_port = _env("GUBER_K8S_POD_PORT")
    c.k8s_endpoints_selector = _env("GUBER_K8S_ENDPOINTS_SELECTOR")
    etcd = _env("GUBER_ETCD_ENDPOINTS")
    c.etcd_addresses = [a.strip() for a in etcd.split(",") if a.strip()]
    c.etcd_prefix = _env("GUBER_ETCD_KEY_PREFIX", c.etcd_prefix)
    c.etcd_dial_timeout = float(_env("GUBER_ETCD_DIAL_TIMEOUT", "5"))
    c.etcd_username = _env("GUBER_ETCD_USER")
    c.etcd_password = _env("GUBER_ETCD_PASSWORD")
    # any GUBER_ETCD_TLS_* variable switches the connection to TLS
    # (reference config.go:136-140 anyHasPrefix)
    c.etcd_tls_enabled = any(k.startswith("GUBER_ETCD_TLS_")
                             for k in os.environ)
    c.etcd_tls_cert = _env("GUBER_ETCD_TLS_CERT")
    c.etcd_tls_key = _env("GUBER_ETCD_TLS_KEY")
    c.etcd_tls_ca = _env("GUBER_ETCD_TLS_CA")
    c.etcd_tls_skip_verify = _env("GUBER_ETCD_TLS_SKIP_VERIFY").lower() in (
        "true", "1", "yes")
    # reference config.go:118-133: the two backends are exclusive
    if c.k8s_enabled and c.etcd_enabled:
        raise ValueError(
            "set only one of GUBER_K8S_NAMESPACE or GUBER_ETCD_ENDPOINTS")

    b = c.behaviors
    if _env("GUBER_BATCH_TIMEOUT"):
        b.batch_timeout = float(_env("GUBER_BATCH_TIMEOUT"))
    if _env("GUBER_BATCH_WAIT"):
        b.batch_wait = float(_env("GUBER_BATCH_WAIT"))
    if _env("GUBER_BATCH_LIMIT"):
        b.batch_limit = int(_env("GUBER_BATCH_LIMIT"))
    if _env("GUBER_GLOBAL_SYNC_WAIT"):
        b.global_sync_wait = float(_env("GUBER_GLOBAL_SYNC_WAIT"))
    if _env("GUBER_GLOBAL_TIMEOUT"):
        b.global_timeout = float(_env("GUBER_GLOBAL_TIMEOUT"))
    if _env("GUBER_GLOBAL_BATCH_LIMIT"):
        b.global_batch_limit = int(_env("GUBER_GLOBAL_BATCH_LIMIT"))
    if _env("GUBER_LOCKSTEP_STACK"):
        b.lockstep_stack = int(_env("GUBER_LOCKSTEP_STACK"))
    b.validate()

    e = c.engine
    if _env("GUBER_TPU_CAPACITY_PER_SHARD"):
        e.capacity_per_shard = int(_env("GUBER_TPU_CAPACITY_PER_SHARD"))
    elif c.cache_size:
        # honor the reference knob
        e.capacity_per_shard = max(1024, c.cache_size)
    if _env("GUBER_TPU_BATCH_PER_SHARD"):
        e.batch_per_shard = int(_env("GUBER_TPU_BATCH_PER_SHARD"))
    if _env("GUBER_TPU_GLOBAL_CAPACITY"):
        e.global_capacity = int(_env("GUBER_TPU_GLOBAL_CAPACITY"))
    if os.environ.get("GUBER_NATIVE") is not None:
        e.use_native = "auto" if env_bool("GUBER_NATIVE", True) else False
    if _env("GUBER_EXACT_KEYS"):
        e.exact_keys = _env("GUBER_EXACT_KEYS") == "1"
    if _env("GUBER_REPLAY_CAP"):
        e.replay_cap = int(_env("GUBER_REPLAY_CAP"))
    if _env("GUBER_SKIP_GLOBAL"):
        e.skip_global = _env("GUBER_SKIP_GLOBAL") == "1"

    # QoS / overload control (qos/), read as the JAX package reads it
    q = c.qos
    q.enabled = env_bool("GUBER_QOS_ENABLED", q.enabled)
    q.max_pending = env_int("GUBER_QOS_MAX_PENDING", q.max_pending,
                            minimum=0)
    q.default_deadline = env_float("GUBER_QOS_DEFAULT_DEADLINE_MS",
                                   q.default_deadline * 1000.0) / 1000.0
    q.min_window = env_int("GUBER_QOS_MIN_WINDOW", q.min_window)
    q.max_window = env_int("GUBER_QOS_MAX_WINDOW", q.max_window)
    q.target_drain_latency = env_float(
        "GUBER_QOS_TARGET_DRAIN_MS",
        q.target_drain_latency * 1000.0, minimum=1e-3) / 1000.0
    q.aimd_increase = env_float("GUBER_QOS_AIMD_INCREASE", q.aimd_increase,
                                minimum=1.0)
    if _env("GUBER_QOS_AIMD_DECREASE"):
        q.aimd_decrease = float(_env("GUBER_QOS_AIMD_DECREASE"))
    q.fair_slotting = env_bool("GUBER_QOS_FAIR_SLOTTING", q.fair_slotting)
    q.peer_retries = env_int("GUBER_QOS_PEER_RETRIES", q.peer_retries,
                             minimum=0)
    q.retry_base = env_float("GUBER_QOS_RETRY_BASE_MS",
                             q.retry_base * 1000.0, minimum=1.0) / 1000.0
    q.retry_cap = env_float("GUBER_QOS_RETRY_CAP_MS",
                            q.retry_cap * 1000.0, minimum=1.0) / 1000.0
    q.breaker_fail_threshold = env_int("GUBER_QOS_BREAKER_FAILURES",
                                       q.breaker_fail_threshold)
    q.breaker_open_duration = env_float(
        "GUBER_QOS_BREAKER_OPEN_MS",
        q.breaker_open_duration * 1000.0, minimum=1.0) / 1000.0
    q.breaker_half_open_probes = env_int("GUBER_QOS_BREAKER_PROBES",
                                         q.breaker_half_open_probes)
    q.fail_open = env_bool("GUBER_QOS_FAIL_OPEN", q.fail_open)
    q.validate()

    # the self-healing ring: the heartbeat detector (net/health.py) and
    # the hinted handoff (core/global_sync.py)
    h = c.health
    h.heartbeat_enabled = env_bool("GUBER_HEARTBEAT_ENABLED",
                                   h.heartbeat_enabled)
    h.heartbeat_interval = env_float(
        "GUBER_HEARTBEAT_INTERVAL_MS",
        h.heartbeat_interval * 1000.0, minimum=10.0) / 1000.0
    h.heartbeat_timeout = env_float(
        "GUBER_HEARTBEAT_TIMEOUT_MS",
        h.heartbeat_timeout * 1000.0, minimum=10.0) / 1000.0
    h.suspect_after = env_int("GUBER_HEARTBEAT_SUSPECT", h.suspect_after)
    h.recover_after = env_int("GUBER_HEARTBEAT_RECOVER", h.recover_after)
    h.hint_ttl = env_float("GUBER_HINT_TTL_MS",
                           h.hint_ttl * 1000.0, minimum=0.0) / 1000.0
    h.hint_max = env_int("GUBER_HINT_MAX", h.hint_max, minimum=0)
    h.validate()
    # tracing, rebuilt after load_env_file like the analytics knobs below
    c.trace_sample = env_float("GUBER_TRACE_SAMPLE", 0.0)
    c.trace_export = _env("GUBER_TRACE_EXPORT")

    # the default_factory fields read GUBER_LEASE_* (at DaemonConfig()
    # above, after load_env_file), GUBER_ANALYTICS_* and GUBER_SLO_*:
    # the last two rebuilt after load_env_file so an env-file sets them too
    c.analytics = AnalyticsConfig()
    c.analytics.validate()
    c.slo = SLOConfig()
    c.slo.validate()
    # tiers likewise; the warm tier lives in the Python routing tables
    # (the native router keeps fingerprints, not key strings), so enabling
    # it forces that backend, with a log line
    c.tiers = TierConfig()
    c.tiers.validate()
    if c.tiers.enabled and e.use_native not in (False, "off"):
        logging.getLogger("gubernator.config").info(
            "GUBER_TIER_WARM=%d enables the warm tier; forcing the Python "
            "routing backend (use_native=False)", c.tiers.warm_rows)
        e.use_native = False
    return c
