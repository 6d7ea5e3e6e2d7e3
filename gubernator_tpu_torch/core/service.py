"""Service core: request validation, owner routing and dispatch.

The port of `gubernator_tpu/core/service.py` Instance (the reference's
Instance, gubernator.go:41-322): per-item validation
with the reference's exact error strings (gubernator.go:102-110), the
1000-item RPC cap (:78-81), owner-vs-forward routing over the
consistent-hash ring (:114-152), and local decisions through the
WindowBatcher into the engine's kernel launches per window.

The peer ring (ROADMAP item 6c): `set_peers` builds a
parallel/router.py ConsistentHashRing of net/peers.py PeerClients (a
PeerInfo with is_owner names this node), installs it in the pipeline's C
parser on the engine thread with the raw-RPC lane's gate closed across the
swap (`_sync_pipeline_ring`), and starts the GLOBAL manager.  Then a
request whose key another peer owns is forwarded through that peer's
batching window (a `peer_forward` span and stage; the answer names the
owner in metadata['owner']); with the owner's breaker open it is answered
locally, flagged non-authoritative, or shed (`fail_open`).  GLOBAL items
(token and leaky only, as in the JAX package): the owner decides them and
queues a broadcast (core/global_sync.py), a non-owner answers from its
replica without adding the hits (`accumulate=False`) and queues the hits
for the owner; `update_peer_globals` writes an owner's broadcast into the
replica arena as upsert lanes.  With an empty ring (standalone) every key
is this node's, and a peer-plane GLOBAL item is decided locally: the JAX
Instance fails it (its GlobalManager has no started interval), a
departure tests/test_torch_server.py pins.

The engine is built with the native router when it builds
(EngineConfig.use_native, "auto"), and then the batcher serves
token and leaky requests in the compact ranges through the pipelined lane
(core/pipeline.py: router-packed K-window stacks, one drain-kernel launch
each, an asynchronous fetch) and everything else through engine.process on
the router.  Traffic analytics and the SLO engine are wired as the JAX
service wires them (core/service.py:108-127): off by default, on with an
enabled AnalyticsConfig / SLOConfig; the pipeline stages each lane's tenant
id, drains through the stats drain and the finisher, and hands every
drain's stats to `TrafficAnalytics.ingest` and its wall time to
`SLOEngine.observe_drain` (requests on the legacy lane feed neither, as in
the JAX package).

Device profiling (JAX service.py:152-168, :202-220): `devprof` is the
observability/devprof.py facade over the batcher's armable ProfileCapture
(`batcher.profile`), the pipeline's window clock, the rolling kernel
table and, with devprof_mode "periodic", the controller that captures N
drains every interval; `close` stops it.  `_publish_census` sets
guber_tpu_kernels_per_window from the census of the serving arm, counted
on the engine thread so that no serving launch lands in the count.

The transport (server.py, api/http_gateway.py) calls `get_rate_limits`,
`get_peer_rate_limits` (the peer plane's relay: this node owns every item
it is sent), `update_peer_globals`, `health_check`, `batcher.submit_rpc`
(the raw-RPC lane) and `add_to_server`, roots its traces in `tracer`
(observability/tracing.py), and observes RPCs into `metrics` when it is
set: an `observability.metrics.Metrics` (prometheus_client), None by default
because the serving core needs no metrics library (a card's machine may
lack it); the JAX Instance always builds one.

QoS (qos/, JAX service.py:92-99) is on unless `qos=QoSConfig(enabled=
False)`: `get_rate_limits(deadline=)` carries the caller's deadline into
admission, sheds answer in-band, `health_check` reports a draining or
saturated node, and `drain` closes intake first.  The concurrency-lease
book (algorithms/leases.py, JAX service.py:250-342) attributes every
CONCURRENCY acquire to `client_id`; `release_client_leases` gives a
vanished client's slots back through the device, the
GUBER_LEASE_MAX_PER_CLIENT cap answers on the host, and a lease release
or a holder's request is exempt from deadline sheds.  A lease expires at
`millisecond_now() + duration`, the JAX package's clock, whatever clock
the engine runs on.

The state lifecycle (JAX service.py:780-827): `export_snapshot`,
`save_snapshot`, `export_snapshot_bytes` and `restore_snapshot_bytes` run
the engine's export and import on the engine thread (`_quiesced`), and
`tiers` (a TierConfig) puts the warm tier on the engine; a snapshot
carries the lease book's rows.  `aclose` flushes the GLOBAL manager
before it closes.

Failure handling and live key migration (JAX service.py:729-759,
:829-920): `migrate_keys(old_hosts, new_hosts)` ships each re-homed key's
live row to its new owner (state/migrate.py's payload over the peer lane's
`transfer_buckets`) and drops the moved regular keys and their lease rows
here; `transfer_buckets` is the receiving side.  Every engine call of both
runs on the engine thread (`_quiesced`), and both need the Python slot
tables.  The failure detector (net/health.py, `monitor` when the daemon
runs one) calls `release_peer_leases` and `rehome` when a peer goes down,
and `rehome` then `on_peer_recovered` (the GLOBAL hints' replay) when it
comes back.  `frontdoor` is the multi-process front door's hub
(frontdoor.py) when the daemon runs one; it serves its workers' records on
this Instance's event loop.

Mesh serving (JAX service.py:138-190, :389-400, :491-565): with
`mesh_peers` (every rank's gRPC address, in rank order) and an engine on a
parallel/distributed.py Mesh of several ranks, `mesh_mode` is on: the
batcher runs on a LockstepClock whose epoch is rank 0's clock
(agree_epoch_ms), keys route to their shard's rank through a
MeshShardPicker (a key of another rank's shard forwards there over the peer
lane, annotated with its owner), and a GLOBAL item is served here whoever
its owner is: the in-mesh all-reduce keeps every rank's replica
authoritative, so the GLOBAL manager never starts.  A GLOBAL key seen for
the first time registers mesh-wide first (`_ensure_global_registered`):
through the registrar, rank 0 (`register_globals`), which orders the
registrations and applies them on every rank in two phases
(`apply_global_registration`: configure, then activate), so no rank sums
hits into a slot another has not configured.  `health_check` reports a
rank whose batcher fail-stopped.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence

from gubernator_tpu_torch.algorithms.leases import LeaseBook
from gubernator_tpu_torch.algorithms.oracles import ALGORITHM_NAMES
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    HealthCheckResp,
    RateLimitReq,
    RateLimitResp,
    Status,
    millisecond_now,
)
from gubernator_tpu_torch.config import (
    MAX_BATCH_SIZE,
    AnalyticsConfig,
    BehaviorConfig,
    EngineConfig,
    HealthConfig,
    LeaseConfig,
    PeerInfo,
    QoSConfig,
    SLOConfig,
    TierConfig,
)
from gubernator_tpu_torch.core.batcher import WindowBatcher
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.core.global_sync import GlobalManager
from gubernator_tpu_torch.net.peers import BreakerOpenError, PeerClient
from gubernator_tpu_torch.observability.analytics import (
    SLOEngine,
    TrafficAnalytics,
)
from gubernator_tpu_torch.observability.devprof import (
    ARM_ANALYTICS,
    ARM_DRAIN,
    Devprof,
    census_table,
)
from gubernator_tpu_torch.observability.tracing import Tracer
from gubernator_tpu_torch.parallel.router import (
    ConsistentHashRing,
    MeshShardPicker,
)
from gubernator_tpu_torch.qos import QoSManager, shed_response
from gubernator_tpu_torch.qos.admission import SHED_BREAKER_OPEN
from gubernator_tpu_torch.state import migrate
from gubernator_tpu_torch.state import snapshot as snapmod

log = logging.getLogger("gubernator.service")

HEALTHY = "healthy"
UNHEALTHY = "unhealthy"

_ALGORITHMS = (Algorithm.TOKEN_BUCKET, Algorithm.LEAKY_BUCKET, Algorithm.GCRA,
               Algorithm.SLIDING_WINDOW, Algorithm.CONCURRENCY)


class BatchTooLargeError(Exception):
    """Maps to gRPC OutOfRange at the transport layer (gubernator.go:78-81)."""


class Instance:
    def __init__(self, engine: Optional[RateLimitEngine] = None,
                 engine_config: Optional[EngineConfig] = None,
                 behaviors: Optional[BehaviorConfig] = None,
                 device=None,
                 analytics: Optional[AnalyticsConfig] = None,
                 slo: Optional[SLOConfig] = None,
                 metrics=None,
                 tiers: Optional[TierConfig] = None,
                 qos: Optional[QoSConfig] = None,
                 leases: Optional[LeaseConfig] = None,
                 advertise_address: str = "",
                 tracer: Optional[Tracer] = None,
                 health: Optional[HealthConfig] = None,
                 peer_transport: Optional[Callable[[str], object]] = None,
                 devprof_mode: str = "",
                 devprof_interval_s: Optional[float] = None,
                 devprof_drains: Optional[int] = None,
                 mesh=None,
                 mesh_peers: Optional[List[str]] = None):
        """engine: a ready engine, else one is built from engine_config on
        `device` (default `cuda`).  analytics / slo: when given and
        enabled, the traffic analytics (the engine's resident sketch and
        stats accumulator, and a TrafficAnalytics) and the SLO burn-rate
        engine; otherwise `self.analytics` / `self.slo` are None.
        metrics: an `observability.metrics.Metrics` to observe RPCs,
        the router's cache, snapshots and the warm tier into, or None for
        no registry.  tiers: when given and enabled, the warm tier on the
        engine's Python tables (JAX service.py:128-137), fed by the
        analytics' heat when analytics is on too.  qos / leases: the QoS
        and lease-book knobs; None means the JAX package's defaults (QoS
        on; LeaseConfig() reads GUBER_LEASE_*).  advertise_address: the
        address the ring knows this node by (the tracer's node label).
        tracer: the span recorder; None builds one from GUBER_TRACE_SAMPLE
        and GUBER_TRACE_EXPORT.  health: the hinted handoff's knobs.
        peer_transport: host -> the transport of that peer's PeerClient
        (net/peers.py); None connects over gRPC.  devprof_mode: "" (off)
        or "periodic" (GUBER_DEVPROF), with the periodic controller's
        interval and drains (None: GUBER_DEVPROF_INTERVAL_S and
        GUBER_DEVPROF_DRAINS).  mesh: the parallel/distributed.py Mesh an
        engine built here runs on (each rank engine_config.num_shards
        shards).  mesh_peers: every mesh rank's gRPC address in rank order,
        which turns mesh serving on (the engine's mesh then spans the
        ranks)."""
        self.behaviors = behaviors or BehaviorConfig()
        self.behaviors.validate()
        if engine is None:
            e = engine_config or EngineConfig()
            engine = RateLimitEngine(
                capacity_per_shard=e.capacity_per_shard,
                batch_per_shard=e.batch_per_shard,
                num_shards=e.num_shards,
                global_capacity=e.global_capacity,
                global_batch_per_shard=e.global_batch_per_shard,
                max_global_updates=e.max_global_updates,
                replay_cap=e.replay_cap, device=device,
                use_native=e.use_native, exact_keys=e.exact_keys,
                mesh=mesh, skip_global=e.skip_global)
        self.engine = engine
        self.analytics: Optional[TrafficAnalytics] = None
        self.slo: Optional[SLOEngine] = None
        if analytics is not None and analytics.enabled:
            self.engine.enable_analytics(analytics)  # validates it
            self.analytics = TrafficAnalytics(analytics, metrics=metrics)
        if slo is not None and slo.enabled:
            slo.validate()
            self.slo = SLOEngine(slo)
        if tiers is not None and tiers.enabled:
            tiers.validate()
            self.engine.enable_tiers(tiers, analytics=self.analytics)
        self.metrics = metrics
        # QoS control plane (qos/): admission, congestion window, fair
        # slotting; None (QoSConfig(enabled=False)) keeps every path as
        # without QoS
        qconf = qos if qos is not None else QoSConfig()
        self.qos: Optional[QoSManager] = None
        if qconf.enabled:
            self.qos = QoSManager(qconf, metrics=metrics)
            # a shed is SLO evidence
            self.qos.admission.slo = self.slo
        # Concurrency-lease book (algorithms/leases.py): who holds which
        # CONCURRENCY slots, so a vanished client's can be released.  The
        # template map keeps how to rebuild a release request per key (the
        # book stores only hash keys).
        self.lease_conf = leases if leases is not None else LeaseConfig()
        self.lease_conf.validate()
        self.leases = LeaseBook()
        self._lease_tmpl: Dict[str, RateLimitReq] = {}
        # per-instance span recorder: each node's ring buffer is its own,
        # so a stitched trace is assembled by trace id across nodes
        self.tracer = tracer if tracer is not None else Tracer(
            node=advertise_address or "local")
        # mesh serving: windows tick on a clock every rank agrees on
        self.mesh_mode = mesh_peers is not None
        clock = None
        if self.mesh_mode:
            from gubernator_tpu_torch.parallel.distributed import (
                LockstepClock,
                agree_epoch_ms,
            )
            if self.engine.mesh is None:
                raise ValueError("mesh_peers needs an engine on a mesh")
            clock = LockstepClock(agree_epoch_ms(self.engine.mesh),
                                  self.behaviors.batch_wait)
        self.batcher = WindowBatcher(self.engine, self.behaviors,
                                     analytics=self.analytics, slo=self.slo,
                                     qos=self.qos, metrics=metrics,
                                     tracer=self.tracer,
                                     lockstep_clock=clock)
        self.health = HealthCheckResp(status=HEALTHY, peer_count=0)
        if metrics is not None:
            metrics.watch_engine(self.engine)
            if self.engine.tier_stats() is not None:
                metrics.watch_tiers(self.engine)
            if self.qos is not None:
                metrics.watch_qos(self.qos)
            metrics.watch_leases(self.leases)
            if self.analytics is not None or self.slo is not None:
                metrics.watch_analytics(self.analytics, self.slo)
        # the device-time flight recorder (observability/devprof.py): the
        # kernel table, the pipeline's window clock and, periodic, the
        # controller, sharing the batcher's armable capture
        eng = self.engine
        self.batcher.profile.windows_fn = lambda: int(eng.windows_processed)
        self.devprof = Devprof(
            mode=devprof_mode, metrics=metrics,
            profile=self.batcher.profile,
            windows_fn=lambda: int(eng.windows_processed),
            interval=devprof_interval_s, drains=devprof_drains)
        if self.batcher.pipeline is not None:
            self.devprof.clock = self.batcher.pipeline.devclock
        self.devprof.start()
        self.advertise_address = advertise_address
        self.peer_transport = peer_transport
        self.global_mgr = GlobalManager(self.behaviors, self, metrics, log,
                                        health=health)
        if self.mesh_mode:
            self._picker = MeshShardPicker.for_mesh(self.engine.mesh,
                                                    mesh_peers)
        else:
            self._picker = ConsistentHashRing()
        self.mesh_peers = list(mesh_peers) if mesh_peers else None
        # dynamic mesh GLOBAL registration (the reference accepts a GLOBAL
        # key on first use, global.go:62-68): rank 0 is the registrar that
        # orders registrations mesh-wide; in-flight registrations of a key
        # coalesce here, and the registrar keeps the keys whose two phases
        # completed on every rank (not its own global_ready: a partial
        # phase 2 leaves a key active here but pending elsewhere, and a
        # retry must run both phases again to heal that rank)
        self._greg_lock = asyncio.Lock()
        self._greg_inflight: Dict[str, asyncio.Future] = {}
        self._greg_done: set = set()
        # the failure detector watching this node's peers (net/health.py
        # HeartbeatMonitor), when the daemon runs one
        self.monitor = None
        # the multi-process front door serving this node (frontdoor.py
        # FrontdoorHub), when the daemon runs one
        self.frontdoor = None

    def census_arm(self) -> str:
        """The census arm this Instance serves through."""
        return ARM_ANALYTICS if self.analytics is not None else ARM_DRAIN

    def _publish_census(self):
        """Set guber_tpu_kernels_per_window from the census of this
        Instance's serving arm (observability/devprof.py census_table).
        The census runs on the engine thread, so that no serving launch
        lands in its count; returns that future (the daemon does not wait
        on it).  Best effort: observability never takes the service
        down."""
        eng = self.engine

        def publish():
            try:
                kpw = census_table(device=eng.device).get(self.census_arm())
                if kpw and self.metrics is not None:
                    self.metrics.kernels_per_window.set(kpw)
            except Exception:  # noqa: BLE001 - telemetry, not serving
                log.debug("census gauge publish failed", exc_info=True)

        return self.batcher._executor.submit(publish)

    @property
    def standalone(self) -> bool:
        """No peer ring: this node owns every key."""
        return not self.mesh_mode and self._picker.size() == 0

    def add_to_server(self, server, *, v1: bool = True,
                      peers: bool = True) -> None:
        """Register this instance's pb.gubernator.V1 and/or
        pb.gubernator.PeersV1 handlers on a caller-owned grpc.aio.Server
        (the reference's GRPCServers embedding hook, config.go:30-31).
        gRPC generic handlers match in registration order, so mounting the
        same service from two instances leaves the first one serving it."""
        # deferred imports: server.py imports this module, and the
        # serving core never loads grpc
        from gubernator_tpu_torch.api.grpc_api import (add_peers_servicer,
                                                       add_v1_servicer)
        from gubernator_tpu_torch.server import _PeersServicer, _V1Servicer

        if v1:
            add_v1_servicer(server, _V1Servicer(self))
        if peers:
            add_peers_servicer(server, _PeersServicer(self))

    async def get_rate_limits(self, requests: Sequence[RateLimitReq],
                              deadline: Optional[float] = None,
                              client_id: Optional[str] = None
                              ) -> List[RateLimitResp]:
        """deadline: absolute monotonic deadline from the transport (gRPC
        time_remaining(), the HTTP X-Guber-Timeout-Ms header); admission
        sheds what it cannot serve in time.  client_id: the caller's
        transport identity, to which the lease book attributes grants."""
        if len(requests) > MAX_BATCH_SIZE:
            raise BatchTooLargeError(
                f"Requests.RateLimits list too large; max size is "
                f"'{MAX_BATCH_SIZE}'")
        return list(await asyncio.gather(
            *(self._route(r, deadline, client_id=client_id)
              for r in requests)))

    async def _route(self, r: RateLimitReq,
                     deadline: Optional[float] = None,
                     client_id: Optional[str] = None) -> RateLimitResp:
        cap = self.lease_conf.max_per_client
        if (cap and r.algorithm == Algorithm.CONCURRENCY and r.hits > 0
                and self.leases.count(client_id or "anonymous",
                                      r.hash_key()) + r.hits > cap):
            # GUBER_LEASE_MAX_PER_CLIENT: answer on the host, before the
            # device spends a slot this client is not allowed to hold
            resp = RateLimitResp(status=Status.OVER_LIMIT, limit=r.limit,
                                 remaining=0, reset_time=0)
            self._account_decision(r, resp, client_id)
            return resp
        release = r.algorithm == Algorithm.CONCURRENCY and r.hits < 0
        if (r.algorithm == Algorithm.CONCURRENCY and client_id is not None
                and self.leases.holds(client_id, r.hash_key())):
            # a holder's re-touch shed on deadline would strand its held
            # slots until bucket expiry: undeadlined
            deadline = None
        # a lease release skips admission: shed, it would leave the slots
        # held on the card after the book dropped them (the JAX service
        # lifts only its deadline and sheds it when full or draining)
        resp = self._refusal(r)
        if resp is None:
            resp = await self._route_inner(r, deadline, admit=not release)
        self._account_decision(r, resp, client_id)
        return resp

    async def _route_inner(self, r: RateLimitReq,
                           deadline: Optional[float] = None,
                           admit: bool = True) -> RateLimitResp:
        """A validated request to its owner (JAX service.py _route_inner
        :385-446): decided here when the ring is empty or names this node;
        a non-owner's GLOBAL item from the replica; in mesh mode a GLOBAL
        item here, registered mesh-wide first when it is new; anything
        else forwarded through the owner's PeerClient."""
        if self._picker.size() == 0:
            return await self._local(r, deadline, admit)
        key = r.hash_key()
        if r.behavior == Behavior.GLOBAL and self.mesh_mode:
            # after each window's all-reduce every rank's replica is
            # authoritative: ownership does not matter
            try:
                if not self.engine.global_ready(key):
                    await self._ensure_global_registered(r)
                return await self.batcher.submit(r, deadline=deadline,
                                                 admit=admit)
            except Exception as e:
                # one item's failure must not fail the caller's batch
                return RateLimitResp(
                    error=f"while applying rate limit for '{key}' - '{e}'")
        try:
            peer = self._picker.get(key)
        except Exception as e:
            return RateLimitResp(
                error=f"while finding peer that owns rate limit '{key}' - "
                      f"'{e}'")
        if peer.is_owner:
            try:
                return await self._local(r, deadline, admit)
            except Exception as e:
                return RateLimitResp(
                    error=f"while applying rate limit for '{key}' - '{e}'")
        if r.behavior == Behavior.GLOBAL:
            try:
                return await self._global_nonowner(r)
            except Exception as e:
                return RateLimitResp(
                    error=f"while applying rate limit for '{key}' - '{e}'")
        # the forward hop is traced (peer_forward) and staged: the span's
        # context rides to the owner as traceparent metadata
        t0 = time.monotonic()
        if self.metrics is not None:
            self.metrics.cluster_forwarded.inc()
        try:
            with self.tracer.span("peer_forward") as span:
                span.set_attr("peer", peer.host)
                resp = await peer.get_peer_rate_limit(r)
        except BreakerOpenError:
            return await self._breaker_fallback(r, peer.host, deadline)
        except Exception as e:
            return RateLimitResp(
                error=f"while fetching rate limit '{key}' from peer - '{e}'")
        finally:
            if self.metrics is not None:
                self.metrics.observe_stage("peer_forward",
                                           time.monotonic() - t0)
        # tell the client who coordinates this key (gubernator.go:151)
        resp.metadata = dict(resp.metadata or {}, owner=peer.host)
        return resp

    async def _breaker_fallback(self, r: RateLimitReq, host: str,
                                deadline: Optional[float]) -> RateLimitResp:
        """The owner's circuit breaker is open.  fail_open: answer from the
        local engine, a non-authoritative decision flagged in metadata;
        fail_closed: shed in-band with reason breaker_open."""
        fail_open = (self.qos.fail_open if self.qos is not None
                     else QoSConfig().fail_open)
        if not fail_open:
            if self.qos is not None:
                self.qos.admission.record_shed(SHED_BREAKER_OPEN)
            return shed_response(r, SHED_BREAKER_OPEN)
        resp = await self._local(r, deadline)
        resp.metadata = dict(resp.metadata or {}, owner=host,
                             degraded="true", non_authoritative="true")
        if self.metrics is not None:
            self.metrics.fail_open_served.inc()
        return resp

    def _account_decision(self, r: RateLimitReq, resp: RateLimitResp,
                          client_id: Optional[str]) -> None:
        """Post-decision bookkeeping: the per-algorithm decision counter
        and the lease book."""
        if resp.error:
            return
        if self.metrics is not None:
            self.metrics.observe_algorithm(
                ALGORITHM_NAMES.get(int(r.algorithm), "token_bucket"))
        if r.algorithm != Algorithm.CONCURRENCY or r.hits == 0:
            return
        key = r.hash_key()
        client = client_id or "anonymous"
        if r.hits > 0:
            if resp.status == Status.UNDER_LIMIT:
                self._lease_tmpl[key] = r
                self.leases.acquire(key, client, r.hits,
                                    millisecond_now() + r.duration)
        else:
            self.leases.release(key, client, -r.hits)
            if self.metrics is not None:
                self.metrics.observe_lease_release("explicit", -r.hits)

    async def release_client_leases(self, client_id: str,
                                    reason: str = "stream_close") -> int:
        """Release every lease a vanished client holds: drop its book rows
        and push the matching negative-hits requests through the decision
        path, so the device's free-slot counters recover.  Returns the
        slots given back.  A key restored from a snapshot and not touched
        since has no template: its slots are left to device expiry."""
        rows = self.leases.release_client(client_id)
        total = 0
        for key, count in rows:
            tmpl = self._lease_tmpl.get(key)
            if tmpl is None:
                continue
            rel = RateLimitReq(
                name=tmpl.name, unique_key=tmpl.unique_key, hits=-count,
                limit=tmpl.limit, duration=tmpl.duration,
                algorithm=Algorithm.CONCURRENCY, behavior=tmpl.behavior)
            resp = self._refusal(rel)
            if resp is None:
                resp = await self._route_inner(rel, None, admit=False)
            if not resp.error:
                total += count
        if (total or rows) and self.metrics is not None:
            self.metrics.observe_lease_release(
                reason, sum(c for _, c in rows))
        return total

    def _refusal(self, r: RateLimitReq) -> Optional[RateLimitResp]:
        """The error answer to a request the service refuses, else None
        (a plain call, so an admitted item awaits one coroutine less)."""
        key = r.hash_key()
        # validation: exact reference strings and order (gubernator.go:102-110)
        if not r.unique_key:
            return RateLimitResp(error="field 'unique_key' cannot be empty")
        if not r.name:
            return RateLimitResp(error="field 'namespace' cannot be empty")
        if r.algorithm not in _ALGORITHMS:
            return RateLimitResp(error=(
                f"while applying rate limit for '{key}' - "
                f"'invalid rate limit algorithm '{r.algorithm}''"))
        if (r.behavior == Behavior.GLOBAL
                and r.algorithm not in (Algorithm.TOKEN_BUCKET,
                                        Algorithm.LEAKY_BUCKET)):
            # the JAX package's GLOBAL kernel replicates only the token and
            # leaky ladders, so its service refuses the others; the port
            # keeps the same contract and string
            return RateLimitResp(error=(
                f"while applying rate limit for '{key}' - "
                f"'GLOBAL behavior does not support algorithm "
                f"'{r.algorithm}''"))
        return None

    async def release_peer_leases(self, host: str) -> int:
        """Peer-death hook, called by the failure detector when it confirms
        `host` down (net/health.py): grants are attributed to the
        forwarding peer's source address, so a departed peer's clients get
        their slots back here (JAX service.py:344)."""
        ip = host.rsplit(":", 1)[0]
        total = 0
        for client in (host, ip):
            if self.leases.holds(client):
                total += await self.release_client_leases(
                    client, reason="peer_down")
        return total

    async def _local(self, r: RateLimitReq,
                     deadline: Optional[float] = None,
                     admit: bool = True) -> RateLimitResp:
        """Owner-side decision through the device engine (the reference's
        getRateLimit under the cache mutex, gubernator.go:236-251)."""
        if (r.behavior == Behavior.GLOBAL and self._picker.size() > 0
                and not self.mesh_mode):
            # the owner saw a GLOBAL change: schedule an authoritative
            # broadcast (gubernator.go:240-242); a mesh reconciles through
            # its all-reduce instead
            self.global_mgr.queue_update(r)
        if r.behavior == Behavior.NO_BATCHING:
            # not gated by admission: NO_BATCHING jumps the window and
            # keeps working while the batched lane saturates
            return (await self.batcher.submit_now([r]))[0]
        return await self.batcher.submit(r, deadline=deadline, admit=admit)

    async def _global_nonowner(self, r: RateLimitReq) -> RateLimitResp:
        """Non-owner GLOBAL: answer from the local replica and reconcile
        the hits with the owner asynchronously (gubernator.go:173-195):
        the window reads the replica without adding the hits to the
        per-slot sum or writing the request's config."""
        self.global_mgr.queue_hit(r)
        return await self.batcher.submit(r, accumulate=False)

    async def get_peer_rate_limits(self, requests: Sequence[RateLimitReq],
                                   client_id: Optional[str] = None
                                   ) -> List[RateLimitResp]:
        """Batch relay from a peer; this node is authoritative for every
        key (gubernator.go:210-227).  In a ring a GLOBAL item's change is
        queued for the owner's broadcast; standalone there is no replica to
        tell, and the item is decided locally like the rest."""
        if len(requests) > MAX_BATCH_SIZE:
            raise BatchTooLargeError(
                f"'PeerRequest.rate_limits' list too large; max size is "
                f"'{MAX_BATCH_SIZE}'")
        valid: List[RateLimitReq] = []
        slots: List[int] = []
        out: List[Optional[RateLimitResp]] = [None] * len(requests)
        for i, r in enumerate(requests):
            if r.algorithm not in _ALGORITHMS:
                out[i] = RateLimitResp(
                    error=f"invalid rate limit algorithm '{r.algorithm}'")
                continue
            if (r.behavior == Behavior.GLOBAL and self._picker.size() > 0
                    and not self.mesh_mode):
                self.global_mgr.queue_update(r)
            valid.append(r)
            slots.append(i)
        if valid:
            resps = await self.batcher.submit_now(valid)
            for i, resp in zip(slots, resps):
                out[i] = resp
                # leases acquired over the peer lane attribute to the
                # forwarding peer
                self._account_decision(requests[i], resp, client_id)
        return [o if o is not None else RateLimitResp() for o in out]

    async def update_peer_globals(self, globals_: Sequence) -> None:
        """The owner pushed authoritative GLOBAL statuses: upsert the
        replicas (gubernator.go:199-207) on the engine thread."""
        await self.batcher.apply_upserts(list(globals_))

    async def read_global_status(self, probe: RateLimitReq) -> RateLimitResp:
        """The authoritative hits=0 read of the broadcast loop
        (global.go:199-203).  A per-item failure raises, so the broadcast
        skips the key instead of pushing a zeroed status."""
        resp = (await self.batcher.submit_now([probe]))[0]
        if resp.error:
            raise RuntimeError(resp.error)
        return resp

    async def health_check(self) -> HealthCheckResp:
        """A rank whose lockstep batcher fail-stopped, a draining node, or
        one whose admission queue is pinned at its cap, cannot take work,
        whatever the ring looked like."""
        if self.batcher._ended is not None:
            # a fail-stopped rank, or one past the mesh's agreed final tick
            return HealthCheckResp(
                status=UNHEALTHY, message=str(self.batcher._ended),
                peer_count=self.health.peer_count)
        if self.qos is not None and self.qos.admission.draining:
            return HealthCheckResp(
                status=UNHEALTHY,
                message="draining: node is departing the ring",
                peer_count=self.health.peer_count)
        if self.qos is not None and self.qos.admission.saturated:
            return HealthCheckResp(
                status=UNHEALTHY,
                message=(f"admission queue saturated "
                         f"({self.qos.admission.pending} pending, "
                         f"cap {self.qos.admission.max_pending})"),
                peer_count=self.health.peer_count)
        return self.health

    async def drain(self, timeout: float = 5.0,
                    now_fn=time.monotonic, sleep=asyncio.sleep) -> bool:
        """Graceful-departure phase: close admission intake (new work is
        shed in-band with reason `draining`), then wait, at most `timeout`
        seconds, until no admitted decision is pending and no request is
        queued or in flight in the pipeline or the classic lane.  True
        when it emptied in time."""
        if self.qos is not None:
            self.qos.admission.close_intake()
        deadline = now_fn() + timeout
        while ((self.qos is not None and self.qos.admission.pending > 0)
               or self.batcher.busy()):
            if now_fn() >= deadline:
                if self.qos is not None:
                    log.warning("drain: %d decisions still pending at "
                                "timeout", self.qos.admission.pending)
                return False
            await sleep(0.01)
        return True

    # --------------------------------------------- dynamic mesh GLOBAL keys

    async def _ensure_global_registered(self, r: RateLimitReq) -> None:
        """Register a first-seen GLOBAL key mesh-wide through the registrar
        (rank 0) and wait until it is servable here.  Concurrent first
        sights of one key coalesce into one RPC."""
        key = r.hash_key()
        fut = self._greg_inflight.get(key)
        if fut is not None:
            await fut
            return
        fut = asyncio.get_running_loop().create_future()
        self._greg_inflight[key] = fut
        try:
            registrar = self._picker.get_by_host(self.mesh_peers[0])
            if registrar is None:
                raise RuntimeError("mesh registrar peer is not connected")
            await registrar.register_globals(
                [(key, r.limit, r.duration, int(r.algorithm))])
            fut.set_result(None)
        except Exception as e:
            fut.set_exception(e)
            # a waiter that came meanwhile sees the error; retrieve it so
            # an unawaited future logs nothing
            fut.exception()
            raise
        finally:
            self._greg_inflight.pop(key, None)

    async def register_globals(self, specs) -> None:
        """The registrar's endpoint (rank 0): order dynamic GLOBAL
        registrations and apply them on every rank in two phases.  Phase 1
        configures the keys everywhere (no collective: each rank at its own
        time, the same batches and `now`); phase 2 activates them only
        after every rank confirmed phase 1, so no rank adds hits to a slot
        a replica has not configured."""
        if not self.mesh_mode:
            raise RuntimeError("RegisterGlobals is a mesh-mode RPC")
        async with self._greg_lock:
            todo = list({sp[0]: sp for sp in specs
                         if sp[0] not in self._greg_done}.values())
            if not todo:
                return
            now = millisecond_now()
            peers = [self._picker.get_by_host(h) for h in self.mesh_peers]
            if any(p is None for p in peers):
                raise RuntimeError("mesh peers not all connected; cannot "
                                   "register GLOBAL keys")
            await asyncio.gather(*(
                p.apply_global_registration(todo, now, False) for p in peers))
            await asyncio.gather(*(
                p.apply_global_registration(todo, now, True) for p in peers))
            self._greg_done.update(sp[0] for sp in todo)

    async def apply_global_registration(self, specs, now: int,
                                        activate: bool) -> None:
        """One registration phase on this rank (the registrar's fan-out),
        on the engine thread, in turn with its windows."""
        if activate:
            keys = [sp[0] for sp in specs]
            await self._quiesced(
                lambda: self.engine.activate_global_keys(keys))
        else:
            await self._quiesced(
                lambda: self.engine.register_global_keys(
                    specs, now=now, pending=True))

    # ------------------------------------------------------------ membership

    def get_peer(self, key: str) -> PeerClient:
        return self._picker.get(key)

    def peer_list(self) -> List[PeerClient]:
        return self._picker.peers()

    async def set_peers(self, peers: Sequence[PeerInfo]) -> None:
        """Rebuild the ring on a membership change (gubernator.go:254-292,
        JAX service.py:676-729), closing the clients of departed hosts
        (the reference leaks them, :276 TODO)."""
        picker = self._picker.new()
        errs: List[str] = []
        for info in peers:
            client = self._picker.get_by_host(info.address)
            if client is None:
                try:
                    transport = (self.peer_transport(info.address)
                                 if self.peer_transport is not None
                                 else None)
                    client = PeerClient(self.behaviors, info.address,
                                        qos=self.qos, transport=transport)
                except Exception:
                    errs.append(
                        f"failed to connect to peer '{info.address}'; "
                        f"consistent hash is incomplete")
                    continue
            client.is_owner = info.is_owner
            picker.add(info.address, client)

        old_hosts = {p.host for p in self._picker.peers()}
        new_hosts = {p.host for p in picker.peers()}
        departed = [self._picker.get_by_host(h) for h in old_hosts - new_hosts]
        # close the raw-RPC lane across the swap: a drain between the
        # picker swap and the ring install would otherwise classify
        # against the stale ring and decide keys this node no longer owns;
        # _sync_pipeline_ring opens it once the new ring is installed on
        # the engine thread
        if self.batcher.pipeline is not None:
            self.batcher.pipeline.rpc_enabled = False
        self._picker = picker
        if self.metrics is not None:
            self.metrics.cluster_peers.set(picker.size())
        self.health = HealthCheckResp(
            status=UNHEALTHY if errs else HEALTHY,
            message="|".join(errs),
            peer_count=picker.size(),
        )
        await self._sync_pipeline_ring()
        if not self.mesh_mode:
            # a mesh replicates GLOBAL state through its all-reduce; the
            # gRPC hit and broadcast loops stay off
            self.global_mgr.start()
        log.info("Peers updated: %s", [p.address for p in peers])
        for client in departed:
            if client is not None:
                await client.close()

    async def _sync_pipeline_ring(self) -> None:
        """Keep the raw-RPC lane's view of the cluster equal to the
        picker's: standalone an empty ring (everything local); in a
        cluster the consistent-hash table, so the C parser classifies each
        item local or forward.  The install runs on the engine thread,
        in turn with the drains."""
        pipe = self.batcher.pipeline
        if pipe is None or not pipe.enabled:
            return
        if self.mesh_mode:
            # the mesh routes by shard, not by ring: the lane stays shut
            pipe.rpc_enabled = False
            return
        import numpy as np
        loop = asyncio.get_running_loop()
        if self._picker.size() == 0:
            await loop.run_in_executor(
                self.batcher._executor, pipe.install_ring,
                np.empty(0, np.uint32), np.empty(0, np.int32), (), -1)
            pipe.rpc_enabled = True
            return
        points, peers = self._picker.ring_table()
        self_idx = next(
            (i for i, p in enumerate(peers) if getattr(p, "is_owner", False)),
            -1)
        if self_idx < 0:
            # this node is not on the ring: the lane cannot classify
            pipe.rpc_enabled = False
            return
        await loop.run_in_executor(
            self.batcher._executor, pipe.install_ring,
            np.asarray(points, np.uint32),
            np.arange(len(points), dtype=np.int32), tuple(peers), self_idx)
        pipe.rpc_enabled = True

    # ------------------------------------------------------- self-healing

    async def rehome(self, hosts: Sequence[str],
                     direction: str = "down") -> None:
        """Rebuild the ring around the given membership (the failure
        detector's view) and migrate the re-homed resident keys.  The
        detector calls this with the membership minus a confirmed-down
        peer (its key space spreads over the survivors, where its own
        state restarts cold; the hint buffer holds the GLOBAL hits meant
        for it) or plus a recovered one.  A failed migration leaves the
        new ring in place: serving with cold keys beats refusing to
        re-home."""
        old_hosts = [p.host for p in self.peer_list()]
        new_hosts = sorted(set(hosts))
        if sorted(old_hosts) == new_hosts:
            return
        await self.set_peers([
            PeerInfo(address=h, is_owner=(h == self.advertise_address))
            for h in new_hosts])
        try:
            await self.migrate_keys(old_hosts, new_hosts)
        except Exception as e:
            log.error("rehome: migration failed (keys restart cold): %s", e)
        if self.metrics is not None:
            self.metrics.observe_rehome(direction)
        log.warning("ring re-homed (%s): %s -> %s", direction,
                    sorted(old_hosts), new_hosts)

    def on_peer_recovered(self, host: str) -> int:
        """Detector callback: the peer answers probes again, so its hinted
        GLOBAL payloads replay (their owners resolved at replay time)."""
        return self.global_mgr.replay_hints(host)

    # --------------------------------------------------------- migration

    async def transfer_buckets(self, payload: bytes) -> bytes:
        """The receiving side of live migration: import the shipped rows,
        never over a fresher local entry (engine.import_rows /
        import_global_rows, on the engine thread), and re-register the
        lease rows that came with them, with their request templates.
        Returns state/migrate.py's ack bytes."""
        regular, global_, leases = migrate.decode_rows(payload)
        now = millisecond_now()
        imp = sk = gimp = gsk = 0
        if regular:
            imp, sk = await self._quiesced(
                lambda: self.engine.import_rows(regular, now=now))
        if global_:
            gimp, gsk = await self._quiesced(
                lambda: self.engine.import_global_rows(global_, now=now))
        if leases:
            # the device's free-slot counters arrived with the arena rows
            self.leases.import_rows((r[0], r[1], r[2], r[3]) for r in leases)
            for r in leases:
                if len(r) >= 8 and r[4]:
                    self._lease_tmpl[r[0]] = RateLimitReq(
                        name=str(r[4]), unique_key=str(r[5]),
                        limit=int(r[6]), duration=int(r[7]),
                        algorithm=Algorithm.CONCURRENCY)
            log.info("migration import: %d lease rows re-registered",
                     len(leases))
        if self.metrics is not None:
            self.metrics.observe_migration(imported=imp + gimp,
                                           skipped_stale=sk + gsk)
        if imp or gimp or sk or gsk:
            log.info("migration import: %d rows (+%d GLOBAL), "
                     "%d stale skipped", imp, gimp, sk + gsk)
        return migrate.encode_ack(imp, sk, gimp, gsk)

    async def migrate_keys(self, old_hosts: Sequence[str],
                           new_hosts: Sequence[str]) -> dict:
        """The sending side of live migration, run after set_peers
        installed the new ring: diff the ownership of the keys resident
        here from the old membership to the new one, ship each re-homed
        key's live row to its new owner, then drop the moved regular keys
        here.  GLOBAL keys re-register on their new owner and keep their
        replica here (every node serves GLOBAL reads).  Returns {"moved",
        "gmoved", "imported", "skipped_stale"} totals."""
        keys = await self._quiesced(self.engine.local_keys)
        gkeys = await self._quiesced(self.engine.global_keys)
        moved = migrate.ownership_diff(keys, old_hosts, new_hosts)
        gmoved = migrate.ownership_diff(gkeys, old_hosts, new_hosts)
        # keys this node no longer owns move OUT; a key re-homed TO this
        # node is another node's export
        self_host = self.advertise_address
        totals = {"moved": 0, "gmoved": 0, "imported": 0, "skipped_stale": 0}
        for dest in sorted(set(moved) | set(gmoved)):
            if dest == self_host:
                continue
            dkeys = moved.get(dest, [])
            dgkeys = gmoved.get(dest, [])
            rows = await self._quiesced(
                lambda ks=dkeys: self.engine.export_rows(ks))
            grows = await self._quiesced(
                lambda ks=dgkeys: self.engine.export_global_rows(ks))
            lrows = []
            for key, client, count, expire in self.leases.export_rows(dkeys):
                tmpl = self._lease_tmpl.get(key)
                lrows.append([key, client, count, expire]
                             + ([tmpl.name, tmpl.unique_key, tmpl.limit,
                                 tmpl.duration] if tmpl is not None
                                else ["", "", 0, 0]))
            peer = self._picker.get_by_host(dest)
            if peer is None:
                log.warning("migration: new owner %s not connected; "
                            "%d keys restart cold there", dest,
                            len(dkeys) + len(dgkeys))
                continue
            ack = migrate.decode_ack(await peer.transfer_buckets(
                migrate.encode_rows(rows, grows, lrows)))
            # the moved regular keys leave the tables either way: the new
            # owner is authoritative now (a stale skip means it already
            # held a fresher row), and routing no longer sends them here
            await self._quiesced(
                lambda ks=dkeys: self.engine.remove_keys(ks))
            self.leases.drop_keys(dkeys)
            totals["moved"] += len(dkeys)
            totals["gmoved"] += len(dgkeys)
            totals["imported"] += ack["imported"] + ack["gimported"]
            totals["skipped_stale"] += (ack["skipped_stale"]
                                        + ack["gskipped_stale"])
        if self.metrics is not None:
            self.metrics.observe_migration(
                moved=totals["moved"] + totals["gmoved"])
        if totals["moved"] or totals["gmoved"]:
            log.info("migration out: %s", totals)
        return totals

    # ------------------------------------------------------ state lifecycle

    async def _quiesced(self, fn):
        """Run engine-mutating work on the batcher's one engine thread
        (JAX service.py:780): serialized with every window of the classic
        lane and every drain the pipeline packs and launches there, so it
        sees the arenas and the router's tables at one drain boundary.  A
        device read there waits, in stream order, for the drains already
        launched; nothing the pipeline still holds (jobs left over to its
        next drain, fetches in flight) names a slot."""
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self.batcher._executor, fn)

    async def export_snapshot(self, layout: str = "auto", now=None):
        """The engine's export (state/snapshot.py ArenaSnapshot) at the
        quiesce point, with the lease book's rows."""
        snap = await self._quiesced(
            lambda: self.engine.export_state(now=now, layout=layout))
        snap.leases = self.leases.export_rows()
        return snap

    async def save_snapshot(self, path: str, layout: str = "auto",
                            now=None) -> int:
        """Export, then an atomic write; returns the bytes written.  The
        quiesce covers only the export: serializing and writing run off
        the engine thread.  `now`: the snapshot's stamp (in mesh mode the
        agreed time of the tick it is taken at, engine.export_state)."""
        start = time.monotonic()
        snap = await self.export_snapshot(layout, now=now)
        size = snapmod.save(snap, path)
        if self.metrics is not None:
            self.metrics.observe_snapshot(time.monotonic() - start, size,
                                          ok=True)
        log.info("snapshot: %d keys, %d bytes -> %s", snap.total_keys(),
                 size, path)
        return size

    async def export_snapshot_bytes(self, layout: str = "auto") -> bytes:
        return snapmod.dumps(await self.export_snapshot(layout))

    async def restore_snapshot_bytes(self, data: bytes,
                                     rebase_to=None) -> int:
        """Parse, then import at the quiesce point; returns the keys
        restored.  Raises SnapshotError on a bad blob (a boot restore
        degrades to a cold start; an admin restore reports the failure)."""
        snap = snapmod.loads(data)
        await self._quiesced(lambda: self.restore_snapshot(snap, rebase_to))
        return snap.total_keys()

    def restore_snapshot(self, snap, rebase_to=None) -> None:
        """engine.import_state, then what the Instance keeps beside the
        arena (engine thread): the lease rows merge into the book (a
        restored key has no release template until it is touched again,
        so `release_client_leases` leaves its slots to device expiry), and
        the analytics' slot labels are forgotten (the slots now hold the
        snapshot's keys)."""
        self.engine.import_state(snap, rebase_to=rebase_to)
        if snap.leases:
            self.leases.import_rows(snap.leases)
        if self.analytics is not None:
            self.analytics.forget_labels()

    async def aclose(self) -> None:
        """Flush the GLOBAL manager first (a clean shutdown must not drop
        queued aggregated hits or broadcasts), then close."""
        try:
            await self.global_mgr.flush()
        except Exception as e:
            log.error("global flush on close failed: %s", e)
        self.close()

    def close(self) -> None:
        self.global_mgr.stop()
        self.devprof.close()
        self.batcher.close()
