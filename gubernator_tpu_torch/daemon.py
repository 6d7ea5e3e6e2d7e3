"""Server daemon: the standalone composition root.

The port of `gubernator_tpu/daemon.py` for one node: env config, the
Instance (with a Metrics registry) on GUBER_TORCH_DEVICE (default `cuda`;
it raises without a card unless `cpu` is asked for), `engine.warmup()`,
the gRPC server, the HTTP gateway with /metrics, and a graceful stop on
SIGINT/SIGTERM.  Run as `python -m gubernator_tpu_torch.daemon` (flags:
--config <env-file>, --debug, the reference's only two flags,
cmd/gubernator/config.go:63-66).  It needs grpcio, protobuf, aiohttp and
prometheus_client.

With GUBER_SNAPSHOT_DIR set it restores the arenas from
`<dir>/arena.snap` before it serves (a missing or corrupt file is a logged
cold start), saves every GUBER_SNAPSHOT_INTERVAL_MS, and saves once more
in the stop sequence, after the drain; a restored snapshot's lease rows go
back into the lease book.  GUBER_TIER_WARM > 0 puts the warm tier on the
engine (and forces the Python routing tables).  QoS runs at the JAX
package's defaults (GUBER_QOS_*), and every GUBER_LEASE_SWEEP_MS the
lease sweep drops expired grants from the book.

The peer ring: GUBER_STATIC_PEERS (comma-separated gRPC addresses, this
node's GUBER_ADVERTISE_ADDRESS among them, default its gRPC address) is
pushed once through discovery/static.py StaticPool into
`Instance.set_peers`; keys then forward to their consistent-hash owners
and GLOBAL limits sync through the GLOBAL manager.  A static pool has no
discovery backend to drop a dead peer, so with GUBER_HEARTBEAT_ENABLED
(the default) the daemon runs the heartbeat failure detector
(net/health.py, GUBER_HEARTBEAT_*): a peer confirmed down is re-homed
around, and one confirmed up again re-homed back with its GLOBAL hints
replayed.  The graceful stop runs the JAX daemon's phases in order, each
bounded and none skipped because an earlier one failed: monitor_stop,
drain, global_flush, handoff (every key this node owns shipped to the
surviving ring, Instance.migrate_keys, which needs the Python slot
tables: with the native router it fails, is logged, and the survivors
restart those keys cold) or handoff_skipped (no survivor), snapshot,
teardown.  GUBER_FAULTS / GUBER_FAULTS_SEED install fault rules at boot
(net/faults.py) on the seams peer_rpc, snapshot_io and engine_dispatch.

Discovery: GUBER_K8S_NAMESPACE builds discovery/kubernetes.py K8sPool and
GUBER_ETCD_ENDPOINTS discovery/etcd.py EtcdPool (with TLS from
GUBER_ETCD_TLS_*) in place of the static pool, in the JAX daemon's order
(Kubernetes, etcd, static).  Those pools watch membership themselves, so
the heartbeat detector runs only beside a static pool, as in the JAX
daemon.

The front door: GUBER_FRONTDOOR_WORKERS=N > 0 starts frontdoor.py's
FrontdoorHub in place of the in-process gRPC server: N worker processes
share GUBER_GRPC_ADDRESS's port and hand their records to this process
over shared-memory rings (GUBER_SHM_RING_SLOTS, GUBER_SHM_SLAB_BYTES,
GUBER_FRONTDOOR_ENCODE, GUBER_FRONTDOOR_BATCH_READS).  The drain phase
starts by setting its draining flag (the workers shed in-band from then
on), and the hub stops after the handoff, before the snapshot, so the
snapshot holds the last decision served.

Device profiling: GUBER_DEVPROF=periodic runs the periodic capture
controller (observability/devprof.py, GUBER_DEVPROF_INTERVAL_S, _DRAINS),
which stops with the drain phase, before the snapshot; POST
/v1/admin/profile and GET /v1/admin/kernels are on the HTTP gateway.  At
boot the daemon publishes guber_tpu_kernels_per_window from the census
of its serving arm, on the engine thread and without waiting for it.
Mesh serving (JAX daemon.py:100-233): GUBER_MESH_COORDINATOR (with
GUBER_MESH_NUM_PROCESSES and GUBER_MESH_PROCESS_ID) joins this process to
the mesh's torch.distributed group (parallel/distributed.py; the backend
follows from where the ranks run) before anything touches the device, and
GUBER_MESH_PEERS must list every rank's gRPC address in rank order.  Each
rank holds EngineConfig.num_shards shards on its device (a bare `cuda`
names card rank % cards).  Then: the warm-up at the agreed epoch and the
lockstep stack (every rank together: its GLOBAL windows are all-reduces);
GUBER_GLOBAL_KEYS_FILE (JSON lines of key, limit, duration, algorithm)
registered on every rank at that epoch; this rank's own snapshot file
restored (arena-r<shard offset>.snap) only when every rank's file holds
the same agreed tick and GLOBAL part, else every rank starts cold
(state/snapshot.py restore_mesh_engine); periodic snapshots taken by the
tick loop after the same ticks on every rank (every
GUBER_SNAPSHOT_INTERVAL_MS of ticks), each stamped with its tick's agreed
time; GUBER_FRONTDOOR_WORKERS ignored with a warning (the ticks own the
loop); a static pool over the fixed
membership (no discovery backend, no heartbeat detector); and the tick
loop.  The stop adds a phase after the drain, lockstep_stop: the ranks
agree on a final tick through the group's store and this rank's loop ends
there.  The handoff is skipped (a mesh does not move keys between ranks),
and teardown leaves the group.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
from typing import Optional

from gubernator_tpu_torch.api.http_gateway import HttpGateway
from gubernator_tpu_torch.api.types import millisecond_now
from gubernator_tpu_torch.config import DaemonConfig, config_from_env
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.discovery.static import StaticPool
from gubernator_tpu_torch.net.faults import FAULTS
from gubernator_tpu_torch.net.health import HeartbeatMonitor
from gubernator_tpu_torch.observability.metrics import Metrics
from gubernator_tpu_torch.observability.tracing import Tracer
from gubernator_tpu_torch.parallel import distributed
from gubernator_tpu_torch.server import GrpcServer
from gubernator_tpu_torch.state import snapshot as snapmod

log = logging.getLogger("gubernator.daemon")


class Daemon:
    def __init__(self, conf: DaemonConfig):
        self.conf = conf
        self.instance: Optional[Instance] = None
        self.grpc: Optional[GrpcServer] = None
        self.http: Optional[HttpGateway] = None
        # the discovery pool: StaticPool, K8sPool or EtcdPool
        self.pool = None
        # frontdoor.py FrontdoorHub (GUBER_FRONTDOOR_WORKERS > 0)
        self.frontdoor = None
        # net/health.py HeartbeatMonitor (static pools)
        self.monitor: Optional[HeartbeatMonitor] = None
        # phase names appended as stop() runs them, in order: the JAX
        # daemon's shutdown contract
        self.shutdown_phases: list = []
        self._snapshot_task: Optional[asyncio.Task] = None
        # mesh mode's periodic snapshots ride the tick loop (its hook)
        self._tick_snapshots = False
        self._lease_sweep_task: Optional[asyncio.Task] = None

    def _snapshot_file(self) -> str:
        eng = self.instance.engine
        return snapmod.snapshot_path(self.conf.snapshot_dir,
                                     eng.local_shard_offset,
                                     eng.multiprocess)

    async def _snapshot_once(self, now=None) -> None:
        """One save; `now`: a mesh rank's agreed tick time (else the
        engine's clock stamps it)."""
        kw = {} if now is None else {"now": now}
        try:
            await self.instance.save_snapshot(self._snapshot_file(), **kw)
        except Exception:
            self.instance.metrics.observe_snapshot(0.0, 0, ok=False)
            log.exception("periodic snapshot failed")

    async def _snapshot_loop(self) -> None:
        interval = self.conf.snapshot_interval_ms / 1000.0
        while True:
            await asyncio.sleep(interval)
            await self._snapshot_once()

    async def _lease_sweep_loop(self, interval_ms: int) -> None:
        """Drop expired grants from the lease book every interval
        (GUBER_LEASE_SWEEP_MS).  The device buckets already expired, so
        this only keeps the lease gauges and per-client holds honest."""
        while True:
            await asyncio.sleep(interval_ms / 1000.0)
            try:
                dropped = self.instance.leases.sweep(millisecond_now())
                if dropped:
                    self.instance.metrics.observe_lease_release(
                        "expired", sum(c for _, _, c in dropped))
            except Exception:
                log.exception("lease sweep failed")

    async def start(self) -> None:
        c = self.conf
        # mesh mode: join the group before anything touches the device
        mesh = mesh_peers = None
        device = c.device
        if distributed.initialize_from_env(c.device):
            mesh = distributed.global_mesh(c.engine.num_shards)
            device = distributed.rank_device(c.device, mesh.rank)
            mesh_peers = [a.strip() for a in os.environ.get(
                "GUBER_MESH_PEERS", "").split(",") if a.strip()]
            if not mesh_peers:
                raise ValueError(
                    "mesh mode requires GUBER_MESH_PEERS (gRPC addresses in "
                    "process-rank order)")
            if len(mesh_peers) != mesh.world_size:
                raise ValueError(
                    f"GUBER_MESH_PEERS lists {len(mesh_peers)} addresses but "
                    f"the mesh has {mesh.world_size} processes; the list "
                    "must name every process, in rank order")
            log.info("mesh mode: %d processes, %d global shards",
                     mesh.world_size, mesh.num_shards)
        # fault injection (net/faults.py): GUBER_FAULTS is read once here;
        # a rule on an unknown seam raises before anything is built
        FAULTS.load_from_env()
        self.instance = Instance(
            engine_config=c.engine, behaviors=c.behaviors, device=device,
            analytics=c.analytics, slo=c.slo, metrics=Metrics(),
            tiers=c.tiers, qos=c.qos, leases=c.leases,
            advertise_address=c.advertise_address, health=c.health,
            tracer=Tracer(sample=c.trace_sample, export=c.trace_export,
                          node=c.advertise_address or "local"),
            devprof_mode=c.devprof_mode,
            devprof_interval_s=c.devprof_interval_s,
            devprof_drains=c.devprof_drains,
            mesh=mesh, mesh_peers=mesh_peers)
        eng = self.instance.engine
        if mesh_peers is not None:
            # every rank warms up together, at the agreed epoch and the
            # tick's stack depth
            epoch = self.instance.batcher.clock.epoch_ms
            eng.warmup(now=epoch, k_stack=c.behaviors.lockstep_stack)
            gk_file = os.environ.get("GUBER_GLOBAL_KEYS_FILE", "")
            if gk_file:
                import json
                with open(gk_file) as f:
                    specs = [(d["key"], d["limit"], d["duration"],
                              d.get("algorithm", 0))
                             for d in (json.loads(ln) for ln in f
                                       if ln.strip())]
                eng.register_global_keys(specs, now=epoch)
                log.info("registered %d GLOBAL keys", len(specs))
        else:
            # launch every drain shape before accepting traffic
            eng.warmup()
        # the kernel census gauge, off the boot path: queued on the engine
        # thread, not waited for
        self.instance._publish_census()
        if c.snapshot_dir:
            # restore BEFORE serving, on the engine thread; a missing or
            # corrupt snapshot is a cold start, never a failed boot
            os.makedirs(c.snapshot_dir, exist_ok=True)
            inst = self.instance
            restore = (snapmod.restore_mesh_engine if inst.mesh_mode
                       else snapmod.restore_engine)
            snap = await inst._quiesced(
                lambda: restore(inst.engine, self._snapshot_file(),
                                metrics=inst.metrics))
            if snap is not None and snap.leases:
                # the device free-slot counters came back with the planes
                inst.leases.import_rows(snap.leases)
            if inst.mesh_mode:
                # every rank saves after the same ticks, stamped with the
                # tick's agreed time
                b = inst.batcher
                b.snapshot_every = max(1, round(
                    c.snapshot_interval_ms / 1000.0 / c.behaviors.batch_wait))
                b.on_tick_snapshot = self._snapshot_once
                self._tick_snapshots = True
            else:
                self._snapshot_task = asyncio.create_task(
                    self._snapshot_loop())
            log.info("snapshots -> %s every %dms", c.snapshot_dir,
                     c.snapshot_interval_ms)
        if c.leases.sweep_interval_ms > 0:
            self._lease_sweep_task = asyncio.create_task(
                self._lease_sweep_loop(c.leases.sweep_interval_ms))
        if c.frontdoor_workers > 0 and self.instance.mesh_mode:
            log.warning("GUBER_FRONTDOOR_WORKERS ignored in mesh mode")
        if c.frontdoor_workers > 0 and not self.instance.mesh_mode:
            # the multi-process front door: the workers share the gRPC
            # port; this process binds no public gRPC port of its own
            from gubernator_tpu_torch.frontdoor import FrontdoorHub
            self.frontdoor = FrontdoorHub(
                self.instance, workers=c.frontdoor_workers,
                ring_slots=c.shm_ring_slots, slab_bytes=c.shm_slab_bytes,
                listen_address=c.grpc_listen_address,
                encode=c.frontdoor_encode,
                batch_reads=c.frontdoor_batch_reads)
            await self.frontdoor.start()
            self.instance.frontdoor = self.frontdoor
            self.instance.metrics.watch_frontdoor(self.frontdoor)
            log.info("frontdoor: %d workers on %s (engine pid %d)",
                     c.frontdoor_workers, self.frontdoor.address,
                     os.getpid())
        else:
            self.grpc = GrpcServer(self.instance, c.grpc_listen_address)
            await self.grpc.start()
            log.info("gRPC listening on %s", self.grpc.address)
        if mesh_peers is not None:
            # membership is fixed by rank: no discovery backend applies
            # (elasticity is re-forming the group)
            self.pool = StaticPool(addresses=mesh_peers,
                                   advertise_address=c.advertise_address,
                                   on_update=self.instance.set_peers)
            await self.pool.start()
            self.instance.batcher.start_lockstep()
        elif c.k8s_enabled:
            from gubernator_tpu_torch.discovery.kubernetes import K8sPool
            self.pool = K8sPool(
                namespace=c.k8s_namespace, pod_ip=c.k8s_pod_ip,
                pod_port=c.k8s_pod_port, selector=c.k8s_endpoints_selector,
                on_update=self.instance.set_peers)
            await self.pool.start()
        elif c.etcd_enabled:
            from gubernator_tpu_torch.discovery.etcd import EtcdPool
            self.pool = EtcdPool(
                endpoints=c.etcd_addresses,
                advertise_address=c.advertise_address,
                on_update=self.instance.set_peers,
                prefix=c.etcd_prefix, username=c.etcd_username,
                password=c.etcd_password,
                ssl_context=c.etcd_ssl_context())
            await self.pool.start()
        elif c.static_peers:
            self.pool = StaticPool(addresses=c.static_peers,
                                   advertise_address=c.advertise_address,
                                   on_update=self.instance.set_peers)
            await self.pool.start()
            log.info("static peers: %s (this node %s)", c.static_peers,
                     c.advertise_address)
            # a static pool has no discovery backend to drop dead peers:
            # the heartbeat detector is its self-healing layer
            if c.health.heartbeat_enabled:
                self.monitor = HeartbeatMonitor(
                    self.instance, c.static_peers, conf=c.health)
                self.instance.monitor = self.monitor
                self.monitor.start()
                log.info("heartbeat detector on %d peers (interval %.1fs, "
                         "down after %d misses)", len(c.static_peers) - 1,
                         c.health.heartbeat_interval, c.health.suspect_after)
        self.http = HttpGateway(self.instance, c.http_listen_address)
        await self.http.start()
        log.info("HTTP gateway listening on %s:%d", self.http.host,
                 self.http.port)

    async def stop(self) -> None:
        """Graceful departure, in the JAX daemon's phases (each bounded,
        none skipped because an earlier one failed):

          1. monitor_stop: the failure detector must not react to this
             node's own departure;
          2. drain: stop the periodic capture controller, close
             admission intake and wait, at most drain_timeout, for queued
             and in-flight decisions; in mesh mode then lockstep_stop:
             the ranks agree on a final tick and the tick loop ends there
             (at most drain_timeout past the margin's ticks);
          3. global_flush: queued GLOBAL hits and broadcasts ship now;
          4. handoff: with a surviving ring, every key this node owns
             ships to the survivors under drain_timeout
             (Instance.migrate_keys); handoff_skipped when this node is
             the whole ring, or a mesh rank;
          5. frontdoor_stop, with the front door: its workers exit and
             its segments are unlinked;
          6. snapshot, with GUBER_SNAPSHOT_DIR, after the handoff (a
             mesh rank's stamped with the agreed final tick's time);
          7. teardown: discovery, http, grpc, the instance
             (main.go:127-139 order)."""
        await self._stop_monitor()
        await self._drain_requests()
        await self._lockstep_stop()
        await self._global_flush()
        await self._handoff_keys()
        await self._stop_frontdoor()
        await self._final_snapshot()
        await self._teardown()

    def _phase(self, name: str) -> None:
        self.shutdown_phases.append(name)

    async def _stop_monitor(self) -> None:
        self._phase("monitor_stop")
        if self.monitor is not None:
            try:
                await self.monitor.stop()
            except Exception:
                log.exception("stopping heartbeat monitor failed")

    async def _drain_requests(self) -> None:
        self._phase("drain")
        if self.instance is not None:
            # no periodic capture spans the drain and the snapshot
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None, self.instance.devprof.close)
            except Exception:
                log.exception("stopping the device profiler failed")
        if self.frontdoor is not None:
            # the workers shed new work in-band (reason `draining`) from
            # here on, with no ring round trip
            self.frontdoor.set_draining()
        if self.instance is None:
            return
        try:
            if not await self.instance.drain(self.conf.drain_timeout):
                log.warning("drain: decisions still pending at timeout")
        except Exception:
            log.exception("drain failed; continuing shutdown")

    async def _lockstep_stop(self) -> None:
        """Mesh mode: agree on a final tick with the other ranks and wait
        for this rank's tick loop to end there, so no rank is left in an
        all-reduce another never issues."""
        inst = self.instance
        if inst is None or not getattr(inst, "mesh_mode", False):
            return
        self._phase("lockstep_stop")
        try:
            tick = await inst.batcher.stop_lockstep(
                timeout=self.conf.drain_timeout + 30.0)
            log.info("lockstep stopped at the agreed tick %d", tick)
        except Exception:
            log.exception("the lockstep stop failed; continuing shutdown")

    async def _global_flush(self) -> None:
        """Push every queued GLOBAL hit and broadcast, bounded by the drain
        timeout."""
        self._phase("global_flush")
        if self.instance is None:
            return
        try:
            await asyncio.wait_for(self.instance.global_mgr.flush(),
                                   self.conf.drain_timeout)
        except Exception:
            log.exception("global flush failed; continuing shutdown")

    async def _handoff_keys(self) -> None:
        inst = self.instance
        if inst is None:
            return
        all_hosts = [p.host for p in inst.peer_list()]
        survivors = [h for h in all_hosts if h != inst.advertise_address]
        if not survivors or getattr(inst, "mesh_mode", False):
            # standalone, or the last node standing: the final snapshot is
            # the only continuity there is
            self._phase("handoff_skipped")
            return
        self._phase("handoff")
        try:
            totals = await asyncio.wait_for(
                inst.migrate_keys(all_hosts, survivors),
                self.conf.drain_timeout)
            log.info("departure handoff: %s", totals)
        except Exception:
            log.exception("departure handoff failed; survivors restart "
                          "these keys cold")

    async def _stop_frontdoor(self) -> None:
        """Stop the front door's workers and unlink its segments, so the
        snapshot after it holds the last decision they were answered."""
        if self.frontdoor is None:
            return
        self._phase("frontdoor_stop")
        try:
            await self.frontdoor.stop()
        except Exception:
            log.exception("stopping the front door failed")

    async def _final_snapshot(self) -> None:
        if self._snapshot_task is None and not self._tick_snapshots:
            return
        self._phase("snapshot")
        if self._snapshot_task is not None:
            self._snapshot_task.cancel()
            try:
                await self._snapshot_task
            except asyncio.CancelledError:
                pass
        if getattr(self.instance, "mesh_mode", False):
            # the tick loop ended at the agreed final tick: stamp the file
            # with that tick's time, as every rank does
            clock = self.instance.batcher.clock
            await self._snapshot_once(clock.time_of(clock.tick))
        else:
            await self._snapshot_once()

    async def _teardown(self) -> None:
        self._phase("teardown")
        if self._lease_sweep_task is not None:
            self._lease_sweep_task.cancel()
            try:
                await self._lease_sweep_task
            except asyncio.CancelledError:
                pass
        if self.pool is not None:
            await self.pool.close()
        if self.http is not None:
            await self.http.stop()
        if self.grpc is not None:
            await self.grpc.stop()
        if self.instance is not None:
            await self.instance.aclose()
            if getattr(self.instance, "mesh_mode", False):
                import torch.distributed as dist
                if dist.is_initialized():
                    dist.destroy_process_group()


async def _amain(conf: DaemonConfig) -> None:
    daemon = Daemon(conf)
    await daemon.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    log.info("caught signal; shutting down")
    await daemon.stop()


def main(argv=None) -> None:
    p = argparse.ArgumentParser("gubernator-tpu-torch")
    p.add_argument("--config", dest="config_file", default=None,
                   help="environment config file (KEY=value lines)")
    p.add_argument("--debug", action="store_true")
    args = p.parse_args(argv)

    conf = config_from_env(args.config_file)
    if args.debug or conf.debug:
        logging.basicConfig(level=logging.DEBUG)
        log.debug("debug enabled")
    else:
        logging.basicConfig(level=logging.INFO)

    asyncio.run(_amain(conf))


if __name__ == "__main__":
    main()
