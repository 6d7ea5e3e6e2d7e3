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
etcd and Kubernetes discovery, the front door and mesh serving are not
ported yet: their knobs raise in config_from_env.
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
from gubernator_tpu_torch.server import GrpcServer
from gubernator_tpu_torch.state import snapshot as snapmod

log = logging.getLogger("gubernator.daemon")


class Daemon:
    def __init__(self, conf: DaemonConfig):
        self.conf = conf
        self.instance: Optional[Instance] = None
        self.grpc: Optional[GrpcServer] = None
        self.http: Optional[HttpGateway] = None
        self.pool: Optional[StaticPool] = None
        # net/health.py HeartbeatMonitor (static pools)
        self.monitor: Optional[HeartbeatMonitor] = None
        # phase names appended as stop() runs them, in order: the JAX
        # daemon's shutdown contract
        self.shutdown_phases: list = []
        self._snapshot_task: Optional[asyncio.Task] = None
        self._lease_sweep_task: Optional[asyncio.Task] = None

    def _snapshot_file(self) -> str:
        return snapmod.snapshot_path(self.conf.snapshot_dir)

    async def _snapshot_once(self) -> None:
        try:
            await self.instance.save_snapshot(self._snapshot_file())
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
        # fault injection (net/faults.py): GUBER_FAULTS is read once here;
        # a rule on an unknown seam raises before anything is built
        FAULTS.load_from_env()
        self.instance = Instance(
            engine_config=c.engine, behaviors=c.behaviors, device=c.device,
            analytics=c.analytics, slo=c.slo, metrics=Metrics(),
            tiers=c.tiers, qos=c.qos, leases=c.leases,
            advertise_address=c.advertise_address, health=c.health,
            tracer=Tracer(sample=c.trace_sample, export=c.trace_export,
                          node=c.advertise_address or "local"))
        # launch every drain shape before accepting traffic
        self.instance.engine.warmup()
        if c.snapshot_dir:
            # restore BEFORE serving, on the engine thread; a missing or
            # corrupt snapshot is a cold start, never a failed boot
            os.makedirs(c.snapshot_dir, exist_ok=True)
            inst = self.instance
            snap = await inst._quiesced(
                lambda: snapmod.restore_engine(inst.engine,
                                               self._snapshot_file(),
                                               metrics=inst.metrics))
            if snap is not None and snap.leases:
                # the device free-slot counters came back with the planes
                inst.leases.import_rows(snap.leases)
            self._snapshot_task = asyncio.create_task(self._snapshot_loop())
            log.info("snapshots -> %s every %dms", c.snapshot_dir,
                     c.snapshot_interval_ms)
        if c.leases.sweep_interval_ms > 0:
            self._lease_sweep_task = asyncio.create_task(
                self._lease_sweep_loop(c.leases.sweep_interval_ms))
        self.grpc = GrpcServer(self.instance, c.grpc_listen_address)
        await self.grpc.start()
        log.info("gRPC listening on %s", self.grpc.address)
        if c.static_peers:
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
          2. drain: close admission intake and wait, at most
             drain_timeout, for queued and in-flight decisions;
          3. global_flush: queued GLOBAL hits and broadcasts ship now;
          4. handoff: with a surviving ring, every key this node owns
             ships to the survivors under drain_timeout
             (Instance.migrate_keys); handoff_skipped when this node is
             the whole ring;
          5. snapshot, with GUBER_SNAPSHOT_DIR, after the handoff;
          6. teardown: discovery, http, grpc, the instance
             (main.go:127-139 order)."""
        await self._stop_monitor()
        await self._drain_requests()
        await self._global_flush()
        await self._handoff_keys()
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
        if self.instance is None:
            return
        try:
            if not await self.instance.drain(self.conf.drain_timeout):
                log.warning("drain: decisions still pending at timeout")
        except Exception:
            log.exception("drain failed; continuing shutdown")

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
        if not survivors:
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

    async def _final_snapshot(self) -> None:
        if self._snapshot_task is None:
            return
        self._phase("snapshot")
        self._snapshot_task.cancel()
        try:
            await self._snapshot_task
        except asyncio.CancelledError:
            pass
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
