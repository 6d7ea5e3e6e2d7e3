"""Server daemon: the standalone composition root.

The port of `gubernator_tpu/daemon.py` for one node: env config, the
Instance (with a Metrics registry) on GUBER_TORCH_DEVICE (default `cuda`;
it raises without a card unless `cpu` is asked for), `engine.warmup()`,
the gRPC server, the HTTP gateway with /metrics, and a graceful stop on
SIGINT/SIGTERM.  Run as `python -m gubernator_tpu_torch.daemon` (flags:
--config <env-file>, --debug, the reference's only two flags,
cmd/gubernator/config.go:63-66).  It needs grpcio, protobuf, aiohttp and
prometheus_client.  Peer discovery, snapshots, the front door, mesh
serving, fault injection and the lease sweep are not ported yet: their
knobs raise in config_from_env.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
from typing import Optional

from gubernator_tpu_torch.api.http_gateway import HttpGateway
from gubernator_tpu_torch.config import DaemonConfig, config_from_env
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.observability.metrics import Metrics
from gubernator_tpu_torch.server import GrpcServer

log = logging.getLogger("gubernator.daemon")


class Daemon:
    def __init__(self, conf: DaemonConfig):
        self.conf = conf
        self.instance: Optional[Instance] = None
        self.grpc: Optional[GrpcServer] = None
        self.http: Optional[HttpGateway] = None
        # phase names appended as stop() runs them, in order: the JAX
        # daemon's order for the phases the port has
        self.shutdown_phases: list = []

    async def start(self) -> None:
        c = self.conf
        self.instance = Instance(
            engine_config=c.engine, behaviors=c.behaviors, device=c.device,
            analytics=c.analytics, slo=c.slo, metrics=Metrics())
        # launch every drain shape before accepting traffic
        self.instance.engine.warmup()
        self.grpc = GrpcServer(self.instance, c.grpc_listen_address)
        await self.grpc.start()
        log.info("gRPC listening on %s", self.grpc.address)
        self.http = HttpGateway(self.instance, c.http_listen_address)
        await self.http.start()
        log.info("HTTP gateway listening on %s:%d", self.http.host,
                 self.http.port)

    async def stop(self) -> None:
        """Graceful departure, in the JAX daemon's order for the phases
        the port has: drain (wait, at most drain_timeout, for queued and
        in-flight decisions), then teardown (http, grpc, instance;
        main.go:127-139 order).  Standalone there is no detector to stop,
        no GLOBAL manager to flush and no ring to hand keys to, and
        snapshots are not ported."""
        await self._drain_requests()
        await self._teardown()

    def _phase(self, name: str) -> None:
        self.shutdown_phases.append(name)

    async def _drain_requests(self) -> None:
        self._phase("drain")
        if self.instance is None:
            return
        try:
            if not await self.instance.drain(self.conf.drain_timeout):
                log.warning("drain: decisions still pending at timeout")
        except Exception:
            log.exception("drain failed; continuing shutdown")

    async def _teardown(self) -> None:
        self._phase("teardown")
        if self.http is not None:
            await self.http.stop()
        if self.grpc is not None:
            await self.grpc.stop()
        if self.instance is not None:
            self.instance.close()


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
