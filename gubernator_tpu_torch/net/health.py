"""Heartbeat failure detector: suspicion counts -> confirmed down -> re-home.

A copy of `gubernator_tpu/net/health.py` (JAX-free).  It loads without
grpc and protobuf, as net/peers.py does: each probe is a V1 HealthCheck
through a PeerClient's transport seam, the Instance's `peer_transport`
when it has one, otherwise gRPC on a channel with subchannels of its own.

The discovery backends (a Kubernetes watch, an etcd lease) remove dead
peers; a GUBER_STATIC_PEERS pool never does, so a crashed peer stays in
the ring and every key it owns blackholes until each caller's breaker
trips.  This monitor closes that gap with the simplest detector that
composes with what exists (SWIM's indirect probes and gossip are out of
scope for a pool small enough to probe all to all):

  * every `heartbeat_interval` each peer gets one HealthCheck probe on its
    OWN PeerClient (separate from the serving ring's clients, so
    set_peers closing a departed client never kills its probe channel,
    and an open serving breaker never hides a recovery);
  * `suspect_after` CONSECUTIVE failures confirm a peer DOWN: its breaker
    is force-tripped, its concurrency leases are released
    (Instance.release_peer_leases) and the ring re-homes around it
    (Instance.rehome: set_peers, then migrate_keys);
  * `recover_after` CONSECUTIVE successes confirm a DOWN peer UP again:
    its breaker is force-closed, the ring re-homes to include it, and the
    GLOBAL manager replays its hinted payloads
    (Instance.on_peer_recovered).  The two-sided hysteresis bounds how
    often a flapping peer can churn the ring.

Everything is injectable (probe_fn, now_fn, sleep) and `probe_once()` is
public, so a test drives whole failure timelines without real time; the
peer_rpc fault seam applies to probes as to traffic, so an injected
partition blacks out heartbeats too.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, List, Optional, Sequence

from gubernator_tpu_torch.config import HealthConfig
from gubernator_tpu_torch.net.peers import GrpcPeerTransport, PeerClient

log = logging.getLogger("gubernator.health")

UP = "up"
SUSPECT = "suspect"
DOWN = "down"


class _PeerState:
    __slots__ = ("host", "state", "fail_streak", "ok_streak",
                 "probes", "failures", "last_change")

    def __init__(self, host: str, now: float):
        self.host = host
        self.state = UP
        self.fail_streak = 0
        self.ok_streak = 0
        self.probes = 0
        self.failures = 0
        self.last_change = now


class HeartbeatMonitor:
    def __init__(self, instance, addresses: Sequence[str],
                 conf: Optional[HealthConfig] = None,
                 probe_fn=None, now_fn=time.monotonic, sleep=asyncio.sleep):
        """addresses: the full static membership INCLUDING this node (its
        own entry is skipped); the monitor's view of who should be in the
        ring is this list, confirmed-down peers subtracted from it but
        never forgotten, so they rejoin on recovery.

        probe_fn(host) -> awaitable: an injectable probe for tests; by
        default V1 HealthCheck through a dedicated PeerClient."""
        self.instance = instance
        self.conf = conf or HealthConfig()
        self.now_fn = now_fn
        self._sleep = sleep
        self._probe_fn = probe_fn
        self.self_host = instance.advertise_address
        self._peers: Dict[str, _PeerState] = {}
        self._clients: Dict[str, PeerClient] = {}
        now = now_fn()
        for addr in addresses:
            if addr and addr != self.self_host:
                self._peers[addr] = _PeerState(addr, now)
        self._task: Optional[asyncio.Task] = None
        self._stopped = asyncio.Event()

    # ------------------------------------------------------------- probing

    def _client(self, host: str) -> PeerClient:
        client = self._clients.get(host)
        if client is None:
            make = getattr(self.instance, "peer_transport", None)
            # over gRPC the probe channel keeps its own subchannels: a
            # probe refused while the peer boots would otherwise put the
            # process's shared subchannel into reconnect backoff, and the
            # serving ring's forwards there would fail fast with it
            transport = (make(host) if make else GrpcPeerTransport(
                host, options=(("grpc.use_local_subchannel_pool", 1),)))
            client = PeerClient(self.instance.behaviors, host, qos=None,
                                transport=transport)
            self._clients[host] = client
        return client

    async def _probe(self, host: str) -> bool:
        try:
            if self._probe_fn is not None:
                await self._probe_fn(host)
            else:
                await self._client(host).health_check(
                    timeout=self.conf.heartbeat_timeout)
            return True
        except Exception:
            return False

    async def probe_once(self) -> None:
        """One full probe round (all peers concurrently) and the verdicts.
        The run loop calls this every heartbeat_interval; tests call it
        directly to step the detector deterministically."""
        hosts = list(self._peers)
        results = await asyncio.gather(*(self._probe(h) for h in hosts))
        for host, ok in zip(hosts, results):
            await self._account(host, ok)

    async def _account(self, host: str, ok: bool) -> None:
        st = self._peers.get(host)
        if st is None:
            return
        st.probes += 1
        if ok:
            st.ok_streak += 1
            st.fail_streak = 0
            if st.state == SUSPECT:
                self._transition(st, UP)
            elif st.state == DOWN and st.ok_streak >= self.conf.recover_after:
                self._transition(st, UP)
                await self._on_peer_up(host)
        else:
            st.failures += 1
            st.fail_streak += 1
            st.ok_streak = 0
            if st.state == UP:
                self._transition(st, SUSPECT)
            if (st.state == SUSPECT
                    and st.fail_streak >= self.conf.suspect_after):
                self._transition(st, DOWN)
                await self._on_peer_down(host)

    def _transition(self, st: _PeerState, state: str) -> None:
        if state == st.state:
            return
        log.log(logging.WARNING if state != UP else logging.INFO,
                "peer '%s': %s -> %s", st.host, st.state, state)
        st.state = state
        st.last_change = self.now_fn()
        metrics = getattr(self.instance, "metrics", None)
        if metrics is not None:
            metrics.observe_peer_health(st.host, state)

    # ------------------------------------------------------------- verdicts

    def membership(self) -> List[str]:
        """Who the ring should contain now: the static pool minus the
        confirmed-down peers, plus this node."""
        alive = [h for h, st in self._peers.items() if st.state != DOWN]
        return sorted(alive + [self.self_host])

    async def _on_peer_down(self, host: str) -> None:
        # stop paying forward latency for a peer the detector knows is
        # dead: the breaker's own clockwork would need fail_threshold
        # more losses to notice
        qos = getattr(self.instance, "qos", None)
        if qos is not None:
            breaker = qos.breakers.get(host)
            if breaker is not None:
                breaker.trip()
        # give back the concurrency slots the dead peer's clients hold:
        # nobody is left on that side to send the releases
        release = getattr(self.instance, "release_peer_leases", None)
        if release is not None:
            try:
                await release(host)
            except Exception as e:
                log.error("lease release after '%s' went down failed: %s",
                          host, e)
        try:
            await self.instance.rehome(self.membership(), direction="down")
        except Exception as e:
            log.error("re-home after '%s' went down failed: %s", host, e)

    async def _on_peer_up(self, host: str) -> None:
        qos = getattr(self.instance, "qos", None)
        if qos is not None:
            breaker = qos.breakers.get(host)
            if breaker is not None:
                breaker.reset()
        try:
            await self.instance.rehome(self.membership(), direction="up")
        except Exception as e:
            log.error("re-home after '%s' recovered failed: %s", host, e)
        self.instance.on_peer_recovered(host)

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._stopped.clear()
            self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        while not self._stopped.is_set():
            try:
                await self.probe_once()
            except Exception as e:  # the detector must outlive any probe bug
                log.error("heartbeat round failed: %s", e)
            try:
                await asyncio.wait_for(self._stopped.wait(),
                                       self.conf.heartbeat_interval)
            except asyncio.TimeoutError:
                pass

    async def stop(self) -> None:
        self._stopped.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        for client in self._clients.values():
            try:
                await client.close()
            except Exception:
                pass
        self._clients.clear()

    # ------------------------------------------------------------- introspect

    def snapshot(self) -> dict:
        now = self.now_fn()
        return {
            "self": self.self_host,
            "interval_s": self.conf.heartbeat_interval,
            "suspect_after": self.conf.suspect_after,
            "recover_after": self.conf.recover_after,
            "peers": {
                h: {
                    "state": st.state,
                    "fail_streak": st.fail_streak,
                    "ok_streak": st.ok_streak,
                    "probes": st.probes,
                    "failures": st.failures,
                    "since_change_s": round(now - st.last_change, 3),
                }
                for h, st in self._peers.items()
            },
        }
