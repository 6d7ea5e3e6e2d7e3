"""Cross-host GLOBAL manager: async hit aggregation + owner broadcasts.

The port of `gubernator_tpu/core/global_sync.py` (JAX-free), whole.  It
replaces the reference's globalManager (global.go:29-232) for the
between-hosts plane, the reference's eventually-consistent protocol:

  (a) a non-owner host answers from its replica and queues the hits here;
      `queue_hit` sums them per key (global.go:81-86) and every
      global_sync_wait `_send_hits` sends one aggregated request per key
      to the owning host (global.go:115-153);
  (b) an owner host queues every GLOBAL update here; `_broadcast`
      re-reads the authoritative status with hits=0 (global.go:199-203)
      and pushes UpdatePeerGlobals to every other peer (global.go:215-229),
      which the replicas write into their GLOBAL arena as upsert lanes of
      their next GLOBAL window (core/engine.py step(upserts=)).

Durations are observed into the reference's histograms (async_durations /
broadcast_durations, global.go:44-51) and the broadcast roots a
`global_broadcast` trace.

Hinted handoff (Dynamo-style, PAPERS.md): a send that fails after the
peer lane's own retries lands in a bounded, TTL'd per-peer HintBuffer and
is re-queued after the next successful send to that peer (opportunistic
replay).  Replay goes back through queue_hit / queue_update, so ownership
and the authoritative status are re-resolved at replay time.  What is
still dropped (TTL and bound evictions, send errors) is counted.  The
failure detector (net/health.py) also replays a peer's hints when it
confirms the peer UP again (Instance.on_peer_recovered -> replay_hints).
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

from gubernator_tpu_torch.api.types import RateLimitReq, UpdatePeerGlobal
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.core.interval import ArmedInterval
from gubernator_tpu_torch.observability.tracing import NOOP_SPAN

# hint kinds: aggregated non-owner hits vs owner broadcast updates
HINT_HITS = "hits"
HINT_UPDATE = "update"


class HintBuffer:
    """Bounded, TTL'd per-peer buffer of undeliverable GLOBAL payloads.

    One OrderedDict per peer keyed by (kind, hash_key): a hit for a key
    already hinted AGGREGATES into the existing entry (same rule as the
    live `_hits` map, so a long outage costs one entry per key, not one
    per window), refreshing its TTL; an update REPLACES (only the latest
    authoritative status matters).  Overflow evicts oldest-first and
    counts as expired — bounded memory beats unbounded fidelity for an
    eventually-consistent plane.  The clock is injectable so tests drive
    expiry without sleeping."""

    def __init__(self, ttl: float = 30.0, max_per_peer: int = 1024,
                 now_fn=time.monotonic):
        self.ttl = ttl
        self.max_per_peer = max_per_peer
        self.now_fn = now_fn
        self._peers: Dict[str, OrderedDict] = {}
        self.queued: Dict[str, int] = {}
        self.replayed: Dict[str, int] = {}
        self.expired: Dict[str, int] = {}

    def _bump(self, counter: Dict[str, int], host: str, n: int = 1) -> None:
        counter[host] = counter.get(host, 0) + n

    def put(self, host: str, kind: str, req: RateLimitReq) -> None:
        if self.max_per_peer <= 0 or self.ttl <= 0:
            self._bump(self.expired, host)  # handoff disabled: count the drop
            return
        buf = self._peers.setdefault(host, OrderedDict())
        key = (kind, req.hash_key())
        expires = self.now_fn() + self.ttl
        cur = buf.get(key)
        if cur is not None:
            old_req, _ = cur
            if kind == HINT_HITS:
                old_req.hits += req.hits
                buf[key] = (old_req, expires)
            else:
                buf[key] = (replace(req), expires)
            buf.move_to_end(key)
        else:
            buf[key] = (replace(req), expires)
            self._bump(self.queued, host)
            while len(buf) > self.max_per_peer:
                buf.popitem(last=False)
                self._bump(self.expired, host)

    def _expire(self, host: str) -> None:
        buf = self._peers.get(host)
        if not buf:
            return
        now = self.now_fn()
        # entries are TTL-refreshed on aggregate and moved to the end, so
        # the stale ones are at the front
        while buf:
            key, (_, expires) = next(iter(buf.items()))
            if expires > now:
                break
            buf.popitem(last=False)
            self._bump(self.expired, host)

    def sweep(self) -> None:
        for host in list(self._peers):
            self._expire(host)

    def pending(self, host: str) -> int:
        self._expire(host)
        return len(self._peers.get(host) or ())

    def take(self, host: str) -> List[Tuple[str, RateLimitReq]]:
        """Pop every fresh hint for `host` (expired ones are dropped and
        counted).  The caller re-queues them; counting as replayed is the
        caller's job once the re-queue happened."""
        self._expire(host)
        buf = self._peers.pop(host, None)
        if not buf:
            return []
        return [(kind, req) for (kind, _), (req, _) in buf.items()]

    def snapshot(self) -> dict:
        self.sweep()
        return {
            "pending": {h: len(b) for h, b in self._peers.items() if b},
            "queued_total": dict(self.queued),
            "replayed_total": dict(self.replayed),
            "expired_total": dict(self.expired),
        }


class GlobalManager:
    def __init__(self, behaviors: BehaviorConfig, instance, metrics=None,
                 log=None, health=None, now_fn=time.monotonic):
        self.conf = behaviors
        self.instance = instance  # core.service.Instance
        self.metrics = metrics
        self.log = log
        self._hits: Dict[str, RateLimitReq] = {}
        self._updates: Dict[str, RateLimitReq] = {}
        self._hit_interval: Optional[ArmedInterval] = None
        self._bcast_interval: Optional[ArmedInterval] = None
        self._tasks = []
        self._started = False
        # hinted handoff + drop accounting (health: config.HealthConfig)
        hint_ttl = health.hint_ttl if health is not None else 30.0
        hint_max = health.hint_max if health is not None else 1024
        self.hints = HintBuffer(ttl=hint_ttl, max_per_peer=hint_max,
                                now_fn=now_fn)
        self.send_errors: Dict[str, int] = {}
        self.broadcast_errors: Dict[str, int] = {}

    def start(self) -> None:
        if not self._started:
            self._hit_interval = ArmedInterval(self.conf.global_sync_wait)
            self._bcast_interval = ArmedInterval(self.conf.global_sync_wait)
            self._started = True

    def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        # the interval waiters live as attributes, not in _tasks — they
        # must be cancelled too or they outlive the manager
        for name in ("_hits_waiter_task", "_bcast_waiter_task"):
            t = getattr(self, name, None)
            if t is not None and not t.done():
                t.cancel()
        if self._hit_interval:
            self._hit_interval.stop()
        if self._bcast_interval:
            self._bcast_interval.stop()

    async def flush(self) -> None:
        """Final best-effort drain: push everything still queued and wait
        out in-flight senders.  Called BEFORE stop() on a clean shutdown
        (Instance.aclose / the daemon's drain phase) — stop() alone
        cancels the senders and would drop every queued hit/update."""
        try:
            if self._hits:
                await self._send_hits()
            if self._updates:
                await self._broadcast()
        except Exception as e:  # flush is best-effort by contract
            if self.log:
                self.log.error("error flushing global manager: %s", e)
        if self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)

    # ------------------------------------------------------------- handoff

    def replay_hints(self, host: str) -> int:
        """Re-queue every buffered hint for a recovered peer.  Replay goes
        through queue_hit/queue_update, so ownership and authoritative
        status are resolved FRESH — if the keyspace re-homed while the
        peer was down, the hits land on the new owner."""
        entries = self.hints.take(host)
        for kind, req in entries:
            if kind == HINT_HITS:
                self.queue_hit(req)
            else:
                self.queue_update(req)
        if entries:
            self.hints._bump(self.hints.replayed, host, len(entries))
            if self.metrics is not None:
                self.metrics.observe_hints(host, replayed=len(entries))
            if self.log:
                self.log.info("replayed %d hinted global payloads to '%s'",
                              len(entries), host)
        return len(entries)

    def _hint_failure(self, host: str, kind: str, reqs, counter: Dict[str, int]
                      ) -> None:
        """Account one failed per-peer send and buffer its payload."""
        counter[host] = counter.get(host, 0) + 1
        before = self.hints.queued.get(host, 0)
        for req in reqs:
            self.hints.put(host, kind, req)
        if self.metrics is not None:
            self.metrics.observe_global_error(
                host, kind, queued=self.hints.queued.get(host, 0) - before)

    # ------------------------------------------------------------- queueing

    def queue_hit(self, req: RateLimitReq) -> None:
        """Aggregate a non-owner hit for async send (global.go:62-64,81-86)."""
        key = req.hash_key()
        cur = self._hits.get(key)
        if cur is not None:
            cur.hits += req.hits
        else:
            self._hits[key] = replace(req)
        if len(self._hits) >= self.conf.global_batch_limit:
            self._spawn(self._send_hits())
        elif len(self._hits) == 1:
            self._hit_interval.arm()
            self._spawn_once("_hits_waiter_task", self._hits_waiter())

    def queue_update(self, req: RateLimitReq) -> None:
        """Mark a global key dirty for owner broadcast (global.go:66-68)."""
        self._updates[req.hash_key()] = replace(req)
        if len(self._updates) >= self.conf.global_batch_limit:
            self._spawn(self._broadcast())
        elif len(self._updates) == 1:
            self._bcast_interval.arm()
            self._spawn_once("_bcast_waiter_task", self._bcast_waiter())

    def _spawn(self, coro) -> None:
        t = asyncio.create_task(coro)
        self._tasks.append(t)
        t.add_done_callback(self._tasks.remove)

    def _spawn_once(self, name: str, coro) -> None:
        existing = getattr(self, name, None)
        if existing is not None and not existing.done():
            coro.close()
            return
        t = asyncio.create_task(coro)
        setattr(self, name, t)

    async def _hits_waiter(self) -> None:
        await self._hit_interval.wait()
        if self._hits:
            await self._send_hits()

    async def _bcast_waiter(self) -> None:
        await self._bcast_interval.wait()
        if self._updates:
            await self._broadcast()

    # ------------------------------------------------------------- sending

    async def _send_hits(self) -> None:
        hits, self._hits = self._hits, {}
        start = time.monotonic()
        # group aggregated requests by owning peer (global.go:124-140)
        by_peer: Dict[str, list] = {}
        clients = {}
        for key, req in hits.items():
            try:
                peer = self.instance.get_peer(key)
            except Exception as e:
                if self.log:
                    self.log.error("while getting peer for hash key '%s': %s", key, e)
                continue
            by_peer.setdefault(peer.host, []).append(req)
            clients[peer.host] = peer
        for host, reqs in by_peer.items():
            try:
                await clients[host].get_peer_rate_limits(reqs)
            except Exception as e:
                if self.log:
                    self.log.error("error sending global hits to '%s': %s", host, e)
                # hinted handoff: keep the aggregated hits for replay
                # instead of silently dropping them
                self._hint_failure(host, HINT_HITS, reqs, self.send_errors)
                continue
            # opportunistic replay: the peer just answered, so anything
            # hinted for it from an earlier outage can go now (the
            # detector's replay_hints call stays the primary trigger)
            if self.hints.pending(host):
                self.replay_hints(host)
        if self.metrics is not None:
            self.metrics.async_durations.observe(time.monotonic() - start)

    async def _broadcast(self) -> None:
        updates, self._updates = self._updates, {}
        start = time.monotonic()
        # the broadcast runs on its own timer task, so it roots its own
        # trace (there is no single originating request to stitch into)
        tracer = getattr(self.instance, "tracer", None)
        span = (tracer.start_trace("global_broadcast")
                if tracer is not None and tracer.enabled else NOOP_SPAN)
        try:
            with span:
                await self._broadcast_inner(updates)
        finally:
            wall = time.monotonic() - start
            if self.metrics is not None:
                self.metrics.broadcast_durations.observe(wall)
                self.metrics.observe_stage("global_broadcast", wall)

    async def _broadcast_inner(self, updates: Dict[str, RateLimitReq]
                               ) -> None:
        globals_ = []
        for key, req in updates.items():
            # authoritative status: re-read with behavior/hits cleared
            # (global.go:199-203)
            probe = replace(req, hits=0)
            try:
                status = await self.instance.read_global_status(probe)
            except Exception as e:
                if self.log:
                    self.log.error(
                        "while sending global updates to peers for '%s': %s", key, e)
                continue
            globals_.append(UpdatePeerGlobal(
                key=key, status=status,
                algorithm=req.algorithm, duration=req.duration,
            ))
        for peer in self.instance.peer_list():
            if peer.is_owner:  # exclude ourselves (global.go:216-218)
                continue
            try:
                await peer.update_peer_globals(globals_)
            except Exception as e:
                if self.log:
                    self.log.error("error sending global updates to '%s': %s",
                                   peer.host, e)
                # hint the ORIGINAL dirty reqs, not the materialized
                # statuses: replay re-reads the authoritative status at
                # replay time, so the peer never gets a stale snapshot
                self._hint_failure(peer.host, HINT_UPDATE, updates.values(),
                                   self.broadcast_errors)
                continue
