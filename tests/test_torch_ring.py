"""The port's peer ring below the Instance: parallel/router.py
ConsistentHashRing against the JAX ring, net/peers.py PeerClient over a
fake transport (its batching window, typed errors, retries, breaker, the
peer_rpc fault seam and the traceparent metadata), net/faults.py's
specs and seams against the JAX injector's, and core/global_sync.py
GlobalManager over fake peers (aggregation, broadcast, hinted handoff),
against the JAX manager on the same script."""

import asyncio

import pytest

import gubernator_tpu  # noqa: F401
from gubernator_tpu.api.types import Behavior as JBehavior
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.config import BehaviorConfig as JBehaviorConfig
from gubernator_tpu.config import HealthConfig as JHealthConfig
from gubernator_tpu.core.global_sync import GlobalManager as JGlobalManager
from gubernator_tpu.parallel.router import ConsistentHashRing as JRing
from gubernator_tpu_torch.api.types import (
    Behavior,
    RateLimitReq,
    RateLimitResp,
    Status,
)
from gubernator_tpu_torch.config import BehaviorConfig, HealthConfig, QoSConfig
from gubernator_tpu_torch.core.global_sync import (
    HINT_HITS,
    HINT_UPDATE,
    GlobalManager,
    HintBuffer,
)
from gubernator_tpu_torch.net import faults as faults_mod
from gubernator_tpu_torch.net.faults import (
    FAULTS,
    SEAM_PEER_RPC,
    FaultError,
    FaultInjector,
)
from gubernator_tpu_torch.net.peers import (
    BreakerOpenError,
    PeerClient,
    PeerError,
)
from gubernator_tpu_torch.observability.tracing import TRACEPARENT, Tracer
from gubernator_tpu_torch.parallel.router import ConsistentHashRing
from gubernator_tpu_torch.qos import QoSManager
from gubernator_tpu_torch.qos.breaker import CLOSED, OPEN

pytestmark = pytest.mark.torch_port


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ------------------------------------------------------------------- ring


@pytest.mark.parametrize("hosts", [
    ["127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9003"],
    [f"10.0.{i}.{j}:81" for i in range(4) for j in range(5)],
    ["only:1"],
])
def test_ring_owner_and_table_match_the_jax_ring(hosts):
    port, ref = ConsistentHashRing(), JRing()
    for h in hosts:
        port.add(h, h)
        ref.add(h, h)
    assert port.size() == ref.size() == len(hosts)
    assert port.ring_table() == ref.ring_table()
    keys = [f"name_{i}" for i in range(10_000)] + ["", "ü_ключ", "x" * 300]
    assert [port.get(k) for k in keys] == [ref.get(k) for k in keys]
    assert port.get_by_host(hosts[0]) == hosts[0]
    assert sorted(port.peers()) == sorted(hosts)


def test_empty_ring_raises_like_the_jax_ring():
    for ring in (ConsistentHashRing(), JRing()):
        with pytest.raises(RuntimeError, match="pool is empty"):
            ring.get("k")


# ------------------------------------------------------------- fault seams


@pytest.mark.parametrize("spec", ["snapshot_io:error",
                                  "engine_dispatch:drop=1.0",
                                  "peer_rpc:drop=0.5;snapshot_io:error"])
def test_unwired_fault_seam_raises_naming_item_6d(spec):
    """The snapshot_io and engine_dispatch seams are crossed now: a spec
    on them loads as the JAX injector loads it (the same rules, the same
    seeded schedule) instead of raising."""
    from gubernator_tpu.net.faults import FaultInjector as JFaultInjector
    f, j = FaultInjector(), JFaultInjector()
    f.load_spec(spec, seed=3)
    j.load_spec(spec, seed=3)
    assert f.enabled and j.enabled
    assert f.describe() == j.describe() != {}
    for seam in f.describe():
        got, want = [], []
        for inj, out in ((f, got), (j, want)):
            for _ in range(32):
                try:
                    inj.on_sync(seam, "target")
                    out.append(0)
                except OSError:
                    out.append(1)
        assert got == want


def test_unknown_fault_seam_and_key_raise():
    with pytest.raises(ValueError, match="unknown fault seam"):
        FaultInjector().load_spec("peer_drop:error")
    with pytest.raises(ValueError, match="unknown fault key"):
        FaultInjector().load_spec("peer_rpc:banana=1")


def test_fault_spec_grammar_and_seeded_schedule():
    f = FaultInjector()
    f.load_spec("peer_rpc:drop=0.1,delay_ms=50,match=host-b,times=3")
    (rule,) = f.describe()[SEAM_PEER_RPC]
    assert rule == {"drop": 0.1, "delay_ms": 50.0, "fired": 0,
                    "match": "host-b", "remaining": 3}

    def schedule(seed):
        g = FaultInjector(seed=seed)
        g.configure(SEAM_PEER_RPC, drop=0.5)
        out = []
        for _ in range(64):
            try:
                g.on_sync(SEAM_PEER_RPC, "peer:1")
                out.append(0)
            except FaultError:
                out.append(1)
        return out

    assert schedule(7) == schedule(7) != schedule(8)


# ------------------------------------------------------------- peer client


class FakeRpcError(Exception):
    def __init__(self, code, details="boom"):
        self._code = code
        self._details = details

    def code(self):
        return self._code

    def details(self):
        return self._details


class FakeCode:
    """A status code as grpc names it (the client reads `.name`)."""

    def __init__(self, name):
        self.name = name


class FakeTransport:
    """The PeersV1 calls of net/peers.py's transport seam, recorded; each
    batch answers remaining = limit - hits in request order."""

    errors = (FakeRpcError,)

    def __init__(self):
        self.batches = []
        self.metadata = []
        self.updates = []
        self.raw = []
        self.fail = []  # exceptions to raise, one per call, first first
        self.closed = False

    def _maybe_fail(self):
        if self.fail:
            raise self.fail.pop(0)

    async def get_peer_rate_limits(self, reqs, timeout, metadata=None):
        self._maybe_fail()
        self.batches.append(list(reqs))
        self.metadata.append(metadata)
        return [RateLimitResp(status=Status.UNDER_LIMIT, limit=r.limit,
                              remaining=r.limit - r.hits) for r in reqs]

    async def update_peer_globals(self, globals_, timeout):
        self._maybe_fail()
        self.updates.append(list(globals_))

    async def get_peer_rate_limits_raw(self, data, timeout):
        self._maybe_fail()
        self.raw.append(data)
        return b"resp:" + data

    async def health_check(self, timeout):
        self._maybe_fail()
        return "healthy"

    async def close(self):
        self.closed = True


def _client(transport, qos=None, **behaviors):
    p = PeerClient(BehaviorConfig(**behaviors), "10.0.0.2:81", qos=qos,
                   transport=transport)
    sleeps = []

    async def no_sleep(d):
        sleeps.append(d)
    p._sleep = no_sleep
    return p, sleeps


def _r(key, hits=1, behavior=Behavior.BATCHING, limit=10):
    return RateLimitReq(name="ring", unique_key=key, hits=hits, limit=limit,
                        duration=60_000, behavior=behavior)


def test_peer_client_loads_no_transport_until_the_first_call():
    p = PeerClient(BehaviorConfig(), "127.0.0.1:1")
    assert p._transport is None
    assert p.breaker.state == CLOSED


def test_batching_window_ships_at_batch_limit():
    async def body():
        t = FakeTransport()
        p, _ = _client(t, batch_limit=4, batch_wait=10.0)
        resps = await asyncio.gather(
            *(p.get_peer_rate_limit(_r(f"k{i}", hits=i)) for i in range(8)))
        await p.close()
        return t, resps

    t, resps = asyncio.run(body())
    # two windows of exactly batch_limit, demuxed back by position
    assert [len(b) for b in t.batches] == [4, 4]
    assert [r.remaining for r in resps] == [10 - i for i in range(8)]
    assert t.closed


def test_batching_window_ships_at_batch_wait():
    async def body():
        t = FakeTransport()
        p, _ = _client(t, batch_limit=1000, batch_wait=0.01)
        first = asyncio.ensure_future(p.get_peer_rate_limit(_r("a")))
        await asyncio.sleep(0)
        second = asyncio.ensure_future(p.get_peer_rate_limit(
            _r("b", behavior=Behavior.GLOBAL)))
        await asyncio.sleep(0.001)
        assert not t.batches  # still inside the window
        out = await asyncio.gather(first, second)
        # NO_BATCHING goes at once, alone
        nb = await p.get_peer_rate_limit(
            _r("c", behavior=Behavior.NO_BATCHING))
        await p.close()
        return t, out, nb

    t, out, nb = asyncio.run(body())
    assert [[r.unique_key for r in b] for b in t.batches] == [["a", "b"],
                                                              ["c"]]
    assert [r.remaining for r in out] == [9, 9] and nb.remaining == 9


def test_failed_window_fails_every_waiter_with_a_typed_error():
    async def body():
        t = FakeTransport()
        t.fail = [FakeRpcError(FakeCode("INVALID_ARGUMENT"), "bad req")]
        p, sleeps = _client(t, batch_limit=2, batch_wait=10.0)
        out = await asyncio.gather(
            p.get_peer_rate_limit(_r("a")), p.get_peer_rate_limit(_r("b")),
            return_exceptions=True)
        return p, out, sleeps

    p, out, sleeps = asyncio.run(body())
    assert all(isinstance(e, PeerError) for e in out)
    e = out[0]
    assert "10.0.0.2:81" in str(e) and "bad req" in str(e)
    assert e.code.name == "INVALID_ARGUMENT" and not e.retryable
    assert sleeps == []  # not retried
    assert p.breaker.state == CLOSED  # the peer answered: alive


def test_transient_failures_retry_then_trip_the_breaker():
    async def body():
        clk = FakeClock()
        qos = QoSManager(QoSConfig(peer_retries=2, breaker_fail_threshold=2,
                                   breaker_open_duration=5.0), now_fn=clk)
        t = FakeTransport()
        p, sleeps = _client(t, qos=qos)
        unavailable = FakeCode("UNAVAILABLE")
        t.fail = [FakeRpcError(unavailable) for _ in range(3)]
        with pytest.raises(PeerError) as ei:
            await p.get_peer_rate_limits([_r("a")])
        assert ei.value.retryable and not t.fail  # 1 attempt + 2 retries
        assert len(sleeps) == 2 and all(0 < d <= 0.25 for d in sleeps)
        assert p.breaker.state == CLOSED  # one strike of two
        t.fail = [asyncio.TimeoutError() for _ in range(3)]
        with pytest.raises(PeerError) as ei:
            await p.get_peer_rate_limits([_r("a")])
        assert ei.value.code == "DEADLINE_EXCEEDED" or \
            ei.value.code.name == "DEADLINE_EXCEEDED"
        assert p.breaker.state == OPEN
        # open: refused locally, the transport never called
        n = len(t.batches)
        with pytest.raises(BreakerOpenError):
            await p.update_peer_globals([])
        assert len(t.batches) == n and not t.updates
        # recovery through half-open
        clk.advance(5.0)
        assert await p.get_peer_rate_limits_raw(b"x") == b"resp:x"
        assert p.breaker.state == CLOSED

    asyncio.run(body())


def test_peer_rpc_fault_seam_partitions_one_peer():
    async def body():
        t = FakeTransport()
        p, sleeps = _client(t)
        FAULTS.configure(SEAM_PEER_RPC, drop=1.0, match="10.0.0.2:81",
                         times=3)
        try:
            with pytest.raises(PeerError) as ei:
                await p.get_peer_rate_limits([_r("a")])
            # an injected partition looks like a dead peer: retryable,
            # retried, never reaching the transport
            assert ei.value.retryable and len(sleeps) == 2
            assert not t.batches
            # the budget of 3 is spent: the next call passes
            out = await p.get_peer_rate_limits([_r("a", hits=3)])
            assert out[0].remaining == 7
            # the health probe crosses the seam too, outside the breaker
            FAULTS.configure(SEAM_PEER_RPC, drop=1.0, times=1)
            with pytest.raises(FaultError):
                await p.health_check()
            assert await p.health_check() == "healthy"
        finally:
            FAULTS.clear()

    asyncio.run(body())


def test_traceparent_rides_the_batch_rpc():
    async def body():
        t = FakeTransport()
        p, _ = _client(t, batch_limit=1000, batch_wait=0.005)
        tracer = Tracer(sample=1.0, export="", node="a")
        with tracer.start_trace("rpc") as root:
            await p.get_peer_rate_limit(_r("traced"))
        await p.get_peer_rate_limit(_r("untraced"))
        return t, root

    t, root = asyncio.run(body())
    # the window task has no ambient context: the one captured at submit
    # time rides the RPC; an unsampled request sends none
    assert t.metadata == [((TRACEPARENT, root.ctx.traceparent()),), None]


# ----------------------------------------------------------- global manager


class StubPeer:
    def __init__(self, host, fail=False, is_owner=False):
        self.host = host
        self.is_owner = is_owner
        self.fail = fail
        self.received = []
        self.updates = []

    async def get_peer_rate_limits(self, reqs):
        if self.fail:
            raise ConnectionError(f"{self.host} unreachable")
        self.received.append([(r.unique_key, r.hits) for r in reqs])
        return [None] * len(reqs)

    async def update_peer_globals(self, globals_):
        if self.fail:
            raise ConnectionError(f"{self.host} unreachable")
        self.updates.append([(g.key, g.status.remaining, int(g.algorithm),
                              g.duration) for g in globals_])


class StubInstance:
    """Instance stand-in: keys starting "a" are owned by peer A, the rest
    by peer B; self is listed too (the broadcast skips it)."""

    def __init__(self, peers, resp_cls):
        self.peers = peers
        self.resp_cls = resp_cls
        self.probes = []

    def get_peer(self, key):
        return self.peers[0] if key.split("_", 1)[1].startswith("a") \
            else self.peers[1]

    def peer_list(self):
        return self.peers

    async def read_global_status(self, probe):
        self.probes.append((probe.unique_key, probe.hits))
        return self.resp_cls(status=0, limit=probe.limit,
                             remaining=probe.limit - len(probe.unique_key))


def _managers(clk, fail=False):
    """The port's and the JAX GlobalManager over equal stub clusters."""
    from gubernator_tpu.api.types import RateLimitResp as JResp
    out = []
    for gm_cls, bconf, hconf, resp in (
            (GlobalManager, BehaviorConfig, HealthConfig, RateLimitResp),
            (JGlobalManager, JBehaviorConfig, JHealthConfig, JResp)):
        peers = [StubPeer("A:1", fail), StubPeer("B:1", fail),
                 StubPeer("self:1", is_owner=True)]
        inst = StubInstance(peers, resp)
        gm = gm_cls(bconf(global_sync_wait=10.0, global_batch_limit=3), inst,
                    metrics=None, log=None,
                    health=hconf(hint_ttl=30.0, hint_max=2), now_fn=clk)
        gm.start()
        out.append((gm, inst, peers))
    return out


def _script(req_cls, beh):
    return [req_cls(name="g", unique_key=k, hits=h, limit=100,
                    duration=60_000, algorithm=a, behavior=beh)
            for k, h, a in (("a1", 2, 0), ("b1", 1, 1), ("a1", 3, 0),
                            ("a2", 1, 0))]


def test_global_manager_aggregates_broadcasts_like_the_jax_manager():
    async def body():
        clk = FakeClock()
        seen = []
        for (gm, inst, peers), (req_cls, beh) in zip(
                _managers(clk),
                ((RateLimitReq, Behavior.GLOBAL),
                 (JReq, JBehavior.GLOBAL))):
            for r in _script(req_cls, beh):
                gm.queue_hit(r)
            # the third distinct key reaches global_batch_limit: a send
            await asyncio.sleep(0)
            await gm.flush()
            for r in _script(req_cls, beh):
                gm.queue_update(r)
            await gm.flush()
            gm.stop()
            seen.append(([p.received for p in peers],
                         [p.updates for p in peers], inst.probes))
        return seen

    port, ref = asyncio.run(body())
    assert port == ref
    received, updates, probes = port
    # per owner, one aggregated request per key: a1's 2 + 3 hits
    assert received[0] == [[("a1", 5), ("a2", 1)]]
    assert received[1] == [[("b1", 1)]]
    # every replica but self gets the authoritative hits=0 re-reads
    assert probes == [("a1", 0), ("b1", 0), ("a2", 0)]
    # flush broadcasts what is queued; the sender the batch limit spawned
    # then finds the queue empty and pushes an empty update, in both
    assert updates[0] == updates[1] == [[("g_a1", 98, 0, 60_000),
                                         ("g_b1", 98, 1, 60_000),
                                         ("g_a2", 98, 0, 60_000)], []]
    assert updates[2] == []


def test_failed_sends_hint_and_replay_after_a_success():
    async def body():
        clk = FakeClock()
        (gm, inst, peers), _ = _managers(clk, fail=True)
        for r in _script(RateLimitReq, Behavior.GLOBAL)[:3]:
            gm.queue_hit(r)
        await gm._send_hits()
        assert gm.send_errors == {"A:1": 1, "B:1": 1}
        assert gm.hints.pending("A:1") == 1  # a1's hits aggregated
        gm.queue_update(_script(RateLimitReq, Behavior.GLOBAL)[1])
        await gm._broadcast()
        assert gm.broadcast_errors == {"A:1": 1, "B:1": 1}
        assert gm.hints.pending("B:1") == 2  # b1's hits and its update
        # the peers heal; the next successful send to B replays B's hints
        for p in peers:
            p.fail = False
        gm.queue_hit(_script(RateLimitReq, Behavior.GLOBAL)[1])
        await gm._send_hits()
        assert gm.hints.pending("B:1") == 0
        assert gm.hints.replayed == {"B:1": 2}
        await gm.flush()  # the replayed hit and update go out
        gm.stop()
        return peers

    peers = asyncio.run(body())
    # b1: the first send (1 hit) and the replayed hint (1 hit) as windows
    assert peers[1].received == [[("b1", 1)], [("b1", 1)]]
    assert peers[1].updates == [[("g_b1", 98, 1, 60_000)]]
    # A was never sent to successfully: its hints wait
    assert peers[0].received == []


def test_hint_buffer_bounds_ttl_and_aggregation():
    clk = FakeClock()
    hb = HintBuffer(ttl=10.0, max_per_peer=2, now_fn=clk)
    hb.put("p", HINT_HITS, _r("a", hits=2))
    hb.put("p", HINT_HITS, _r("a", hits=3))  # aggregates
    hb.put("p", HINT_UPDATE, _r("a"))        # a distinct kind
    hb.put("p", HINT_HITS, _r("b"))          # evicts the oldest
    assert hb.expired == {"p": 1} and hb.queued == {"p": 3}
    clk.advance(11.0)
    assert hb.take("p") == [] and hb.expired == {"p": 3}
    hb.put("p", HINT_HITS, _r("c", hits=4))
    ((kind, req),) = hb.take("p")
    assert (kind, req.unique_key, req.hits) == (HINT_HITS, "c", 4)


def test_unwired_seams_are_the_jax_seams_without_peer_rpc():
    """No seam is left unwired: the seams the port crosses are the JAX
    package's three."""
    from gubernator_tpu.net import faults as jfaults
    assert faults_mod.WIRED_SEAMS == (
        jfaults.SEAM_PEER_RPC, jfaults.SEAM_SNAPSHOT_IO,
        jfaults.SEAM_ENGINE_DISPATCH)
    assert not hasattr(faults_mod, "_UNWIRED_SEAMS")
