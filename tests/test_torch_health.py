"""Failure handling in the port (net/health.py, Instance.rehome and
on_peer_recovered, the GLOBAL hints' replay, the snapshot_io and
engine_dispatch fault seams, the drain, the cluster's kill and stop), on
the CPU.

The mirror of tests/test_chaos.py's detector, re-home, hint-replay, flush,
engine_dispatch, snapshot_io, drain and cluster-stop tests.  Where the JAX
test runs on stand-ins (the detector on a stub Instance, the GLOBAL
manager on stub peers), both packages run on the same timeline and every
verdict, re-home, replay and send is compared.  The rest run against the
port's Instances and its loopback gRPC cluster; with the native router
and the pipelined lane (depth 3) an engine_dispatch rule fails exactly one
drain's callers and the answers after it equal a serial engine's that
never saw that drain.  A partitioned owner of a three-node ring is
confirmed down and re-homed around, then healed, re-homed back with its
keys migrated to it, and its hinted GLOBAL hits replayed.
"""

import asyncio

import pytest

import gubernator_tpu  # noqa: F401
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.api.types import RateLimitResp as JResp
from gubernator_tpu.api.types import Status as JStatus
from gubernator_tpu.config import BehaviorConfig as JBehaviorConfig
from gubernator_tpu.config import Config as JConfig
from gubernator_tpu.config import HealthConfig as JHealthConfig
from gubernator_tpu.config import QoSConfig as JQoSConfig
from gubernator_tpu.core.global_sync import GlobalManager as JGlobalManager
from gubernator_tpu.net.health import HeartbeatMonitor as JHeartbeatMonitor
from gubernator_tpu.qos import QoSManager as JQoSManager
from gubernator_tpu_torch import cluster as cluster_mod
from gubernator_tpu_torch.api.types import (
    Behavior,
    RateLimitReq,
    RateLimitResp,
    Status,
)
from gubernator_tpu_torch.config import (
    BehaviorConfig,
    EngineConfig,
    HealthConfig,
    QoSConfig,
)
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.core.global_sync import GlobalManager
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.net.faults import (
    FAULTS,
    SEAM_ENGINE_DISPATCH,
    SEAM_PEER_RPC,
    SEAM_SNAPSHOT_IO,
)
from gubernator_tpu_torch.net.health import (
    DOWN,
    SUSPECT,
    UP,
    HeartbeatMonitor,
)
from gubernator_tpu_torch.qos import QoSManager
from gubernator_tpu_torch.qos.admission import SHED_DRAINING
from gubernator_tpu_torch.qos.breaker import CLOSED, OPEN

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000


@pytest.fixture(autouse=True)
def _clean_faults():
    """Every test starts and ends with the port's injector disabled: a
    leaked rule would poison every later test in the process."""
    FAULTS.clear()
    yield
    FAULTS.clear()


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=120))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _req(key, hits=1, behavior=Behavior.BATCHING, limit=1000, cls=None):
    return (cls or RateLimitReq)(name="chaos", unique_key=key, hits=hits,
                                 limit=limit, duration=60_000,
                                 behavior=behavior)


# ------------------------------------------------------- failure detector


class StubRing:
    """Instance stand-in recording the detector's verdict actions."""

    def __init__(self, host="self:1"):
        self.advertise_address = host
        self.qos = None
        self.metrics = None
        self.rehomes = []
        self.recovered = []
        self.conf = JConfig()
        self.behaviors = BehaviorConfig()

    async def rehome(self, hosts, direction="down"):
        self.rehomes.append((tuple(hosts), direction))

    def on_peer_recovered(self, host):
        self.recovered.append(host)


class Twins:
    """The port's detector and the JAX detector, each on its own stub
    Instance, driven by one probe table on one fake clock."""

    def __init__(self, peers, ok, suspect_after=3, recover_after=2,
                 decorate=lambda inst, jax_side: None):
        async def probe(host):
            if not ok[host]:
                raise ConnectionError("probe refused")

        self.clock = FakeClock()
        self.port, self.jax = StubRing(), StubRing()
        decorate(self.port, False)
        decorate(self.jax, True)
        self.pmon = HeartbeatMonitor(
            self.port, peers, conf=HealthConfig(
                suspect_after=suspect_after, recover_after=recover_after),
            probe_fn=probe, now_fn=self.clock)
        self.jmon = JHeartbeatMonitor(
            self.jax, peers, conf=JHealthConfig(
                suspect_after=suspect_after, recover_after=recover_after),
            probe_fn=probe, now_fn=self.clock)

    async def round(self):
        await self.pmon.probe_once()
        await self.jmon.probe_once()
        self.clock.advance(1.0)
        snap = self.pmon.snapshot()
        assert snap == self.jmon.snapshot()
        assert self.port.rehomes == self.jax.rehomes
        assert self.port.recovered == self.jax.recovered
        assert self.pmon.membership() == self.jmon.membership()
        return snap

    def state(self, host):
        return self.pmon.snapshot()["peers"][host]["state"]


def test_detector_confirms_down_and_rehomes():
    async def body():
        ok = {"peer:2": True, "peer:3": True}
        t = Twins(["self:1", "peer:2", "peer:3"], ok, suspect_after=3)
        await t.round()
        assert t.state("peer:2") == UP
        ok["peer:2"] = False
        await t.round()  # miss 1: suspect, no verdict yet
        assert t.state("peer:2") == SUSPECT and t.port.rehomes == []
        await t.round()  # miss 2
        await t.round()  # miss 3: confirmed DOWN
        assert t.state("peer:2") == DOWN
        assert t.port.rehomes == [(("peer:3", "self:1"), "down")]
        ok["peer:2"] = True
        await t.round()  # recovery 1 of 2: still down
        assert t.state("peer:2") == DOWN
        await t.round()  # recovery 2: confirmed UP again
        assert t.state("peer:2") == UP
        assert t.port.rehomes[-1] == (("peer:2", "peer:3", "self:1"), "up")
        assert t.port.recovered == ["peer:2"]  # the hint replay

    run(body())


def test_detector_peer_down_releases_leases():
    """A confirmed-DOWN peer's concurrency leases are released
    (Instance.release_peer_leases); a failing release never blocks the
    re-home."""
    released = {False: [], True: []}

    def decorate(inst, jax_side):
        async def release(host):
            released[jax_side].append(host)
            if host == "peer:3":
                raise RuntimeError("book unavailable")
            return 3
        inst.release_peer_leases = release

    async def body():
        ok = {"peer:2": True, "peer:3": True}
        t = Twins(["self:1", "peer:2", "peer:3"], ok, suspect_after=2,
                  decorate=decorate)
        await t.round()
        ok["peer:2"] = False
        await t.round()
        await t.round()
        assert t.state("peer:2") == DOWN
        assert released[False] == released[True] == ["peer:2"]
        assert t.port.rehomes == [(("peer:3", "self:1"), "down")]
        ok["peer:3"] = False
        await t.round()
        await t.round()
        assert t.state("peer:3") == DOWN
        assert released[False] == released[True] == ["peer:2", "peer:3"]
        assert t.port.rehomes[-1] == (("self:1",), "down")

    run(body())


def test_detector_flap_hysteresis_never_churns_ring():
    """A peer failing every other probe never accumulates suspect_after
    consecutive misses: the ring never re-homes."""
    async def body():
        ok = {"peer:2": True}
        t = Twins(["self:1", "peer:2"], ok, suspect_after=3)
        for i in range(12):
            ok["peer:2"] = (i % 2 == 0)
            snap = await t.round()
        assert t.port.rehomes == []
        assert snap["peers"]["peer:2"]["failures"] == 6

    run(body())


def test_detector_force_trips_breaker():
    breakers = {}

    def decorate(inst, jax_side):
        inst.qos = (JQoSManager(JQoSConfig()) if jax_side
                    else QoSManager(QoSConfig()))
        breakers[jax_side] = inst.qos.make_breaker("peer:2")

    async def body():
        ok = {"peer:2": False}
        t = Twins(["self:1", "peer:2"], ok, suspect_after=2, decorate=decorate)
        await t.round()
        # suspicion alone trips nothing
        assert breakers[False].state == breakers[True].state == CLOSED
        await t.round()
        assert breakers[False].state == breakers[True].state == OPEN
        ok["peer:2"] = True
        await t.round()
        await t.round()
        assert breakers[False].state == breakers[True].state == CLOSED

    run(body())


def test_detector_run_loop_stops_and_observes_health():
    """start() probes every interval until stop(); each verdict lands in
    guber_peer_health_state."""
    from gubernator_tpu_torch.observability.metrics import Metrics

    async def body():
        inst = StubRing()
        inst.metrics = Metrics()
        seen = []

        async def probe(host):
            seen.append(host)
            raise ConnectionError("down")

        mon = HeartbeatMonitor(inst, ["self:1", "peer:2"],
                               conf=HealthConfig(heartbeat_interval=0.01,
                                                 suspect_after=2),
                               probe_fn=probe)
        mon.start()
        for _ in range(200):
            if inst.rehomes:
                break
            await asyncio.sleep(0.01)
        await mon.stop()
        n = len(seen)
        await asyncio.sleep(0.05)
        assert len(seen) == n  # stopped
        assert inst.rehomes == [(("self:1",), "down")]
        return inst.metrics.peer_health_state.labels(
            peer="peer:2")._value.get()

    assert run(body()) == 2.0  # down


# --------------------------------------------------- GLOBAL hinted handoff


class StubPeer:
    def __init__(self, host, fail=False):
        self.host = host
        self.is_owner = False
        self.fail = fail
        self.received = []
        self.updates = []

    async def get_peer_rate_limits(self, reqs):
        if self.fail:
            raise ConnectionError(f"{self.host} unreachable")
        self.received.extend(reqs)
        return [None] * len(reqs)

    async def update_peer_globals(self, globals_):
        if self.fail:
            raise ConnectionError(f"{self.host} unreachable")
        self.updates.append(list(globals_))


class StubOwnerInstance:
    """Instance stand-in for a GlobalManager: one remote owner peer."""

    def __init__(self, peer, resp_cls, under):
        self.peer = peer
        self.resp_cls = resp_cls
        self.under = under

    def get_peer(self, key):
        return self.peer

    def peer_list(self):
        return [self.peer]

    async def read_global_status(self, probe):
        return self.resp_cls(status=self.under, limit=probe.limit,
                             remaining=probe.limit)


class TwinManagers:
    """The port's GlobalManager and the JAX one, on stub owners with
    their own StubPeers, one fake clock."""

    def __init__(self, host, fail):
        self.clock = FakeClock()
        self.ppeer, self.jpeer = StubPeer(host, fail), StubPeer(host, fail)
        self.pm = GlobalManager(
            BehaviorConfig(global_sync_wait=0.01),
            StubOwnerInstance(self.ppeer, RateLimitResp, Status.UNDER_LIMIT),
            metrics=None, log=None,
            health=HealthConfig(hint_ttl=30.0, hint_max=64),
            now_fn=self.clock)
        self.jm = JGlobalManager(
            JBehaviorConfig(global_sync_wait=0.01),
            StubOwnerInstance(self.jpeer, JResp, JStatus.UNDER_LIMIT),
            metrics=None, log=None,
            health=JHealthConfig(hint_ttl=30.0, hint_max=64),
            now_fn=self.clock)
        self.pm.start()
        self.jm.start()

    def both(self, fn):
        return fn(self.pm, RateLimitReq), fn(self.jm, JReq)

    async def send(self, what):
        await getattr(self.pm, what)()
        await getattr(self.jm, what)()

    def heal(self):
        self.ppeer.fail = self.jpeer.fail = False

    def check(self):
        for attr in ("send_errors", "broadcast_errors"):
            assert getattr(self.pm, attr) == getattr(self.jm, attr)
        assert self.pm.hints.snapshot() == self.jm.hints.snapshot()
        assert ([(r.unique_key, r.hits) for r in self.ppeer.received]
                == [(r.unique_key, r.hits) for r in self.jpeer.received])
        assert ([[(u.key, u.status.remaining) for u in b]
                 for b in self.ppeer.updates]
                == [[(u.key, u.status.remaining) for u in b]
                    for b in self.jpeer.updates])

    def stop(self):
        self.pm.stop()
        self.jm.stop()


def test_send_failure_buffers_hints_then_replays():
    async def body():
        t = TwinManagers("owner:1", fail=True)
        for hits in (2, 3):
            t.both(lambda m, c: m.queue_hit(
                _req("a", hits=hits, behavior=Behavior.GLOBAL, cls=c)))
        await t.send("_send_hits")
        t.check()
        assert t.pm.send_errors == {"owner:1": 1}
        assert t.pm.hints.pending("owner:1") == 1  # aggregated
        t.heal()
        assert t.both(lambda m, c: m.replay_hints("owner:1")) == (1, 1)
        await t.send("_send_hits")
        t.check()
        assert [(r.unique_key, r.hits) for r in t.ppeer.received] == [
            ("a", 5)]  # 2 + 3 survived the outage
        assert t.pm.hints.pending("owner:1") == 0
        t.stop()

    run(body())


def test_hint_loss_is_bounded_by_ttl():
    async def body():
        t = TwinManagers("owner:1", fail=True)
        t.both(lambda m, c: m.queue_hit(
            _req("early", behavior=Behavior.GLOBAL, cls=c)))
        await t.send("_send_hits")
        t.clock.advance(31.0)  # past hint_ttl = 30
        t.both(lambda m, c: m.queue_hit(
            _req("late", behavior=Behavior.GLOBAL, cls=c)))
        await t.send("_send_hits")
        t.heal()
        assert t.both(lambda m, c: m.replay_hints("owner:1")) == (1, 1)
        await t.send("_send_hits")
        t.check()
        assert [r.unique_key for r in t.ppeer.received] == ["late"]
        assert t.pm.hints.expired.get("owner:1") == 1  # the bounded loss
        t.stop()

    run(body())


def test_broadcast_failure_buffers_and_replays_fresh_status():
    async def body():
        t = TwinManagers("replica:1", fail=True)
        t.both(lambda m, c: m.queue_update(
            _req("gk", hits=1, behavior=Behavior.GLOBAL, cls=c)))
        await t.send("_broadcast")
        t.check()
        assert t.pm.broadcast_errors == {"replica:1": 1}
        assert t.pm.hints.pending("replica:1") == 1
        t.heal()
        t.both(lambda m, c: m.replay_hints("replica:1"))
        await t.send("_broadcast")
        t.check()
        # the replica got a fresh authoritative status, not a stale one
        assert len(t.ppeer.updates) == 1
        assert t.ppeer.updates[0][0].status.remaining == 1000
        t.stop()

    run(body())


def test_global_flush_ships_queued_hits_on_shutdown():
    async def body():
        t = TwinManagers("owner:1", fail=False)
        t.both(lambda m, c: m.queue_hit(_req(
            "pending-at-shutdown", hits=7, behavior=Behavior.GLOBAL, cls=c)))
        await t.send("flush")
        t.stop()
        t.check()
        assert [(r.unique_key, r.hits) for r in t.ppeer.received] == [
            ("pending-at-shutdown", 7)]

    run(body())


# ------------------------------------------------------- engine dispatch


def _instance(qos_conf=None, use_native=False):
    inst = Instance(
        engine_config=EngineConfig(
            capacity_per_shard=2048, batch_per_shard=128,
            global_capacity=64, global_batch_per_shard=16,
            max_global_updates=16, use_native=use_native),
        qos=qos_conf or QoSConfig(), device="cpu")
    inst.engine.warmup()
    return inst


def test_engine_dispatch_fault_is_survivable():
    """An injected dispatch failure on the classic lane fails that
    window's waiters; the serving loop goes on and the next window
    serves."""
    async def body():
        inst = _instance()
        try:
            assert inst.batcher.pipeline is None
            FAULTS.seed(1)
            FAULTS.configure(SEAM_ENGINE_DISPATCH, drop=1.0, times=1)
            with pytest.raises(Exception, match="engine_dispatch"):
                await inst.get_rate_limits([_req("w1")])
            FAULTS.clear()
            resp = (await inst.get_rate_limits([_req("w2")]))[0]
            assert resp.error == "" and resp.remaining == 999
            # the failed window never reached the engine: w1 starts fresh
            resp = (await inst.get_rate_limits([_req("w1")]))[0]
            assert resp.remaining == 999
        finally:
            inst.close()

    run(body())


def _jobs(prefix, n_jobs, items):
    return [[RateLimitReq(name="pd", unique_key=f"{prefix}{j}.{i}",
                          hits=1 + (i % 3), limit=50, duration=60_000,
                          algorithm=i % 2)
             for i in range(items)] for j in range(n_jobs)]


@pytest.mark.parametrize("depth", [1, 3])
def test_engine_dispatch_fault_fails_one_drain_of_the_pipeline(monkeypatch,
                                                               depth):
    """The native router and the pipelined lane: one engine_dispatch rule
    (drop=1.0, times=1) fails exactly one drain, whose jobs (and only
    they) raise, each once.  The arena is full of live rows first, so the
    failed drain's keys took evicted slots: the router's staged
    allocations roll back, and every answer after the failure, the drains
    in flight beside it included, equals a serial engine's that never saw
    the failed drain (a committed allocation would hand a key its
    victim's row)."""
    monkeypatch.setenv("GUBER_PIPELINE_DEPTH", str(depth))
    inst = _instance(QoSConfig(enabled=False), use_native="auto")
    serial = RateLimitEngine(capacity_per_shard=8192, batch_per_shard=128,
                             global_capacity=64, device="cpu")
    pipe = inst.batcher.pipeline
    assert pipe is not None and pipe.depth == depth
    assert inst.engine.capacity_per_shard == 2048
    clock = lambda: T0  # noqa: E731
    inst.batcher.now_fn = pipe.now_fn = clock
    # one drain a submit while the lane is free; a drain takes what queued
    # behind it (at most 8 windows of 128 lanes)
    pipe.gate_enabled = False
    pipe.coalesce_wait = 0.0
    warm = _jobs("w", 21, 100)[:-1] + [_jobs("w", 21, 48)[-1]]
    first = _jobs("a", 12, 100)
    again = first + _jobs("b", 4, 100)

    async def body():
        for job in warm:  # 2048 live rows: the arena is full
            await inst.batcher.submit_now(job)
        FAULTS.seed(4)
        FAULTS.configure(SEAM_ENGINE_DISPATCH, drop=1.0, times=1)
        out1 = await asyncio.gather(
            *(inst.batcher.submit_now(job) for job in first),
            return_exceptions=True)
        out2 = [await inst.batcher.submit_now(job) for job in again]
        return out1, out2

    try:
        out1, out2 = run(body())
    finally:
        inst.close()
    assert sum(len(j) for j in warm) == 2048
    failed = [i for i, o in enumerate(out1) if isinstance(o, Exception)]
    assert failed and len(failed) < len(first)
    assert all("engine_dispatch" in str(out1[i]) for i in failed)
    assert FAULTS.describe()[SEAM_ENGINE_DISPATCH][0]["fired"] == 1
    for i, (job, got) in enumerate(zip(first, out1)):
        if i not in failed:
            assert _t(got) == _t(serial.process(job, now=T0)), i
    for i, (job, got) in enumerate(zip(again, out2)):
        assert _t(got) == _t(serial.process(job, now=T0)), i


def _t(resps):
    return [(int(r.status), r.limit, r.remaining, r.reset_time, r.error)
            for r in resps]


def test_instance_drain_with_fake_clock():
    async def body():
        inst = _instance(QoSConfig(max_pending=8))
        try:
            clk = FakeClock()

            async def fake_sleep(dt):
                clk.advance(1.0)

            # pending work that never resolves: the drain gives up at the
            # timeout on the fake clock instead of hanging
            inst.qos.admission.pending = 3
            assert await inst.drain(timeout=5.0, now_fn=clk,
                                    sleep=fake_sleep) is False
            assert inst.qos.admission.draining  # intake stays closed
            shed = (await inst.get_rate_limits([_req("late")]))[0]
            assert shed.metadata["shed_reason"] == SHED_DRAINING
            inst.qos.admission.pending = 0
            assert await inst.drain(timeout=5.0, now_fn=clk,
                                    sleep=fake_sleep) is True
        finally:
            inst.close()

    run(body())


# --------------------------------------------------------- snapshot faults


def test_faults_disabled_by_default_one_attribute_check(monkeypatch):
    """With no rule installed a seam crossing is one attribute check: the
    injector's decision machinery is never consulted."""
    from gubernator_tpu_torch.state import snapshot as snapmod
    assert FAULTS.enabled is False

    def boom(*a, **k):
        raise AssertionError("disabled path consulted the injector")

    monkeypatch.setattr(FAULTS, "_decide", boom)
    with pytest.raises(FileNotFoundError):  # not AssertionError
        snapmod.load("/nonexistent/guber-chaos.snap")


def test_snapshot_io_fault_degrades_not_crashes(tmp_path):
    from gubernator_tpu_torch.config import DaemonConfig
    from gubernator_tpu_torch.daemon import Daemon
    from gubernator_tpu_torch.observability.metrics import Metrics
    from gubernator_tpu_torch.state.snapshot import load, restore_engine

    async def body():
        inst = Instance(
            engine_config=EngineConfig(capacity_per_shard=256,
                                       batch_per_shard=64, global_capacity=16,
                                       use_native=False),
            device="cpu", metrics=Metrics())
        path = str(tmp_path / "arena.snap")
        try:
            await inst.get_rate_limits([_req("s1")])
            await inst.save_snapshot(path)  # a healthy save first
            before = open(path, "rb").read()
            FAULTS.seed(2)
            FAULTS.configure(SEAM_SNAPSHOT_IO, drop=1.0)
            with pytest.raises(OSError, match="snapshot_io"):
                await inst.save_snapshot(path)
            assert open(path, "rb").read() == before
            # a restore under an injected IO fault: a cold start
            assert restore_engine(inst.engine, path) is None
            FAULTS.clear()
            assert load(path).total_keys() == 1
            # the daemon's periodic save: the failure lands in metrics
            d = Daemon(DaemonConfig(snapshot_dir=str(tmp_path)))
            d.instance = inst
            FAULTS.configure(SEAM_SNAPSHOT_IO, drop=1.0)
            await d._snapshot_once()  # must not raise
            return inst.metrics.snapshot_total.labels(
                status="failed")._value.get()
        finally:
            FAULTS.clear()
            inst.close()

    assert run(body()) == 1


# ------------------------------------------------- clusters: kill and heal


def test_kill_owner_rehomes_within_suspicion_window():
    """A three-node loopback cluster loses the owner of live keys: the
    detectors on the survivors (real HealthCheck probes over gRPC) confirm
    it down within suspect_after rounds, both rings converge on the two
    survivors, and every key is then answered with no error."""
    async def body():
        c = await cluster_mod.start(3, device="cpu")
        monitors = []
        try:
            keys = [f"k{i}" for i in range(40)]
            inst0 = c.instance_at(0)
            for k in keys:
                await inst0.get_rate_limits([_req(k)])
            owner_hosts = {inst0.get_peer(f"chaos_{k}").host for k in keys}
            victim_idx = next(i for i in range(3)
                              if c.peer_at(i) in owner_hosts and i != 0)
            victim = c.peer_at(victim_idx)
            conf = HealthConfig(suspect_after=2, recover_after=2,
                                heartbeat_timeout=0.5)
            all_addrs = list(c.addresses)
            for i in range(3):
                if i != victim_idx:
                    inst = c.instance_at(i)
                    inst.monitor = HeartbeatMonitor(inst, all_addrs,
                                                    conf=conf)
                    monitors.append(inst.monitor)
            await c.kill_instance(victim_idx)
            for _ in range(2):
                for mon in monitors:
                    await mon.probe_once()
            for mon in monitors:
                assert mon.snapshot()["peers"][victim]["state"] == DOWN
            for n in c.nodes:
                hosts = sorted(p.host for p in n.instance.peer_list())
                assert victim not in hosts and len(hosts) == 2
                assert n.instance.metrics.ring_rehomes.labels(
                    direction="down")._value.get() == 1
            for n in c.nodes:
                resps = await n.instance.get_rate_limits(
                    [_req(k) for k in keys])
                for k, r in zip(keys, resps):
                    assert r.error == "", (n.address, k, r.error)
        finally:
            for mon in monitors:
                await mon.stop()
            await c.stop()

    run(body())


def test_partitioned_owner_rehomes_heals_and_replays_its_hints():
    """Three nodes on the Python tables, clocks pinned.  An injected
    partition (peer_rpc, match=victim) cuts the victim off: a survivor's
    GLOBAL hits meant for it are hinted, the survivors' detectors confirm
    it down and re-home (its keys restart cold there); healed, it is UP
    again after recover_after rounds, the ring re-homes to include it,
    the survivors ship the keys it owns back to it (fresher rows win),
    and the hinted hits replay: the owner's count equals an
    uninterrupted run's."""
    clock = FakeClock(T0)

    async def body():
        c = await cluster_mod.start(
            3, behaviors=BehaviorConfig(global_sync_wait=3600.0),
            engine=EngineConfig(capacity_per_shard=256, batch_per_shard=64,
                                num_shards=2, global_capacity=64,
                                global_batch_per_shard=16,
                                max_global_updates=16, use_native=False),
            device="cpu")
        monitors = []
        try:
            for n in c.nodes:
                n.instance.batcher.now_fn = clock
            insts = [n.instance for n in c.nodes]
            owner = lambda k: insts[0].get_peer(k).host  # noqa: E731
            victim = c.peer_at(1)
            vkeys = [f"k{i}" for i in range(200)
                     if owner(f"chaos_k{i}") == victim][:6]
            gkey = next(f"g{i}" for i in range(200)
                        if owner(f"chaos_g{i}") == victim)
            assert vkeys
            # before the partition: 2 hits on each victim key, and the
            # GLOBAL key registered on its owner
            for k in vkeys:
                await insts[0].get_rate_limits([_req(k, hits=2, limit=10)])
            await insts[1].get_rate_limits(
                [_req(gkey, hits=1, behavior=Behavior.GLOBAL)])
            conf = HealthConfig(suspect_after=2, recover_after=2)
            for i in (0, 2):
                insts[i].monitor = HeartbeatMonitor(insts[i], c.addresses,
                                                    conf=conf)
                monitors.append(insts[i].monitor)
            FAULTS.seed(5)
            FAULTS.configure(SEAM_PEER_RPC, drop=1.0, match=victim)
            # a survivor's GLOBAL hits for the cut-off owner are hinted
            gm = insts[0].global_mgr
            gm.queue_hit(_req(gkey, hits=4, behavior=Behavior.GLOBAL))
            await gm._send_hits()
            assert gm.hints.pending(victim) == 1
            for _ in range(2):
                for mon in monitors:
                    await mon.probe_once()
            for i in (0, 2):
                assert sorted(p.host for p in insts[i].peer_list()) == \
                    sorted(a for a in c.addresses if a != victim)
            # the victim's keys restart cold on the survivors
            clock.advance(1000)
            cold = await insts[2].get_rate_limits(
                [_req(k, hits=1, limit=10) for k in vkeys[:3]])
            assert [r.remaining for r in cold] == [9] * 3
            FAULTS.clear()  # heal the partition
            clock.advance(1000)
            for _ in range(2):
                for mon in monitors:
                    await mon.probe_once()
            for mon in monitors:
                assert mon.snapshot()["peers"][victim]["state"] == UP
            for i in (0, 2):
                assert len(insts[i].peer_list()) == 3
            # the rows written during the outage expire later: they moved
            # back over the victim's own; the other keys kept the victim's
            back = await insts[0].get_rate_limits(
                [_req(k, hits=1, limit=10) for k in vkeys])
            assert [r.remaining for r in back] == [8] * 3 + [7] * (
                len(vkeys) - 3)
            assert gm.hints.pending(victim) == 0
            await gm._send_hits()
            status = (await insts[1].get_rate_limits(
                [_req(gkey, hits=0, behavior=Behavior.GLOBAL)]))[0]
            return status
        finally:
            FAULTS.clear()
            for mon in monitors:
                await mon.stop()
            await c.stop()

    status = run(body())
    assert status.error == "" and status.remaining == 1000 - 1 - 4


def test_cluster_stop_survives_failing_node():
    """One failing server.stop() must not leak the later nodes: every node
    is torn down and the error surfaces after."""
    async def body():
        c = await cluster_mod.start_with(["127.0.0.1:0", "127.0.0.1:0"],
                                         device="cpu")

        async def explode(grace=None):
            raise RuntimeError("stop failed")

        c.nodes[0].server.stop = explode
        closed = []
        orig_close = c.nodes[1].instance.close
        c.nodes[1].instance.close = lambda: (closed.append(1),
                                             orig_close())[1]
        with pytest.raises(RuntimeError, match="stop failed"):
            await c.stop()
        assert closed == [1]
        assert c.nodes == []

    run(body())
