"""The port's multi-process front door (gubernator_tpu_torch/frontdoor.py)
against its single-process daemon and against the JAX package's front
door: the mirror of JAX tests/test_frontdoor.py.

Three daemons serve the same RPC stream on one pinned clock: the port's
daemon with 2 front-door workers (`fd`), the port's in-process server
(`oracle`, workers=0) and the JAX daemon with 2 workers (`jfd`).  Every
GetRateLimits response is compared byte for byte across the three; shed
responses, whose 2-entry metadata map protobuf serializes in no defined
order, are compared parsed, by reason.  The cases: columnar batches (at
least FASTPATH_MIN_BYTES, C-parsed in the worker), small RAW batches and
both sides of the size floor, GLOBAL streams, coalesced wire reads
(KIND_BATCH_COLS), draining and ring-full sheds, HealthCheck answered by
the worker, a worker's crash (no partial commit, a respawn on the same
port), a stale epoch's completion, forwarded decisions on a cluster node,
the metric families and the debug view.  Then what the port adds: its
worker processes load no torch, its hub's engine side runs without grpc,
a SIGTERM'd daemon exits 0 leaving no segment and no resource-tracker
complaint, and chip_smoke.py's account of RPCs failed by a worker's
SIGKILL catches an RPC staged in part or twice.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import gubernator_tpu.core.engine as jengine
from gubernator_tpu import compat
from gubernator_tpu.config import DaemonConfig as JDaemonConfig
from gubernator_tpu.config import EngineConfig as JEngineConfig
from gubernator_tpu.daemon import Daemon as JDaemon
from gubernator_tpu_torch.api import pb
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    Status,
)
from gubernator_tpu_torch.client import AsyncClient
from gubernator_tpu_torch.config import DaemonConfig, EngineConfig
from gubernator_tpu_torch.core import shm_ring
from gubernator_tpu_torch.daemon import Daemon
from gubernator_tpu_torch.frontdoor import FrontdoorHub
from gubernator_tpu_torch.qos.admission import (
    SHED_DRAINING,
    SHED_RING_FULL,
    shed_response,
)
from gubernator_tpu_torch.server import FASTPATH_MIN_BYTES

pytestmark = pytest.mark.torch_port

MINUTE = 60_000
T0 = 1_800_000_000_000
ROOT = Path(__file__).resolve().parents[1]
_GRL = "/pb.gubernator.V1/GetRateLimits"


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


def run(loop, coro, timeout=180):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout=timeout))


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture(scope="module")
def pinned():
    """One clock for every daemon of the module (each package's
    millisecond_now, wherever a module imported it, returns T0), and the
    JAX shard_map's replication check off, as the installed JAX needs."""
    mp = pytest.MonkeyPatch()
    for name, mod in list(sys.modules.items()):
        if (name.split(".")[0] in ("gubernator_tpu", "gubernator_tpu_torch")
                and hasattr(mod, "millisecond_now")):
            mp.setattr(mod, "millisecond_now", lambda: T0)
    mp.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()
    yield
    mp.undo()
    _clear_jax_executable_caches()


def _pin(inst):
    inst.batcher.now_fn = lambda: T0
    if inst.batcher.pipeline is not None:
        inst.batcher.pipeline.now_fn = lambda: T0


def _conf(workers, **kw):
    return DaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        frontdoor_workers=workers, device="cpu",
        engine=EngineConfig(capacity_per_shard=256, batch_per_shard=64,
                            num_shards=8), **kw)


@pytest.fixture(scope="module")
def oracle(loop, pinned, jfd):
    """The port's single-process serving (workers=0).  Built after the
    JAX daemon: that one's boot holds the module's loop for longer than
    a front door's workers wait for their engine's heartbeat."""
    d = Daemon(_conf(0))
    run(loop, d.start())
    _pin(d.instance)
    yield d
    run(loop, d.stop())


@pytest.fixture(scope="module")
def fd(loop, pinned, jfd):
    """The port's daemon with 2 front-door workers."""
    d = Daemon(_conf(2))
    run(loop, d.start())
    _pin(d.instance)
    yield d
    run(loop, d.stop())


@pytest.fixture(scope="module")
def jfd(loop, pinned):
    """The JAX daemon with 2 front-door workers."""
    d = JDaemon(JDaemonConfig(
        grpc_listen_address="127.0.0.1:0", http_listen_address="127.0.0.1:0",
        frontdoor_workers=2,
        engine=JEngineConfig(capacity_per_shard=2048, batch_per_shard=256)))
    run(loop, d.start())
    _pin(d.instance)
    yield d
    run(loop, d.stop())


@pytest.fixture(scope="module")
def solo_hub(loop, oracle):
    """A one-worker, two-slot hub on the oracle's Instance: small enough
    to fill its ring on demand, isolated enough to crash.  batch_reads=1
    turns coalescing off, so every RPC holds a slot of its own."""
    hub = FrontdoorHub(oracle.instance, workers=1, ring_slots=2,
                       slab_bytes=DaemonConfig.shm_slab_bytes,
                       listen_address="127.0.0.1:0", batch_reads=1)
    run(loop, hub.start())
    yield hub
    run(loop, hub.stop())


def _pause_consumer(hub):
    hub._stop_evt.set()
    hub._consumer.join(timeout=10)
    assert not hub._consumer.is_alive()


def _resume_consumer(hub):
    hub._stop_evt = threading.Event()
    t = threading.Thread(target=hub._consume_loop,
                         name="frontdoor-consumer", daemon=True)
    t.start()
    hub._consumer = t


def req(name, key, hits=1, limit=1000, duration=MINUTE,
        algo=Algorithm.TOKEN_BUCKET, behavior=Behavior.BATCHING):
    return RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                        duration=duration, algorithm=algo, behavior=behavior)


def _encode(batch):
    return pb.GetRateLimitsReq(
        requests=[pb.req_to_pb(r) for r in batch]).SerializeToString()


class _Raw:
    """GetRateLimits as bytes in, bytes out on one channel."""

    def __init__(self, address):
        import grpc
        self.ch = grpc.aio.insecure_channel(address)
        self.call = self.ch.unary_unary(_GRL)

    async def __call__(self, batch, timeout=60):
        return await self.call(_encode(batch), timeout=timeout)

    async def close(self):
        await self.ch.close()


def _parsed(out):
    return [(r.status, r.limit, r.remaining, r.reset_time, r.error,
             dict(r.metadata))
            for r in pb.GetRateLimitsResp.FromString(out).responses]


def _same(outs, what):
    """Byte for byte across the daemons (parsed where a shed's metadata
    map makes the serialized order undefined)."""
    first = outs[0]
    for o in outs[1:]:
        if any(r[5] for r in _parsed(first)):
            assert _parsed(o) == _parsed(first), what
        else:
            assert o == first, what


async def _differential(daemons, batches):
    """Send the same stream to every daemon, in turn, and compare each
    response across them; returns the port front door's responses."""
    clients = [_Raw(_address(d)) for d in daemons]
    got = []
    try:
        for tag, batch in batches:
            outs = [await c(batch) for c in clients]
            _same(outs, tag)
            got.append(_parsed(outs[0]))
    finally:
        for c in clients:
            await c.close()
    return got


def _address(d):
    return d.frontdoor.address if d.frontdoor is not None else d.grpc.address


def test_workers0_boots_classic_path(oracle, fd):
    assert oracle.frontdoor is None and oracle.grpc is not None
    assert oracle.instance.frontdoor is None
    # workers > 0: the hub only; the engine binds no public gRPC port
    assert fd.frontdoor is not None and fd.grpc is None
    assert fd.instance.frontdoor is fd.frontdoor
    assert fd.frontdoor.address.startswith("127.0.0.1:")


def test_differential_cols_stream(loop, fd, oracle, jfd):
    """The columnar lane: batches big enough for the worker's C parse,
    over three rounds so state carries."""
    batch = [req("fd_cols", f"acct:{i:04d}", limit=3) for i in range(100)]
    assert len(_encode(batch)) >= FASTPATH_MIN_BYTES
    kinds0 = dict(fd.frontdoor.records_by_kind)
    got = run(loop, _differential(
        [fd, oracle, jfd], [(f"cols round {n}", batch) for n in range(4)]))
    assert [g[0][2] for g in got] == [2, 1, 0, 0]
    assert got[3][0][0] == Status.OVER_LIMIT
    cols = (fd.frontdoor.records_by_kind.get(shm_ring.KIND_COLS, 0)
            - kinds0.get(shm_ring.KIND_COLS, 0))
    assert cols == 4


def test_differential_raw_small(loop, fd, oracle, jfd):
    """Below the fastpath floor the worker ships RAW bytes; the over-limit
    transition matches item for item."""
    batches = [("small", [req("fd_raw", "only", limit=5)])]
    batches += [(f"overlimit {n}", [req("fd_raw_over", "k", limit=3)])
                for n in range(7)]
    kinds0 = dict(fd.frontdoor.records_by_kind)
    got = run(loop, _differential([fd, oracle, jfd], batches))
    assert [g[0][2] for g in got[1:]] == [2, 1, 0, 0, 0, 0, 0]
    assert (fd.frontdoor.records_by_kind.get(shm_ring.KIND_RAW, 0)
            - kinds0.get(shm_ring.KIND_RAW, 0)) == 8


def test_differential_fastpath_boundary(loop, fd, oracle, jfd):
    under = [req("fd_edge_u", f"k{i}", algo=i % 2) for i in range(8)]
    over = [req("fd_edge_o", f"key:{i:05d}", algo=i % 2) for i in range(90)]
    assert len(_encode(under)) < FASTPATH_MIN_BYTES <= len(_encode(over))
    run(loop, _differential([fd, oracle, jfd], [
        ("under floor", under), ("over floor", over),
        ("under again", under), ("over again", over)]))


def test_differential_global_behavior(loop, fd, oracle, jfd):
    """GLOBAL items: the C parser refuses them, so they ride RAW records
    into the GLOBAL window; both serving modes and the JAX front door
    answer alike."""
    batch = [req("fd_glob", f"g:{i}", behavior=Behavior.GLOBAL, limit=50)
             for i in range(40)]
    got = run(loop, _differential(
        [fd, oracle, jfd], [(f"global round {n}", batch) for n in range(2)]))
    assert all(g[0] == Status.UNDER_LIMIT for r in got for g in r)


def test_differential_mixed_algorithms(loop, fd, oracle, jfd):
    """Every compact algorithm in one columnar batch, and a batch the
    parser refuses (a CONCURRENCY item) that ships RAW."""
    cols = [req("fd_mix", f"m:{i:04d}", limit=4, algo=i % 4)
            for i in range(100)]
    raw = cols[:60] + [req("fd_mix", "lease", limit=2,
                           algo=Algorithm.CONCURRENCY)]
    run(loop, _differential([fd, oracle, jfd], [
        ("mixed 0", cols), ("mixed 1", cols), ("refused", raw),
        ("mixed 2", cols)]))


def test_shed_draining_matches_single_process(loop, fd, jfd):
    """The worker's in-band draining shed is the item the engine's
    admission controller builds, as in the JAX front door."""
    batch = [req("fd_drain", f"d:{i}", limit=7) for i in range(5)]

    async def body():
        outs = []
        for d in (fd, jfd):
            raw = _Raw(d.frontdoor.address)
            d.frontdoor.status.set_flag(shm_ring.FLAG_DRAINING, True)
            try:
                await asyncio.sleep(0)
                outs.append(await raw(batch, timeout=30))
            finally:
                d.frontdoor.status.set_flag(shm_ring.FLAG_DRAINING, False)
                await raw.close()
        return outs

    sheds0 = fd.frontdoor.stats()["sheds"]
    outs = run(loop, body())
    want = [(int(r.status), r.limit, r.remaining, r.reset_time, r.error,
             r.metadata)
            for r in (shed_response(q, SHED_DRAINING) for q in batch)]
    assert _parsed(outs[0]) == want == _parsed(outs[1])
    assert all(w[5]["shed_reason"] == SHED_DRAINING for w in want)
    assert fd.frontdoor.stats()["sheds"] - sheds0 == len(batch)


def test_ring_overflow_sheds_ring_full(loop, solo_hub):
    """Every slab in flight: the worker sheds in-band with
    shed_reason=ring_full instead of queueing."""
    hub = solo_hub

    async def body():
        cl = AsyncClient(hub.address)
        stalls0 = hub.status.get_w(0, shm_ring.W_STALLS)
        _pause_consumer(hub)
        try:
            inflight = [
                asyncio.ensure_future(cl.get_rate_limits(
                    [req("fd_full", f"f:{i}")], timeout=60))
                for i in range(2)
            ]
            deadline = time.monotonic() + 20
            while hub.chans[0].sub_depth() < 2:
                assert time.monotonic() < deadline, "slots never filled"
                await asyncio.sleep(0.01)
            shed = await cl.get_rate_limits(
                [req("fd_full", "f:extra", limit=9)], timeout=30)
        finally:
            _resume_consumer(hub)
        served = await asyncio.gather(*inflight)
        await cl.close()
        assert shed[0].status == Status.OVER_LIMIT
        assert shed[0].remaining == 0 and shed[0].limit == 9
        assert shed[0].metadata == {"shed": "true",
                                    "shed_reason": SHED_RING_FULL}
        assert hub.status.get_w(0, shm_ring.W_STALLS) > stalls0
        for rs in served:
            assert rs[0].status == Status.UNDER_LIMIT
            assert rs[0].error == ""

    run(loop, body())


def test_healthcheck_isolated_from_engine(loop, solo_hub):
    """HealthCheck is answered from the status block: it answers, fast,
    while the engine consumes nothing."""
    hub = solo_hub

    async def body():
        cl = AsyncClient(hub.address)
        hc0 = hub.status.get_w(0, shm_ring.W_HEALTHCHECKS)
        _pause_consumer(hub)
        try:
            t0 = time.monotonic()
            h = await cl.health_check(timeout=5)
            rtt = time.monotonic() - t0
        finally:
            _resume_consumer(hub)
        await cl.close()
        assert h.status == "healthy"
        assert rtt < 2.0
        assert hub.status.get_w(0, shm_ring.W_HEALTHCHECKS) > hc0
        assert hub.chans[0].sub_depth() == 0

    run(loop, body())


async def _await_restart(hub, restarts0):
    deadline = time.monotonic() + 60
    while hub.restarts == restarts0:
        assert time.monotonic() < deadline, "worker never restarted"
        await asyncio.sleep(0.1)


async def _await_healthy(address):
    cl = AsyncClient(address)
    deadline = time.monotonic() + 60
    while True:
        try:
            h = await cl.health_check(timeout=2)
            if h.status == "healthy":
                return cl
        except Exception:
            pass
        assert time.monotonic() < deadline, "respawn never came up"
        await asyncio.sleep(0.25)


def test_worker_crash_no_partial_commit_then_restart(loop, solo_hub):
    """SIGKILL the worker with a hit submitted but not consumed: the ring
    reset drops it (no partial commit), the respawn re-claims the same
    port, and the key's counter carries on from its pre-crash value."""
    hub = solo_hub

    async def body():
        cl = AsyncClient(hub.address)
        for want in (9, 8):
            rs = await cl.get_rate_limits(
                [req("fd_crash", "victim", limit=10)], timeout=60)
            assert rs[0].remaining == want
        pid0 = hub.status.get_w(0, shm_ring.W_PID)
        port0, served0, restarts0 = hub.port, hub.records_served, hub.restarts
        _pause_consumer(hub)
        doomed = asyncio.ensure_future(cl.get_rate_limits(
            [req("fd_crash", "victim", limit=10)], timeout=60))
        deadline = time.monotonic() + 20
        while hub.chans[0].sub_depth() < 1:
            assert time.monotonic() < deadline, "record never submitted"
            await asyncio.sleep(0.01)
        os.kill(pid0, signal.SIGKILL)
        with pytest.raises(Exception):
            await doomed
        await cl.close()
        await _await_restart(hub, restarts0)
        assert hub.chans[0].sub_depth() == 0
        assert hub.epochs[0] >= 1
        _resume_consumer(hub)
        await asyncio.sleep(0.3)
        assert hub.records_served == served0  # the orphan was never served
        cl2 = await _await_healthy(hub.address)
        assert hub.status.get_w(0, shm_ring.W_PID) != pid0
        assert hub.port == port0
        snap = hub.debug_snapshot()
        assert snap["restarts"] >= 1
        assert snap["per_worker"][0]["restarts"] >= 1
        rs = await cl2.get_rate_limits(
            [req("fd_crash", "victim", limit=10)], timeout=60)
        assert rs[0].remaining == 7
        await cl2.close()

    run(loop, body(), timeout=300)


def test_stale_epoch_completion_not_encoded(loop, solo_hub):
    """A record the engine popped before a worker's crash is never
    completed into the respawned worker's slab: the epoch guard drops
    the stale completion."""
    hub = solo_hub

    async def body():
        cl = AsyncClient(hub.address)
        pid0 = hub.status.get_w(0, shm_ring.W_PID)
        restarts0 = hub.restarts
        _pause_consumer(hub)
        doomed = asyncio.ensure_future(cl.get_rate_limits(
            [req("fd_stale", "victim", limit=10)], timeout=60))
        deadline = time.monotonic() + 20
        while hub.chans[0].sub_depth() < 1:
            assert time.monotonic() < deadline, "record never submitted"
            await asyncio.sleep(0.01)
        with hub._locks[0]:
            recs = hub.chans[0].pop()
            epoch0 = hub.epochs[0]
        assert recs
        os.kill(pid0, signal.SIGKILL)
        with pytest.raises(Exception):
            await doomed
        await cl.close()
        await _await_restart(hub, restarts0)
        comp0 = int(hub.chans[0]._hdr[shm_ring._COMP_TAIL])
        served0 = hub.records_served
        for rec in recs:
            await hub._serve(0, epoch0, rec)
        assert hub.records_served == served0 + len(recs)
        assert int(hub.chans[0]._hdr[shm_ring._COMP_TAIL]) == comp0
        assert hub.chans[0].inflight() == 0
        _resume_consumer(hub)
        cl2 = AsyncClient(hub.address)
        deadline = time.monotonic() + 60
        while True:
            try:
                rs = await cl2.get_rate_limits(
                    [req("fd_stale", "fresh", limit=10)], timeout=5)
                break
            except Exception:
                assert time.monotonic() < deadline, "respawn never came up"
                await asyncio.sleep(0.25)
        assert rs[0].status == Status.UNDER_LIMIT and rs[0].remaining == 9
        await cl2.close()

    run(loop, body(), timeout=300)


def test_forwarded_decisions_through_frontdoor(loop):
    """A hub on one cluster node: keys the other node owns are forwarded
    on the engine side and share state with the in-process server."""
    from gubernator_tpu_torch import cluster as cluster_mod

    async def body():
        c = await cluster_mod.start(2, device="cpu")
        hub = None
        try:
            hub = FrontdoorHub(c.instance_at(0), workers=1, ring_slots=8,
                               slab_bytes=DaemonConfig.shm_slab_bytes,
                               listen_address="127.0.0.1:0")
            await hub.start()
            # with ring peers installed the columnar lane is closed
            assert not hub.status.flag(shm_ring.FLAG_COLS_OK)
            inst0 = c.instance_at(0)
            key = next(f"peer:{i}" for i in range(256)
                       if inst0.get_peer(f"fd_fwd_peer:{i}").host
                       != inst0.advertise_address)
            direct = AsyncClient(c.peer_at(0))
            fronted = AsyncClient(hub.address)
            for client, want in ((direct, 3), (fronted, 2), (direct, 1),
                                 (fronted, 0)):
                rs = await client.get_rate_limits(
                    [req("fd_fwd", key, limit=4)], timeout=60)
                assert rs[0].status == Status.UNDER_LIMIT
                assert rs[0].remaining == want and rs[0].error == ""
            rs = await fronted.get_rate_limits(
                [req("fd_fwd", key, limit=4)], timeout=60)
            assert rs[0].status == Status.OVER_LIMIT
            # the forwarded answer's owner annotation is metadata the
            # columns cannot carry: the engine encoded it
            assert rs[0].metadata.get("owner")
            assert hub.encode_fallbacks >= 1
            await direct.close()
            await fronted.close()
        finally:
            if hub is not None:
                await hub.stop()
            await c.stop()

    run(loop, body(), timeout=300)


def test_frontdoor_observability_surface(loop, fd, jfd):
    """The debug snapshot and the metric families, beside the JAX front
    door's."""
    snap = fd.frontdoor.debug_snapshot()
    assert snap["workers"] == 2 and len(snap["per_worker"]) == 2
    assert all(r["pid"] > 0 for r in snap["per_worker"])
    assert snap["port_mode"] in ("reuseport", "per-worker-ports")
    assert snap["encode_mode"] == "worker"
    assert set(snap) == set(jfd.frontdoor.debug_snapshot())
    assert (set(snap["per_worker"][0])
            == set(jfd.frontdoor.debug_snapshot()["per_worker"][0]))

    def families(d):
        text = d.instance.metrics.expose().decode()
        return {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE guber_tpu_frontdoor")
                or ln.startswith("# TYPE guber_tpu_shm_ring")}

    mine = families(fd)
    assert mine == families(jfd)
    for fam in ("guber_tpu_frontdoor_workers",
                "guber_tpu_frontdoor_rpcs", "guber_tpu_frontdoor_sheds",
                "guber_tpu_frontdoor_restarts",
                "guber_tpu_frontdoor_encode",
                "guber_tpu_frontdoor_batched_rpcs",
                "guber_tpu_shm_ring_depth", "guber_tpu_shm_ring_stalls"):
        assert fam in mine or fam + "_total" in mine, fam
    text = fd.instance.metrics.expose().decode()
    assert "guber_tpu_frontdoor_workers 2.0" in text
    assert 'guber_tpu_frontdoor_encode_total{path="worker",worker=' in text


def test_admin_debug_route_reports_the_front_door(loop, fd, jfd):
    """GET /v1/admin/debug: the sections the port serves, the front door
    among them, each with the JAX view's keys."""
    import aiohttp

    async def get(d):
        async with aiohttp.ClientSession() as s:
            assert d.http.port
            url = f"http://127.0.0.1:{d.http.port}/v1/admin/debug"
            async with s.get(url) as r:
                assert r.status == 200
                return await r.json()

    from gubernator_tpu.observability.introspect import (
        build_debug_snapshot,
    )
    mine = run(loop, get(fd))
    theirs = json.loads(json.dumps(build_debug_snapshot(jfd.instance),
                                   default=str))
    assert {"engine", "admission", "congestion", "peers", "global_sync",
            "frontdoor", "pipeline", "stages", "tracing", "profile",
            "devprof"} <= set(mine)
    # neither daemon runs an SLO engine
    assert "slo" not in mine and "slo" not in theirs
    assert set(mine) - {"pipeline"} <= set(theirs)
    for sec in ("admission", "congestion", "global_sync", "frontdoor",
                "tracing", "profile", "devprof"):
        assert set(mine[sec]) == set(theirs[sec]), sec
    assert mine["frontdoor"]["workers"] == 2
    assert mine["standalone"] is True
    json.dumps(mine)


def test_differential_batched_wire_reads(loop, fd, oracle, jfd):
    """Concurrent small RPCs on one connection coalesce into multi-RPC
    records (KIND_BATCH_COLS: one slab, one publish, one columnar
    completion split back per RPC).  Each answer equals the in-process
    server's and the JAX front door's, and the counters show the
    coalesced path ran."""

    async def body():
        clients = [_Raw(_address(d)) for d in (fd, oracle, jfd)]
        st0 = fd.frontdoor.stats()
        kinds0 = dict(fd.frontdoor.records_by_kind)
        try:
            for rnd in range(20):
                singles = [[req("fd_batchr", f"b:{rnd}:{i}", limit=9)]
                           for i in range(32)]
                outs = [await asyncio.gather(*[c(b) for b in singles])
                        for c in clients]
                for i in range(len(singles)):
                    _same([o[i] for o in outs], f"batched {rnd}:{i}")
                st = fd.frontdoor.stats()
                if st["batch_flushes"] > st0["batch_flushes"]:
                    break
        finally:
            for c in clients:
                await c.close()
        st = fd.frontdoor.stats()
        assert st["batch_flushes"] > st0["batch_flushes"]
        assert (st["batch_rpcs"] - st0["batch_rpcs"]
                >= 2 * (st["batch_flushes"] - st0["batch_flushes"]))
        assert st["encodes"] > st0["encodes"]
        assert (fd.frontdoor.records_by_kind.get(shm_ring.KIND_BATCH_COLS, 0)
                > kinds0.get(shm_ring.KIND_BATCH_COLS, 0))

    run(loop, body(), timeout=300)


def test_engine_encode_mode_answers_alike(loop, oracle):
    """GUBER_FRONTDOOR_ENCODE=engine: the engine serializes every
    response, and a hub in that mode on the oracle's Instance answers as
    its in-process server does, byte for byte, on keys of its own."""
    hub = FrontdoorHub(oracle.instance, workers=1, ring_slots=8,
                       slab_bytes=DaemonConfig.shm_slab_bytes,
                       listen_address="127.0.0.1:0", encode="engine")

    def rounds(name):
        big = [req(name, f"e:{i:04d}", limit=4) for i in range(100)]
        small = [req(name + "_s", "one", limit=4)]
        return [big, small, big, small, big]

    async def body():
        await hub.start()
        fronted, direct = _Raw(hub.address), _Raw(oracle.grpc.address)
        try:
            got = [await fronted(b) for b in rounds("fd_eng_f")]
            want = [await direct(b) for b in rounds("fd_eng_d")]
            return got, want, hub.stats()
        finally:
            await fronted.close()
            await direct.close()
            await hub.stop()

    got, want, st = run(loop, body())
    assert got == want
    assert [_parsed(g)[0][2] for g in got] == [3, 3, 2, 2, 1]
    # every response was engine-encoded bytes; none worker-encoded
    assert st["encodes"] == 0 and st["enc_fallbacks"] == 5


def test_columnar_record_carries_the_callers_trace(loop, fd):
    """A traced columnar RPC: the worker stamps the caller's traceparent
    into the slab's trace region, and the hub roots the engine's `rpc`
    span in the caller's trace, as the in-process servicer does."""
    trace_id, parent = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
    tracer = fd.instance.tracer
    batch = [req("fd_trace", f"t:{i:04d}") for i in range(100)]

    async def body():
        import grpc
        ch = grpc.aio.insecure_channel(fd.frontdoor.address)
        try:
            call = ch.unary_unary(_GRL)
            return await call(_encode(batch), timeout=60, metadata=(
                ("traceparent", f"00-{trace_id}-{parent}-01"),))
        finally:
            await ch.close()

    tracer.sample = 1.0
    try:
        out = run(loop, body())
    finally:
        tracer.sample = 0.0
    assert len(_parsed(out)) == 100
    roots = [sp for sp in tracer.spans(trace_id) if sp.name == "rpc"]
    assert len(roots) == 1 and roots[0].parent_id == parent


# ---------------------------------------------------- what the port adds


def test_worker_processes_load_no_torch(fd):
    """The workers are fresh interpreters running the package's
    worker_main: no torch, no jax and no JAX package in their address
    space, and no CUDA."""
    for row in fd.frontdoor.debug_snapshot()["per_worker"]:
        pid = row["pid"]
        maps = Path(f"/proc/{pid}/maps").read_text()
        assert "libtorch" not in maps and "libjax" not in maps, pid
        assert "libcuda" not in maps, pid
        cmd = Path(f"/proc/{pid}/cmdline").read_bytes().decode()
        assert "gubernator_tpu_torch.frontdoor import worker_main" in cmd


_NO_GRPC_SCRIPT = r"""
import asyncio, sys, tempfile
sys.modules["grpc"] = None
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.config import EngineConfig
from gubernator_tpu_torch.frontdoor import FrontdoorHub
from gubernator_tpu_torch import frontdoor_replay as fr

async def main(rpcs):
    inst = Instance(engine_config=EngineConfig(
        capacity_per_shard=256, batch_per_shard=64, num_shards=2),
        device="cpu")
    inst.batcher.now_fn = lambda: 1_800_000_000_000
    inst.batcher.pipeline.now_fn = lambda: 1_800_000_000_000
    ctl = tempfile.mkdtemp()
    hub = FrontdoorHub(inst, workers=2, ring_slots=16, slab_bytes=1 << 18,
                       listen_address="127.0.0.1:0",
                       worker_entry="gubernator_tpu_torch.frontdoor_replay:"
                                    "replay_main", worker_args=(ctl,))
    await hub.start()
    try:
        fr.write_command(ctl, 0, [dict(mode="burst", rpcs=rpcs[0::2],
                                       callers=4),
                                  dict(mode="burst", rpcs=rpcs[1::2],
                                       callers=4)])
        res = await fr.await_results(ctl, 0, 2, timeout=120)
        fr.write_command(ctl, 1, [dict(mode="stop")] * 2)
        out = [None] * len(rpcs)
        out[0::2], out[1::2] = res[0]["resps"], res[1]["resps"]
        kinds = dict(hub.records_by_kind)
    finally:
        await hub.stop()
        inst.close()
    return out, kinds, [m for m in sys.modules
                        if m.split(".")[0] == "grpc"
                        and sys.modules[m] is not None]

rpcs = [bytes.fromhex(h) for h in sys.argv[1].split(",")]
out, kinds, loaded = asyncio.run(main(rpcs))
print(",".join(o.hex() if o is not None else "-" for o in out))
print(sorted(kinds.items()), loaded)
"""


def test_hub_engine_side_runs_without_grpc(tmp_path):
    """The engine process imports no grpc to serve the front door: with
    grpc made unimportable, replay workers
    (frontdoor_replay.py) send columnar batches, small RPCs and GLOBAL
    items, and every answer decodes to the in-process engine's."""
    big = [req("ng", f"k{i:04d}", limit=5) for i in range(100)]
    small = [req("ng_s", "one", limit=5)]
    glob = [req("ng_g", "g", limit=5, behavior=Behavior.GLOBAL)]
    batches = [big, small, glob, big, small, glob]
    arg = ",".join(_encode(b).hex() for b in batches)
    res = subprocess.run([sys.executable, "-c", _NO_GRPC_SCRIPT, arg],
                         capture_output=True, text=True, timeout=240,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    outs = [bytes.fromhex(h) for h in lines[-2].split(",")]
    assert lines[-1].endswith("[]"), lines[-1]  # grpc was not loaded
    assert "(0," in lines[-1] and ("(1," in lines[-1] or "(7," in lines[-1])
    got = [_parsed(o) for o in outs]
    assert len(got) == 6
    assert all(len(g) == len(b) for g, b in zip(got, batches))
    # the two big batches met the same keys: 4 then 3 remaining, in one
    # order or the other; every answer under the limit
    assert sorted({g[0][2] for g in (got[0], got[3])}) == [3, 4]
    assert sorted(g[0][2] for g in (got[1], got[4])) == [3, 4]
    # GLOBAL hits of one window may both answer from the replica as it
    # stood before the window
    assert {g[0][2] for g in (got[2], got[5])} <= {3, 4}
    assert all(r[0] == Status.UNDER_LIMIT and r[4] == "" for g in got
               for r in g)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_sigterm_daemon_exits_clean_and_leaves_no_segment(tmp_path):
    """`python -m gubernator_tpu_torch.daemon` with 2 workers, served
    once, then SIGTERM: exit code 0, no resource_tracker warning or
    KeyError on stderr, and no shared-memory segment of its hub left in
    /dev/shm."""
    grpc_port, http_port = _free_port(), _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("GUBER_")}
    env.update(GUBER_TORCH_DEVICE="cpu",
               GUBER_GRPC_ADDRESS=f"127.0.0.1:{grpc_port}",
               GUBER_HTTP_ADDRESS=f"127.0.0.1:{http_port}",
               GUBER_FRONTDOOR_WORKERS="2",
               GUBER_TPU_CAPACITY_PER_SHARD="256",
               GUBER_TPU_BATCH_PER_SHARD="64")
    p = subprocess.Popen([sys.executable, "-m", "gubernator_tpu_torch.daemon"],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        async def serve_once():
            deadline = time.monotonic() + 120
            while True:
                try:
                    cl = AsyncClient(f"127.0.0.1:{grpc_port}")
                    h = await cl.health_check(timeout=2)
                    if h.status == "healthy":
                        break
                except Exception:
                    pass
                finally:
                    await cl.close()
                assert p.poll() is None, "daemon died at boot"
                assert time.monotonic() < deadline, "daemon never served"
                await asyncio.sleep(0.25)
            cl = AsyncClient(f"127.0.0.1:{grpc_port}")
            rs = await cl.get_rate_limits(
                [req("sig", f"k{i}", limit=3) for i in range(100)])
            await cl.close()
            return rs

        rs = asyncio.run(serve_once())
        assert [r.remaining for r in rs] == [2] * 100
        p.send_signal(signal.SIGTERM)
        _, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, err[-3000:]
    assert "resource_tracker" not in err and "KeyError" not in err, err
    assert "leaked" not in err, err
    assert not [f for f in os.listdir("/dev/shm")
                if f.startswith(f"gfd{p.pid}x")]


@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke.py as a module (it exits at once without a card, so the
    check is patched for the import)."""
    import importlib.util
    from unittest import mock
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_fd", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch("torch.cuda.is_available", return_value=True):
        spec.loader.exec_module(mod)
    return mod


# RPCs a, b (sent twice) and c, answered "A", "B" and "C" by the serial
# engine; each case edits what was staged (want) or answered (outs)
_WHOLE_CASES = {
    "whole": ({}, {}, False),
    "failed_not_applied": ({"c": []}, {3: None}, False),
    "failed_applied_once": ({}, {3: None}, False),
    "partly_staged": ({"b": ["B"], "b-part": ["X"]}, {}, True),
    "failed_applied_twice": ({"c": ["C", "C"]}, {3: None}, True),
    "answered_not_applied": ({"a": []}, {}, True),
    "answered_other_bytes": ({}, {0: "Z"}, True),
}


@pytest.mark.parametrize("case", sorted(_WHOLE_CASES))
def test_chip_smoke_whole_rpc_accounting(chip_smoke, case):
    """fd_whole_rpcs (phase 14b's check of the RPCs a SIGKILL failed):
    an RPC staged in part (bytes never sent), a failed RPC applied twice,
    an answered RPC never applied and other answer bytes are each a
    fault; a failed RPC applied once or never is not."""
    edit_want, edit_outs, fault = _WHOLE_CASES[case]
    datas = [b"a", b"b", b"b", b"c"]
    outs = [b"A", b"B", b"B", b"C"]
    want = {b"a": [b"A"], b"b": [b"B", b"B"], b"c": [b"C"]}
    want.update({k.encode(): [x.encode() for x in v]
                 for k, v in edit_want.items()})
    for i, o in edit_outs.items():
        outs[i] = None if o is None else o.encode()
    failed, applied, got = chip_smoke.fd_whole_rpcs(datas, outs, want)
    assert failed == sum(o is None for o in outs)
    assert applied == sum(len(v) for v in want.values())
    assert bool(got) == fault, got
