"""A three-node port cluster over real loopback gRPC (cluster.py), on the
CPU.

  * The nine tests of tests/test_cluster.py (the reference's functional
    suite, functional_test.go:35-331), with the cluster's clocks pinned
    and advanced by the test instead of slept through.
  * The four of tests/test_cluster_rpc_lane.py: a large GetRateLimitsReq
    hitting one node rides the raw-bytes lane, its items classified
    against the ring in C, the remote ones forwarded as spliced bytes and
    the answers spliced back positionally.  The JAX versions of these four
    fail on the CPU (ROADMAP Queue 3), so these hold the cluster against a
    serial oracle: a standalone port Instance replaying the same requests
    on the same clock.
  * A differential: one pinned-clock script of small RPCs (the per-item
    path; GLOBAL items included) on a three-node JAX cluster, then on a
    three-node port cluster bound to the same addresses (so the rings
    agree), comparing every answer's (status, limit, remaining,
    reset_time, error), checking `owner` against each package's own ring,
    and comparing every node's GLOBAL probe after explicit flushes of the
    GLOBAL managers (each node's hits, then the owners' broadcasts).
"""

import asyncio
import socket

import grpc
import jax
import pytest

import gubernator_tpu  # noqa: F401
from gubernator_tpu import compat
from gubernator_tpu.config import BehaviorConfig as JBehaviorConfig
from gubernator_tpu.config import Config as JConfig
from gubernator_tpu.config import PeerInfo as JPeerInfo
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.core.service import Instance as JInstance
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu.server import GrpcServer as JGrpcServer
from gubernator_tpu_torch import cluster as cluster_mod
from gubernator_tpu_torch.api import pb
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    Second,
    Status,
)
from gubernator_tpu_torch.client import AsyncClient
from gubernator_tpu_torch.config import BehaviorConfig, EngineConfig
from gubernator_tpu_torch.core.service import Instance

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000
ENGINE = dict(capacity_per_shard=256, batch_per_shard=64,
              global_capacity=128, global_batch_per_shard=32,
              max_global_updates=32)


class Clock:
    """One pinned millisecond clock for every node of a cluster."""

    def __init__(self, t: int = T0):
        self.t = t

    def __call__(self) -> int:
        return self.t

    def advance(self, ms: int) -> None:
        self.t += ms


def _pin(inst, clock) -> None:
    inst.batcher.now_fn = clock
    if inst.batcher.pipeline is not None:
        inst.batcher.pipeline.now_fn = clock


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


@pytest.fixture(scope="module")
def clock():
    return Clock()


@pytest.fixture(scope="module")
def cluster(loop, clock):
    c = loop.run_until_complete(cluster_mod.start(
        3, behaviors=BehaviorConfig(global_sync_wait=0.05),
        engine=EngineConfig(num_shards=2, **ENGINE), device="cpu"))
    for i in range(3):
        _pin(c.instance_at(i), clock)
    yield c
    loop.run_until_complete(c.stop())


def run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout=60))


def req(name, key, hits=1, limit=2, duration=Second,
        algo=Algorithm.TOKEN_BUCKET, behavior=Behavior.BATCHING):
    return RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                        duration=duration, algorithm=algo, behavior=behavior)


# ------------------------------------------------- tests/test_cluster.py


def test_health_check(cluster, loop):
    async def body():
        client = AsyncClient(cluster.get_peer())
        h = await client.health_check()
        assert h.status == "healthy"
        assert h.peer_count == 3
        await client.close()
    run(loop, body())


def test_over_the_limit(cluster, loop):
    # functional_test.go:51-95
    async def body():
        client = AsyncClient(cluster.get_peer())
        expect = [(1, Status.UNDER_LIMIT), (0, Status.UNDER_LIMIT),
                  (0, Status.OVER_LIMIT)]
        for remaining, status in expect:
            rs = await client.get_rate_limits(
                [req("cl_over_limit", "account:1234")])
            assert rs[0].status == status
            assert rs[0].remaining == remaining
            assert rs[0].limit == 2
            assert rs[0].reset_time != 0
            assert rs[0].error == ""
        await client.close()
    run(loop, body())


def test_token_bucket_expiry(cluster, loop, clock):
    # functional_test.go:97-146, the clock advanced instead of slept
    async def body():
        client = AsyncClient(cluster.get_peer())
        r = (await client.get_rate_limits(
            [req("cl_token", "account:1234", duration=400)]))[0]
        assert (r.remaining, r.status) == (1, Status.UNDER_LIMIT)
        r = (await client.get_rate_limits(
            [req("cl_token", "account:1234", duration=400)]))[0]
        assert (r.remaining, r.status) == (0, Status.UNDER_LIMIT)
        clock.advance(500)
        r = (await client.get_rate_limits(
            [req("cl_token", "account:1234", duration=400)]))[0]
        assert (r.remaining, r.status) == (1, Status.UNDER_LIMIT)
        await client.close()
    run(loop, body())


def test_leaky_bucket(cluster, loop, clock):
    # functional_test.go:148-206, rate = 2000/5 = 400ms per token
    async def body():
        client = AsyncClient(cluster.get_peer())

        def leaky(hits):
            return req("cl_leaky", "account:1234", hits=hits, limit=5,
                       duration=2000, algo=Algorithm.LEAKY_BUCKET)
        r = (await client.get_rate_limits([leaky(5)]))[0]
        assert (r.remaining, r.status) == (0, Status.UNDER_LIMIT)
        r = (await client.get_rate_limits([leaky(1)]))[0]
        assert (r.remaining, r.status) == (0, Status.OVER_LIMIT)
        clock.advance(450)  # one token leaks
        r = (await client.get_rate_limits([leaky(1)]))[0]
        assert (r.remaining, r.status) == (0, Status.UNDER_LIMIT)
        clock.advance(850)  # two tokens leak
        r = (await client.get_rate_limits([leaky(1)]))[0]
        assert (r.remaining, r.status) == (1, Status.UNDER_LIMIT)
        assert r.limit == 5
        await client.close()
    run(loop, body())


def test_missing_fields(cluster, loop):
    # functional_test.go:208-269: per-item error strings, not RPC errors
    async def body():
        client = AsyncClient(cluster.get_peer())
        table = [
            (req("cl_missing", "account:1234", hits=1, limit=10, duration=0),
             "", Status.UNDER_LIMIT),
            (req("cl_missing", "account:12345", hits=1, limit=0,
                 duration=10000), "", Status.OVER_LIMIT),
            (req("", "account:1234", hits=1, limit=5, duration=10000),
             "field 'namespace' cannot be empty", Status.UNDER_LIMIT),
            (req("cl_missing", "", hits=1, limit=5, duration=10000),
             "field 'unique_key' cannot be empty", Status.UNDER_LIMIT),
        ]
        for i, (r, err, status) in enumerate(table):
            rs = await client.get_rate_limits([r])
            assert rs[0].error == err, i
            assert rs[0].status == status, i
        await client.close()
    run(loop, body())


def test_forwarded_requests_carry_owner_metadata(cluster, loop):
    # gubernator.go:151: non-owner responses name the owner
    async def body():
        owner_idx = await cluster.owner_index_of("cl_owner_meta_account:42")
        non_owner = (owner_idx + 1) % len(cluster.addresses)
        client = AsyncClient(cluster.peer_at(non_owner))
        rs = await client.get_rate_limits(
            [req("cl_owner_meta", "account:42", limit=10)])
        assert rs[0].metadata.get("owner") == cluster.peer_at(owner_idx)
        await client.close()
        inst = cluster.instance_at(non_owner)
        assert inst.metrics.cluster_forwarded._value.get() >= 1
    run(loop, body())


def test_batch_too_large_is_rpc_error(cluster, loop):
    # gubernator.go:78-81: >1000 items rejects the whole RPC
    async def body():
        client = AsyncClient(cluster.get_peer())
        reqs = [req("cl_too_big", f"k{i}", limit=10) for i in range(1001)]
        with pytest.raises(grpc.aio.AioRpcError) as ei:
            await client.get_rate_limits(reqs)
        assert ei.value.code() == grpc.StatusCode.OUT_OF_RANGE
        assert "max size is '1000'" in ei.value.details()
        await client.close()
    run(loop, body())


def _hist_count(instance, name: str) -> float:
    for fam in instance.metrics.registry.collect():
        if fam.name == name:
            for sample in fam.samples:
                if sample.name == name + "_count":
                    return sample.value
    return 0.0


def test_global_rate_limits(cluster, loop):
    # functional_test.go:271-331: GLOBAL against a non-owner peer, stale
    # then consistent remaining, then the metric sample counts
    async def body():
        owner_idx = await cluster.owner_index_of("cl_global_account:1234")
        non_owner_idx = (owner_idx + 1) % len(cluster.addresses)
        client = AsyncClient(cluster.peer_at(non_owner_idx))
        g = req("cl_global", "account:1234", hits=1, limit=5,
                duration=3 * Second, behavior=Behavior.GLOBAL)

        async def send_hit(expect_remaining, i):
            rs = await client.get_rate_limits([g])
            assert rs[0].error == "", i
            assert rs[0].status == Status.UNDER_LIMIT, i
            assert rs[0].remaining == expect_remaining, i
            assert rs[0].limit == 5, i

        # the first hit bootstraps the replica and queues the async send
        await send_hit(4, 1)
        # the send has not reconciled yet: the same answer
        await send_hit(4, 2)
        await asyncio.sleep(1.0)
        # the owner applied both hits and broadcast its status
        await send_hit(3, 3)
        assert _hist_count(cluster.instance_at(non_owner_idx),
                           "async_durations") >= 1
        assert _hist_count(cluster.instance_at(owner_idx),
                           "broadcast_durations") >= 1
        await client.close()
    run(loop, body())


def test_no_batching_behavior(cluster, loop):
    async def body():
        client = AsyncClient(cluster.get_peer())
        n = req("cl_nobatch", "k", hits=1, limit=3,
                behavior=Behavior.NO_BATCHING)
        rs = await client.get_rate_limits([n, n])
        # two items in one RPC still serialize correctly
        assert sorted([rs[0].remaining, rs[1].remaining]) == [1, 2]
        await client.close()
    run(loop, body())


# ---------------------------------------- tests/test_cluster_rpc_lane.py


def _raw(address):
    chan = grpc.aio.insecure_channel(address)
    return chan, chan.unary_unary(
        "/pb.gubernator.V1/GetRateLimits",
        request_serializer=lambda b: b,
        response_deserializer=pb.GetRateLimitsResp.FromString)


async def _oracle(payloads, clock):
    """A standalone port Instance's answers to the payloads' requests, in
    order, on the cluster's clock: (status, limit, remaining, reset,
    error) per item."""
    inst = Instance(engine_config=EngineConfig(num_shards=2, **ENGINE),
                    device="cpu")
    _pin(inst, clock)
    try:
        out = []
        for data in payloads:
            reqs = [pb.req_from_pb(m) for m in
                    pb.GetRateLimitsReq.FromString(data).requests]
            for r in await inst.get_rate_limits(reqs):
                out.append(_fields(r))
        return out
    finally:
        inst.close()


def _fields(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


def _payload(name, n, keys, limit=10, algos=2):
    return pb.GetRateLimitsReq(requests=[
        pb.RateLimitReq(name=name, unique_key=f"k{i % keys}", hits=1,
                        limit=limit, duration=60_000, algorithm=i % algos)
        for i in range(n)
    ]).SerializeToString()


def test_rpc_lane_mixed_ownership(cluster, loop, clock):
    """200 items x 40 keys at node 0 twice: the lane (not a fallback)
    decides them, each key on exactly one owner, and every answer equals
    the serial oracle's."""
    async def body():
        pipe = cluster.instance_at(0).batcher.pipeline
        assert pipe is not None and pipe.rpc_enabled  # the lane is armed
        staged0, fwd0 = pipe.rpc_staged, pipe.forwarded
        data = _payload("rlane", 200, 40)
        assert len(data) >= 2048
        chan, raw = _raw(cluster.peer_at(0))
        got = []
        for _ in range(2):
            resp = await raw(data)
            got += [_fields(r) for r in resp.responses]
        await chan.close()
        assert pipe.rpc_staged == staged0 + 2
        assert pipe.forwarded > fwd0
        return got, await _oracle([data, data], clock)

    got, want = run(loop, body())
    assert len(got) == 400
    assert got == want
    assert [g[2] for g in got[:5]] == [9] * 5  # k0..k4 first hits


def test_rpc_lane_forwarded_items_annotate_owner(cluster, loop):
    """Forwarded items carry metadata['owner'] like the per-item path
    (gubernator.go:151); owner-local items do not."""
    async def body():
        inst0 = cluster.instance_at(0)
        data = _payload("rlane_own", 200, 40, limit=100)
        chan, raw = _raw(cluster.peer_at(0))
        resp = await raw(data)
        await chan.close()
        n_fwd = 0
        for r, m in zip(resp.responses,
                        pb.GetRateLimitsReq.FromString(data).requests):
            assert not r.error, r.error
            peer = inst0.get_peer(f"rlane_own_{m.unique_key}")
            if peer.is_owner:
                assert "owner" not in r.metadata, (m.unique_key, r.metadata)
            else:
                assert r.metadata.get("owner") == peer.host
                n_fwd += 1
        assert n_fwd > 0  # 3 nodes: some keys are remote
    run(loop, body())


def test_rpc_lane_matches_slow_path_across_nodes(cluster, loop, clock):
    """The same 100 items at each node in turn: every key continues on
    its one owner, as the serial oracle does."""
    async def body():
        data = pb.GetRateLimitsReq(requests=[
            pb.RateLimitReq(name="xnode", unique_key=f"q{i % 20}", hits=1,
                            limit=1_000, duration=60_000)
            for i in range(100)
        ]).SerializeToString()
        got = []
        for i in range(3):
            chan, raw = _raw(cluster.peer_at(i))
            got += [_fields(r) for r in (await raw(data)).responses]
            await chan.close()
        return got, await _oracle([data] * 3, clock)

    got, want = run(loop, body())
    assert got == want
    assert {g[2] for g in got[-20:]} == {1_000 - 15}


def test_rpc_lane_all_items_remote(cluster, loop, clock):
    """An RPC whose every item another peer owns: node 0 launches no
    drain for it, and the spliced forwards still answer positionally,
    as the serial oracle does."""
    async def body():
        inst0 = cluster.instance_at(0)
        keys, i = [], 0
        while len(keys) < 120:
            if not inst0.get_peer(f"rlane2_ar{i}").is_owner:
                keys.append(f"ar{i}")
            i += 1
        data = pb.GetRateLimitsReq(requests=[
            pb.RateLimitReq(name="rlane2", unique_key=k, hits=1, limit=50,
                            duration=60_000) for k in keys
        ]).SerializeToString()
        assert len(data) >= 2048  # rides the RPC lane
        pipe = inst0.batcher.pipeline
        drains0 = pipe.drains
        chan, raw = _raw(cluster.peer_at(0))
        r1 = await raw(data)
        r2 = await raw(data)
        await chan.close()
        assert pipe.drains == drains0  # nothing was local
        got = [_fields(r) for r in list(r1.responses) + list(r2.responses)]
        assert all("owner" in r.metadata for r in r2.responses)
        return got, await _oracle([data, data], clock)

    got, want = run(loop, body())
    assert got == want
    assert {g[2] for g in got[:120]} == {49}
    assert {g[2] for g in got[120:]} == {48}


# ------------------------------------------------ JAX vs port, one script


def _free_addresses(n):
    out = []
    for _ in range(n):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            out.append(f"127.0.0.1:{s.getsockname()[1]}")
    return out


def _script():
    """(node, [RateLimitReq fields]) RPCs and clock steps of the
    differential: token, leaky, GCRA and sliding keys with repeats, errors,
    NO_BATCHING, and GLOBAL token and leaky keys, sent round-robin."""
    steps = []
    for rnd in range(4):
        for node in range(3):
            items = []
            for j in range(6):
                k = (rnd + node + j) % 7
                items.append(("d", f"t{k}", 1 + j % 2, 5, 2000, 0, 0))
            items.append(("d", f"l{(rnd + node) % 3}", 2, 4, 2000, 1, 0))
            items.append(("d", f"gc{node % 2}", 1, 3, 3000, 2, 0))
            items.append(("d", f"sw{rnd % 2}", 1, 3, 3000, 3, 0))
            items.append(("d", f"nb{node}", 1, 2, 1000, 0, 1))
            items.append(("d", f"g{(rnd + node) % 2}", 1, 9, 5000, 0, 2))
            items.append(("d", f"gl{node % 2}", 1, 6, 4000, 1, 2))
            items.append(("", "e", 1, 5, 1000, 0, 0))
            items.append(("d", "bad", 1, 5, 1000, 9, 0))
            steps.append((node, items))
        steps.append(("advance", 150))
    return steps


GLOBAL_KEYS = [("d", "g0", 9, 5000, 0), ("d", "g1", 9, 5000, 0),
               ("d", "gl0", 6, 4000, 1), ("d", "gl1", 6, 4000, 1)]


async def _drive(instances, addresses, clock):
    """Run _script against a started cluster: every answer's fields, the
    owners each answer names with the owners its ring gives, then the
    GLOBAL flushes and a hits=0 probe of every GLOBAL key on every
    node."""
    answers, owners = [], []
    for node, items in _script():
        if node == "advance":
            clock.advance(items)
            continue
        client = AsyncClient(addresses[node])
        rs = await client.get_rate_limits([
            RateLimitReq(name=n, unique_key=k, hits=h, limit=lim,
                         duration=d, algorithm=a, behavior=b)
            for n, k, h, lim, d, a, b in items])
        await client.close()
        ring = instances[node]
        for (n, k, *_), r in zip(items, rs):
            answers.append(_fields(r))
            want = (ring.get_peer(f"{n}_{k}").host
                    if n and k != "bad" else None)
            owners.append((r.metadata.get("owner"), want))
    # every node flushes twice: the first round sends the non-owners' hits
    # (their owners queue broadcasts) and what the owners had queued, the
    # second broadcasts what the hits changed
    for _ in range(2):
        for inst in instances:
            await inst.global_mgr.flush()
    probes = []
    for addr in addresses:
        client = AsyncClient(addr)
        rs = await client.get_rate_limits([
            RateLimitReq(name=n, unique_key=k, hits=0, limit=lim,
                         duration=d, algorithm=a, behavior=Behavior.GLOBAL)
            for n, k, lim, d, a in GLOBAL_KEYS])
        await client.close()
        probes.append([_fields(r) for r in rs])
    return answers, owners, probes


def _jax_clocks(monkeypatch, clock):
    from gubernator_tpu.core import batcher as jbatcher
    from gubernator_tpu.core import pipeline as jpipeline
    from gubernator_tpu.core import service as jservice
    for mod in (jengine, jbatcher, jpipeline, jservice):
        if hasattr(mod, "millisecond_now"):
            monkeypatch.setattr(mod, "millisecond_now", clock)


@pytest.fixture
def jax_shard_map(monkeypatch):
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()
    yield
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


async def _jax_cluster(addresses, clock):
    nodes = []
    # one 2-device mesh for the three engines: their executables compile
    # once (each engine keeps its own arenas)
    mesh = make_mesh(jax.devices("cpu")[2:4])
    for addr in addresses:
        eng = jengine.RateLimitEngine(mesh=mesh, use_native="on", **ENGINE)
        inst = JInstance(JConfig(
            behaviors=JBehaviorConfig(global_sync_wait=3600.0),
            advertise_address=addr), engine=eng)
        _pin(inst, clock)
        server = JGrpcServer(inst, addr)
        await server.start()
        nodes.append((inst, server))
    for inst, _ in nodes:
        inst.engine.warmup()
    for inst, _ in nodes:
        await inst.set_peers([
            JPeerInfo(address=a, is_owner=(a == inst.advertise_address))
            for a in addresses])
    return nodes


def test_port_cluster_answers_the_script_as_the_jax_cluster(
        jax_shard_map, monkeypatch):
    addresses = _free_addresses(3)

    async def jax_side():
        clock = Clock()
        _jax_clocks(monkeypatch, clock)
        nodes = await _jax_cluster(addresses, clock)
        try:
            return await _drive([n[0] for n in nodes], addresses, clock)
        finally:
            for inst, server in nodes:
                await server.stop(0)
                inst.close()

    async def port_side():
        clock = Clock()
        c = await cluster_mod.start_with(
            addresses, behaviors=BehaviorConfig(global_sync_wait=3600.0),
            engine=EngineConfig(num_shards=2, **ENGINE), device="cpu")
        try:
            for i in range(3):
                _pin(c.instance_at(i), clock)
            return await _drive([n.instance for n in c.nodes], addresses,
                                clock)
        finally:
            await c.stop()

    j_answers, j_owners, j_probes = asyncio.run(jax_side())
    p_answers, p_owners, p_probes = asyncio.run(port_side())
    # each package's answers name the owner its own ring gives (None on
    # an item the node decided itself or refused)
    for owners in (j_owners, p_owners):
        assert all(got in (None, want) for got, want in owners)
        assert any(got is not None for got, _ in owners)
    assert [g for g, _ in p_owners] == [g for g, _ in j_owners]
    assert p_answers == j_answers
    assert p_probes == j_probes
    # the GLOBAL replicas reconciled: every node's probe of a key agrees
    assert p_probes[0] == p_probes[1] == p_probes[2]
    # sanity: the script hit limits and refusals
    assert any(a[0] == int(Status.OVER_LIMIT) for a in p_answers)
    assert any(a[4] for a in p_answers)
