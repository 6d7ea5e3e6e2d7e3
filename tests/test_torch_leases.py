"""The port's concurrency-lease plane (algorithms/leases.py, the serial
oracles of algorithms/oracles.py, the Instance's lease hooks, the server's
stream-close hook, the daemon's sweep, lease rows in snapshots) against
the JAX package's, on the CPU.

Mirrors tests/test_algorithms.py's lease tests: the book's lifecycle (the
same operations on a port book and a JAX book give the same results and
rows), the service accounting, `release_client_leases`, the per-client
cap and the GLOBAL refusal on a port Instance and a JAX Instance fed the
same requests with pinned clocks (responses and book rows equal).  Then
the stream-close hook with a fake gRPC context whose RPC was cancelled,
the daemon's sweep loop, lease rows through a snapshot (a restored key has
no release template, so its slots are left to device expiry, as in the
JAX package), the lease clock (`millisecond_now() + duration` whatever
clock the engine runs on), and the port's oracles against the JAX oracles
on seeded streams of all five algorithms.  `release_peer_leases` waits
for the peer ring (ROADMAP Queue 1 item 6c).
"""

import asyncio
import logging

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)
import jax

from gubernator_tpu import compat
from gubernator_tpu import server as jserver
from gubernator_tpu.algorithms import oracles as joracles
from gubernator_tpu.algorithms.leases import LeaseBook as JLeaseBook
from gubernator_tpu.api import pb as jpb
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.config import Config as JConfig
from gubernator_tpu.config import LeaseConfig as JLeaseConfig
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.core import service as jservice
from gubernator_tpu.core.service import Instance as JInstance
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch import daemon as pdaemon
from gubernator_tpu_torch import server as pserver
from gubernator_tpu_torch.algorithms import oracles
from gubernator_tpu_torch.algorithms.leases import LeaseBook
from gubernator_tpu_torch.api import pb
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    Status,
)
from gubernator_tpu_torch.config import DaemonConfig, EngineConfig, LeaseConfig
from gubernator_tpu_torch.core import engine as pengine
from gubernator_tpu_torch.core import service as pservice
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.observability.metrics import Metrics

pytestmark = pytest.mark.torch_port

T0 = 1_700_000_000_000
GEOMETRY = dict(capacity_per_shard=256, batch_per_shard=32,
                global_capacity=64, global_batch_per_shard=16,
                max_global_updates=16)


# ----------------------------------------------------- lease book lifecycle


def _books():
    return LeaseBook(), JLeaseBook()


def _both(books, op, *args):
    outs = [getattr(b, op)(*args) for b in books]
    assert outs[0] == outs[1], (op, args)
    return outs[0]


def _same_rows(books):
    a, b = (sorted(x.export_rows()) for x in books)
    assert a == b
    assert books[0].stats() == books[1].stats()


def test_lease_book_acquire_release_counts():
    books = _books()
    _both(books, "acquire", "k1", "c1", 3, T0 + 100)
    _both(books, "acquire", "k1", "c1", 2, T0 + 50)   # expiry keeps the max
    _both(books, "acquire", "k1", "c2", 1, T0 + 200)
    _both(books, "acquire", "k2", "c1", 4, T0 + 100)
    _both(books, "acquire", "k2", "c1", 0, T0 + 900)  # n <= 0: no grant
    assert _both(books, "held", "k1") == 6
    assert _both(books, "count", "c1", "k1") == 5
    assert _both(books, "holds", "c1", "k1")
    assert _both(books, "holds", "c2") and not _both(books, "holds", "c3")
    assert _both(books, "stats") == (2, 2, 10)
    assert _both(books, "release", "k1", "c1", 2) == 2
    assert _both(books, "release", "k1", "c1", 99) == 3  # saturates
    assert _both(books, "release", "k1", "c1", 1) == 0
    assert _both(books, "release", "k9", "c1", 1) == 0
    assert _both(books, "count", "c1", "k1") == 0
    assert _both(books, "held", "k1") == 1
    _same_rows(books)


def test_lease_book_release_client_and_sweep():
    books = _books()
    for b in books:
        b.acquire("k1", "c1", 2, T0 + 100)
        b.acquire("k2", "c1", 3, T0 + 100)
        b.acquire("k1", "c2", 1, T0 - 10)  # already expired
    got = [sorted(b.release_client("c1")) for b in books]
    assert got[0] == got[1] == [("k1", 2), ("k2", 3)]
    assert not _both(books, "holds", "c1")
    assert _both(books, "release_client", "c1") == []
    assert _both(books, "sweep", T0) == [("k1", "c2", 1)]
    assert _both(books, "stats") == (0, 0, 0)


def test_lease_book_export_import_drop():
    books = _books()
    for b in books:
        b.acquire("k1", "c1", 2, T0 + 100)
        b.acquire("k2", "c2", 3, T0 + 200)
    rows = books[0].export_rows()
    assert rows == books[1].export_rows()
    fresh = _books()
    assert _both(fresh, "import_rows", rows + [("k3", "c3", 0, T0)]) == 2
    _same_rows(fresh)
    assert _both(fresh, "export_rows", ["k2"]) == [("k2", "c2", 3, T0 + 200)]
    _both(fresh, "drop_keys", ["k2"])
    assert not _both(fresh, "holds", "c2")
    assert _both(fresh, "count", "c1", "k1") == 2


# ------------------------------------------------------------------ oracles


@pytest.mark.parametrize("algo", [0, 1, 2, 3, 4])
def test_oracles_match_the_jax_oracles(algo):
    """The port's serial oracles against the JAX package's on one seeded
    stream per algorithm: the same rows and responses at every step,
    hits, limits, durations, clock steps and algorithm switches drawn
    from a seed (CONCURRENCY draws releases too)."""
    rng = np.random.default_rng(100 + algo)
    mine, ref = {}, {}
    now = T0
    for step in range(600):
        now += int(rng.choice([0, 1, 7, 250, 5_000, 70_000]))
        key = int(rng.integers(0, 6))
        a = algo if rng.random() < 0.9 else int(rng.integers(0, 5))
        hits = int(rng.integers(-4, 6) if a == 4 else rng.integers(0, 6))
        limit = int(rng.choice([1, 3, 10, 40_000]))
        duration = int(rng.choice([1, 50, 1_000, 60_000]))
        r1, o1 = oracles.apply(mine.get(key), hits, limit, duration, a, now)
        r2, o2 = joracles.apply(ref.get(key), hits, limit, duration, a, now)
        assert o1 == o2, step
        assert vars(r1) == vars(r2), step
        mine[key], ref[key] = r1, r2
    assert oracles.ALGORITHM_NAMES == joracles.ALGORITHM_NAMES


# --------------------------------------------------------- service hooks


@pytest.fixture
def pair(monkeypatch):
    """make(**lease_kw) -> (port Instance, JAX Instance), each with its
    native router over two shards, the JAX one on two CPU devices;
    shard_map's replication check off and every clock pinned at T0 (the
    engines', the batchers' and the lease book's)."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    for mod in (jengine, pengine, jservice, pservice):
        monkeypatch.setattr(mod, "millisecond_now", lambda: T0)
    _clear()
    made = []

    def make(**lease_kw):
        port = Instance(engine_config=EngineConfig(**GEOMETRY, num_shards=2),
                        device="cpu", leases=LeaseConfig(**lease_kw))
        mesh = make_mesh(jax.devices("cpu")[2:4])
        eng = jengine.RateLimitEngine(mesh=mesh, use_native="on", **GEOMETRY)
        ref = JInstance(JConfig(leases=JLeaseConfig(**lease_kw)), engine=eng)
        for inst in (port, ref):
            inst.batcher.now_fn = lambda: T0
            if inst.batcher.pipeline is not None:
                inst.batcher.pipeline.now_fn = lambda: T0
        made.extend((port, ref))
        return port, ref
    yield make
    for inst in made:
        inst.close()
    _clear()


def _clear():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


def _conc(key, hits, limit=5, name="lease", behavior=Behavior.BATCHING,
          algo=Algorithm.CONCURRENCY):
    return RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                        duration=60_000, algorithm=algo, behavior=behavior)


def _jreqs(reqs):
    return [JReq(name=r.name, unique_key=r.unique_key, hits=r.hits,
                 limit=r.limit, duration=r.duration, algorithm=r.algorithm,
                 behavior=r.behavior) for r in reqs]


def _tuples(resps):
    return [(int(r.status), r.limit, r.remaining, r.reset_time, r.error,
             dict(r.metadata or {})) for r in resps]


async def _ask(port, ref, reqs, client_id=None):
    """The same requests through both Instances; their answers must be
    equal and are returned."""
    got = await port.get_rate_limits(reqs, client_id=client_id)
    want = await ref.get_rate_limits(_jreqs(reqs), client_id=client_id)
    assert _tuples(got) == _tuples(want)
    return got


def _same_books(port, ref):
    assert sorted(port.leases.export_rows()) == \
        sorted(ref.leases.export_rows())


def test_service_lease_accounting(pair):
    """Granted acquires land in the book under their client; an over-ask
    records nothing; an explicit release drains the book and the device
    counter; both Instances agree throughout."""
    port, ref = pair()

    async def body():
        r = (await _ask(port, ref, [_conc("a", 3)], "10.0.0.1"))[0]
        assert int(r.status) == int(Status.UNDER_LIMIT) and r.remaining == 2
        assert port.leases.count("10.0.0.1", "lease_a") == 3
        r = (await _ask(port, ref, [_conc("a", 3)], "10.0.0.2"))[0]
        assert int(r.status) == int(Status.OVER_LIMIT)
        assert not port.leases.holds("10.0.0.2")
        r = (await _ask(port, ref, [_conc("a", -2)], "10.0.0.1"))[0]
        assert r.remaining == 4
        assert port.leases.count("10.0.0.1", "lease_a") == 1
        # anonymous callers share one identity
        await _ask(port, ref, [_conc("b", 1)])
        assert port.leases.count("anonymous", "lease_b") == 1
        _same_books(port, ref)
    asyncio.run(body())


def test_service_release_client_leases(pair):
    """A vanished client's slots go back through the decision path, so the
    device counter recovers before bucket expiry."""
    port, ref = pair()

    async def body():
        await _ask(port, ref, [_conc("a", 2), _conc("b", 1)], "10.9.9.9")
        freed = [await port.release_client_leases("10.9.9.9"),
                 await ref.release_client_leases("10.9.9.9")]
        assert freed == [3, 3]
        assert not port.leases.holds("10.9.9.9")
        r = (await _ask(port, ref, [_conc("a", 5)], "10.0.0.3"))[0]
        assert int(r.status) == int(Status.UNDER_LIMIT)
        assert [await port.release_client_leases("nobody"),
                await ref.release_client_leases("nobody")] == [0, 0]
        _same_books(port, ref)
    asyncio.run(body())


@pytest.mark.parametrize("pin", ["queue_full", "draining"])
def test_lease_release_skips_admission_where_the_jax_service_sheds_it(
        pair, pin):
    """With admission pinned full, or intake closed, an explicit release
    and release_client_leases still reach the card, so the book and the
    card agree after: every key's held slots read on the card (limit less
    a hits-0 probe's remaining) equal the book's held().  The JAX service
    sheds both releases in-band and drops the book rows anyway, so its
    card keeps the slots the book gave back - a fault of the reference,
    pinned here."""
    port, ref = pair()

    def block(inst, on):
        adm = inst.qos.admission
        if pin == "queue_full":
            adm.pending = adm.max_pending if on else 0
        elif on:
            adm.close_intake()
        else:
            adm.open_intake()

    async def card(inst, mk):
        out = await inst.get_rate_limits([mk(_conc(k, 0)) for k in "ab"],
                                         client_id="probe")
        return [5 - r.remaining for r in out]

    async def body():
        await _ask(port, ref, [_conc("a", 3), _conc("b", 2)], "10.0.0.1")
        for inst in (port, ref):
            block(inst, True)
        got = (await port.get_rate_limits([_conc("a", -2)],
                                          client_id="10.0.0.1"))[0]
        assert (int(got.status), got.remaining) == (
            int(Status.UNDER_LIMIT), 4)
        assert not got.metadata
        want = (await ref.get_rate_limits(_jreqs([_conc("a", -2)]),
                                          client_id="10.0.0.1"))[0]
        assert want.metadata["shed_reason"] == pin
        _same_books(port, ref)
        assert port.leases.held("lease_a") == 1
        assert [await port.release_client_leases("10.0.0.1"),
                await ref.release_client_leases("10.0.0.1")] == [3, 3]
        for inst in (port, ref):
            block(inst, False)
            assert inst.leases.export_rows() == []
        assert await card(port, lambda r: r) == [0, 0]
        assert await card(ref, lambda r: _jreqs([r])[0]) == [3, 2]
    asyncio.run(body())


def test_service_lease_cap_per_client(pair):
    """GUBER_LEASE_MAX_PER_CLIENT: an acquire past the cap is answered
    OVER_LIMIT on the host and the device never sees it."""
    port, ref = pair(max_per_client=2)

    async def body():
        r = (await _ask(port, ref, [_conc("a", 2)], "10.0.0.1"))[0]
        assert int(r.status) == int(Status.UNDER_LIMIT)
        before = port.engine.windows_processed
        r = (await _ask(port, ref, [_conc("a", 1)], "10.0.0.1"))[0]
        assert int(r.status) == int(Status.OVER_LIMIT)
        assert (r.remaining, r.reset_time) == (0, 0)
        assert port.engine.windows_processed == before  # nothing launched
        r = (await _ask(port, ref, [_conc("a", 2)], "10.0.0.2"))[0]
        assert int(r.status) == int(Status.UNDER_LIMIT)
        assert port.leases.count("10.0.0.2", "lease_a") == 2
        _same_books(port, ref)
    asyncio.run(body())


def test_service_rejects_global_with_new_algorithms(pair):
    """GLOBAL stays token and leaky only: the other algorithms are refused
    with the JAX service's string, and token + GLOBAL still serves."""
    port, ref = pair()

    async def body():
        for algo in (Algorithm.GCRA, Algorithm.SLIDING_WINDOW,
                     Algorithm.CONCURRENCY):
            r = (await _ask(port, ref, [_conc("k", 1, name="g", algo=algo,
                                              behavior=Behavior.GLOBAL)]))[0]
            assert "GLOBAL behavior does not support" in r.error
        r = (await _ask(port, ref, [_conc("k", 1, name="g",
                                          algo=Algorithm.TOKEN_BUCKET,
                                          behavior=Behavior.GLOBAL)]))[0]
        assert r.error == ""
        _same_books(port, ref)
    asyncio.run(body())


class _Ctx:
    """A gRPC servicer context: the caller's address, the remaining time,
    and a done callback that fires with cancelled() true (the RPC was torn
    down before its response was delivered)."""

    def __init__(self, peer="ipv4:10.1.2.3:55000", cancelled=True):
        self._peer, self._cancelled, self.callbacks = peer, cancelled, []

    def peer(self):
        return self._peer

    def time_remaining(self):
        return None

    def cancelled(self):
        return self._cancelled

    def add_done_callback(self, cb):
        self.callbacks.append(cb)

    async def abort(self, *a):  # pragma: no cover
        raise AssertionError(f"abort not expected: {a}")


@pytest.mark.parametrize("cancelled", [True, False])
def test_stream_close_hook_releases_a_cancelled_rpc(pair, cancelled):
    """The server arms the hook for an RPC with CONCURRENCY items; when
    gRPC reports the RPC cancelled, the caller's leases (attributed to its
    address, ports stripped) are released through the device.  A
    completed RPC releases nothing.  Both servers answer the same bytes
    and leave the same books."""
    port, ref = pair()
    data = pb.GetRateLimitsReq(requests=[
        pb.RateLimitReq(name="lease", unique_key="s", hits=2, limit=5,
                        duration=60_000, algorithm=4)]).SerializeToString()

    async def body():
        outs, ctxs = [], []
        for mod, inst in ((pserver, port), (jserver, ref)):
            ctx = _Ctx(cancelled=cancelled)
            outs.append(await mod.serve_get_rate_limits(inst, data, ctx))
            assert len(ctx.callbacks) == 1
            ctxs.append(ctx)
        assert outs[0] == outs[1]
        assert port.leases.count("10.1.2.3", "lease_s") == 2
        for ctx in ctxs:
            ctx.callbacks[0](ctx)
        for _ in range(50):
            await asyncio.sleep(0.01)
            if cancelled and not port.leases.holds("10.1.2.3") \
                    and not ref.leases.holds("10.1.2.3"):
                break
        _same_books(port, ref)
        assert port.leases.holds("10.1.2.3") is not cancelled
        r = (await _ask(port, ref, [_conc("s", 0)], "x"))[0]
        assert r.remaining == (5 if cancelled else 3)
    asyncio.run(body())


def test_stream_close_hook_off_with_release_on_close_false(pair):
    """GUBER_LEASE_RELEASE_ON_CLOSE=0 (release_on_stream_close False):
    no hook is armed in either server, and a context without a peer gives
    no client id."""
    port, ref = pair(release_on_stream_close=False)

    async def body():
        for mod, inst in ((pserver, port), (jserver, ref)):
            ctx = _Ctx()
            mod._arm_lease_stream_close(inst, ctx, "10.1.2.3")
            assert ctx.callbacks == []
            assert mod._client_id_from(_Ctx(peer="")) is None
            assert mod._client_id_from(object()) is None
            assert mod._client_id_from(_Ctx(peer="ipv6:[::1]:80")) == "[::1]"
    asyncio.run(body())


def test_daemon_sweep_drops_expired_grants(monkeypatch):
    """The daemon's sweep loop (GUBER_LEASE_SWEEP_MS) drops grants whose
    expiry passed, counts them under reason "expired", and stops with
    the teardown."""
    monkeypatch.setattr(pdaemon, "millisecond_now", lambda: T0)
    inst = Instance(engine_config=EngineConfig(**GEOMETRY), device="cpu",
                    metrics=Metrics())
    d = pdaemon.Daemon(DaemonConfig())
    d.instance = inst
    inst.leases.acquire("k1", "c1", 2, T0 - 1)
    inst.leases.acquire("k2", "c1", 1, T0 + 10)
    ref = JLeaseBook()
    ref.acquire("k1", "c1", 2, T0 - 1)
    ref.acquire("k2", "c1", 1, T0 + 10)

    async def body():
        d._lease_sweep_task = asyncio.create_task(d._lease_sweep_loop(1))
        for _ in range(200):
            await asyncio.sleep(0.005)
            if inst.leases.stats()[2] == 1:
                break
        await d._teardown()
        assert d._lease_sweep_task.cancelled()
    asyncio.run(body())
    ref.sweep(T0)
    assert inst.leases.export_rows() == ref.export_rows()
    text = inst.metrics.expose().decode()
    assert 'guber_tpu_lease_releases_total{reason="expired"} 2.0' in text
    assert "guber_tpu_lease_held_slots 1.0" in text


def test_daemon_starts_the_sweep_only_when_configured():
    """DaemonConfig.leases.sweep_interval_ms (GUBER_LEASE_SWEEP_MS, default
    5000 as in the JAX package) is what start() reads; 0 turns it off."""
    assert DaemonConfig().leases.sweep_interval_ms == \
        JLeaseConfig().sweep_interval_ms == 5000
    assert LeaseConfig(sweep_interval_ms=0).sweep_interval_ms == 0
    with pytest.raises(ValueError):
        LeaseConfig(sweep_interval_ms=-1).validate()
    with pytest.raises(ValueError):
        LeaseConfig(max_per_client=-1).validate()


def test_lease_rows_through_a_snapshot(pair, caplog):
    """Lease rows ride a snapshot (export, bytes, restore into a fresh
    Instance) and come back equal; the JAX Instance exports the same rows.
    A restored key has no release template, so `release_client_leases`
    drops its book rows and leaves the slots to device expiry (JAX
    service.py:326-331), pinned here, not repaired."""
    port, ref = pair()

    async def body():
        await _ask(port, ref, [_conc("a", 2), _conc("b", 3)], "10.0.0.7")
        await _ask(port, ref, [_conc("a", 1)], "10.0.0.8")
        snaps = [await port.export_snapshot(now=T0),
                 await ref.export_snapshot(now=T0)]
        assert sorted(snaps[0].leases) == sorted(snaps[1].leases)
        blob = await port.export_snapshot_bytes()
        fresh = Instance(engine_config=EngineConfig(**GEOMETRY, num_shards=2),
                         device="cpu")
        try:
            with caplog.at_level(logging.WARNING, "gubernator.service"):
                await fresh.restore_snapshot_bytes(blob)
            assert not caplog.records
            assert sorted(fresh.leases.export_rows()) == \
                sorted(port.leases.export_rows())
            assert await fresh.release_client_leases("10.0.0.7") == 0
            assert not fresh.leases.holds("10.0.0.7")
            got = await fresh.get_rate_limits([_conc("a", 0)])
            assert got[0].remaining == 2  # 3 held slots stay on the device
        finally:
            fresh.close()
    asyncio.run(body())


def test_lease_expiry_follows_the_service_clock(pair, monkeypatch):
    """A grant expires at the service's millisecond_now() + duration, as in
    the JAX package, whatever clock the engine runs on (here the engines
    and batchers sit at T0, the service clock at T0 + 5000)."""
    for mod in (jservice, pservice):
        monkeypatch.setattr(mod, "millisecond_now", lambda: T0 + 5_000)
    port, ref = pair()

    async def body():
        await _ask(port, ref, [_conc("a", 1)], "c")
        assert port.leases.export_rows() == [("lease_a", "c", 1,
                                              T0 + 65_000)]
        _same_books(port, ref)
    asyncio.run(body())


def test_peer_plane_attributes_leases_to_the_forwarding_peer(pair):
    """GetPeerRateLimits grants attribute to the forwarding peer's
    address, as in the JAX service."""
    port, ref = pair()
    data = jpb.GetPeerRateLimitsReq(requests=[
        jpb.RateLimitReq(name="lease", unique_key="p", hits=1, limit=5,
                         duration=60_000, algorithm=4)]).SerializeToString()

    async def body():
        outs = []
        for mod, inst in ((pserver, port), (jserver, ref)):
            outs.append(await mod.serve_peer_rate_limits(
                inst, data, _Ctx(peer="ipv4:10.4.4.4:81", cancelled=False)))
        assert outs[0] == outs[1]
        assert port.leases.count("10.4.4.4", "lease_p") == 1
        _same_books(port, ref)
    asyncio.run(body())
