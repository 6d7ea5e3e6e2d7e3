"""Live key migration in the port (state/migrate.py, the engine's row API,
Instance.transfer_buckets / migrate_keys, cluster grow and shrink), on the
CPU, against the JAX package.

  * The TransferBuckets codec, byte for byte against
    gubernator_tpu/state/migrate.py: payloads and acks, and the same
    exception for every malformed one; `ownership_diff` against JAX's.
  * The engine row API (`local_keys`, `export_rows`, `import_rows`,
    `export_global_rows`, `import_global_rows`, `remove_keys`) against the
    JAX engine on the 8-CPU-device mesh (Python tables, GLOBAL served,
    shard_map's replication check off as in tests/test_torch_engine.py):
    the same exported rows, the same imported and stale-skipped counts,
    the same arenas after the import and the same answers after it.
  * The cross-package payload both ways: the JAX engine's payload into
    the port's Instance.transfer_buckets and the port's into the JAX
    Instance's, each side then answering as the other.
  * The warm tier under an import (ROADMAP Queue 3): the JAX engine loses
    the evicted key's counter, dropped as stale or overwritten by the
    imported row; the port answers it as an engine that never evicts.
  * The mirror of tests/test_migration.py's ring grow and shrink on a
    three-node port cluster (use_native=False), its clocks pinned and its
    answers held against a serial engine (the JAX version of that test
    fails on the CPU under the installed JAX, ROADMAP Queue 3).
"""

import asyncio
import json
import socket

import jax
import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)
from gubernator_tpu import compat
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.config import Config as JConfig
from gubernator_tpu.config import TierConfig as JTierConfig
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.core import service as jservice
from gubernator_tpu.core.service import Instance as JInstance
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu.state import migrate as jmig
from gubernator_tpu_torch import cluster as cluster_mod
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    Status,
)
from gubernator_tpu_torch.client import AsyncClient
from gubernator_tpu_torch.config import BehaviorConfig, EngineConfig, TierConfig
from gubernator_tpu_torch.core import service as pservice
from gubernator_tpu_torch.core.engine import (
    GCFG_FIELDS,
    GSTATE_FIELDS,
    RateLimitEngine,
    shard_of,
)
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.state import migrate as pmig

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000
FIELDS = ("limit", "duration", "remaining", "tstamp", "expire", "algo")


# ------------------------------------------------------------------ codec

ROWS = [dict(key="a_k1", limit=10, duration=60_000, remaining=7,
             tstamp=T0, expire=T0 + 60_000, algo=0),
        dict(key="ü_ключ", limit=2**40, duration=1, remaining=-3,
             tstamp=-T0, expire=2**62, algo=4)]
GROWS = [dict(key="g_k", limit=100, duration=1000, remaining=99,
              tstamp=T0, expire=T0 + 1000, algo=1, cfg_limit=100,
              cfg_duration=1000, cfg_algo=1),
         dict(key="g_dead", limit=0, duration=0, remaining=0, tstamp=0,
              expire=0, algo=0, cfg_limit=5, cfg_duration=500, cfg_algo=0)]
LEASES = [["c_k", "10.0.0.1", 3, T0 + 5, "c", "k", 8, 60_000],
          ["c_j", "anonymous", 1, T0, "", "", 0, 0]]


def _numpy_ints(rows):
    """The rows as a device gather leaves them: numpy integers."""
    return [{k: (v if isinstance(v, str) else np.int64(v))
             for k, v in r.items()} for r in rows]


@pytest.mark.parametrize("regular,global_,leases", [
    ([], [], []), (ROWS, [], []), ([], GROWS, []), (ROWS, GROWS, LEASES),
    (ROWS[:1], GROWS[1:], LEASES[1:])],
    ids=["empty", "regular", "global", "all", "one_each"])
def test_encode_rows_is_byte_equal_to_the_jax_codec(regular, global_,
                                                    leases):
    want = jmig.encode_rows(regular, global_, leases)
    assert pmig.encode_rows(regular, global_, leases) == want
    # numpy integers from a gathered plane are written as Python ints
    np_leases = [[np.int64(v) if isinstance(v, int) else v for v in row]
                 for row in leases]
    assert pmig.encode_rows(_numpy_ints(regular), _numpy_ints(global_),
                            np_leases) == want
    assert pmig.decode_rows(want) == jmig.decode_rows(want)


MALFORMED = [
    b"not json", b"\xff\xfe", b"[]", b'{"v": 2, "regular": [], "global": []}',
    b'{"v": 1}', b'{"v": 1, "regular": [], "global": [], "leases": [[1]]}',
    b'{"v": 1, "regular": [["k", 1, 2, 3, 4, 5, "x"]], "global": []}',
    b'{"v": 1, "regular": [[7, 1, 2, 3, 4, 5, 6]], "global": []}',
    b'{"v": 1, "regular": [["k", 1.5, 2, 3, 4, 5, 6]], "global": []}',
    b'{"v": 1, "regular": [], "global": [["g", 1, 2, 3, 4, 5, 6, 7, 8]]}',
    b'{"v": 1, "regular": [["k", 1, 2]], "global": []}',
    b'{"v": 1, "regular": [], "global": [], '
    b'"leases": [["k", "c", "3", 4]]}',
    b'{"v": 1, "regular": [], "global": [], "leases": [["k", 2, 3, 4]]}',
    b'{"v": 1, "regular": {"a": 1}, "global": []}',
]


@pytest.mark.parametrize("data", MALFORMED, ids=range(len(MALFORMED)))
def test_malformed_payload_raises_as_the_jax_codec(data):
    def outcome(mod):
        try:
            return ("ok", mod.decode_rows(data))
        except Exception as e:
            return (type(e).__name__, str(e))
    got, want = outcome(pmig), outcome(jmig)
    assert got == want
    assert got[0] != "ok"


@pytest.mark.parametrize("data", [
    b"", b"{}", b'{"imported": 1}', b"nope",
    b'{"v": 1, "imported": "x", "skipped_stale": 0, "gimported": 0, '
    b'"gskipped_stale": 0}'], ids=range(5))
def test_malformed_ack_raises_as_the_jax_codec(data):
    for mod in (pmig, jmig):
        with pytest.raises(mod.MigrationError, match="malformed transfer ack"):
            mod.decode_ack(data)
    with pytest.raises(pmig.MigrationError) as p:
        pmig.decode_ack(data)
    with pytest.raises(jmig.MigrationError) as j:
        jmig.decode_ack(data)
    assert str(p.value) == str(j.value)


@pytest.mark.parametrize("counts", [(0, 0, 0, 0), (5, 2, 1, 0),
                                    (2**40, 1, 2, 3)])
def test_ack_is_byte_equal_to_the_jax_codec(counts):
    want = jmig.encode_ack(*counts)
    assert pmig.encode_ack(*(np.int64(c) for c in counts)) == want
    assert pmig.decode_ack(want) == jmig.decode_ack(want)
    assert pmig.decode_ack(want) == dict(zip(
        ("imported", "skipped_stale", "gimported", "gskipped_stale"),
        counts))


@pytest.mark.parametrize("old,new", [
    (["127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9003"],
     ["127.0.0.1:9001", "127.0.0.1:9002", "127.0.0.1:9003",
      "127.0.0.1:9004"]),
    (["a:1", "b:1", "c:1", "d:1"], ["a:1", "c:1", "d:1"]),
    (["a:1", "b:1"], ["c:1", "d:1"]),
    (["only:1"], ["only:1"])])
def test_ownership_diff_matches_the_jax_diff(old, new):
    rng = np.random.default_rng(5)
    keys = [f"n_{int(i)}" for i in rng.integers(0, 1 << 30, 4000)]
    got = pmig.ownership_diff(keys, old, new)
    assert got == jmig.ownership_diff(keys, old, new)
    if old == new:
        assert got == {}
    else:
        assert all(h in new for h in got)


# ----------------------------------------------- engine row API vs JAX


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture
def engines(monkeypatch):
    """make() -> (jax_engine, port_engine) on the 8-device geometry, GLOBAL
    served; the JAX engine's replication check off and its executable
    caches emptied before and after."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()

    def make():
        geo = dict(capacity_per_shard=64, batch_per_shard=16,
                   global_capacity=16, global_batch_per_shard=4,
                   max_global_updates=8)
        ref = jengine.RateLimitEngine(mesh=make_mesh(), use_native=False,
                                      skip_global=False, **geo)
        port = RateLimitEngine(num_shards=8, device="cpu", **geo)
        return ref, port
    yield make
    _clear_jax_executable_caches()


def _jreqs(reqs):
    return [JReq(name=r.name, unique_key=r.unique_key, hits=r.hits,
                 limit=r.limit, duration=r.duration, algorithm=r.algorithm,
                 behavior=r.behavior) for r in reqs]


def _tuples(resps):
    return [(int(r.status), int(r.limit), int(r.remaining),
             int(r.reset_time), r.error) for r in resps]


def _stream(seed, n_windows, prefix="m", now=T0):
    """(requests, now) windows: all five algorithms on regular keys, token
    and leaky GLOBAL keys, a few requests a window."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n_windows):
        reqs = []
        for _ in range(int(rng.integers(4, 12))):
            i = int(rng.integers(0, 40))
            algo = i % 5
            reqs.append(RateLimitReq(
                name=prefix, unique_key=f"k{i}", hits=int(rng.integers(0, 3)),
                limit=10 + i % 3, duration=60_000 + 1000 * (i % 4),
                algorithm=algo))
        for _ in range(int(rng.integers(0, 3))):
            i = int(rng.integers(0, 6))
            reqs.append(RateLimitReq(
                name=prefix, unique_key=f"g{i}", hits=int(rng.integers(0, 3)),
                limit=20, duration=30_000, algorithm=i % 2,
                behavior=Behavior.GLOBAL))
        out.append((reqs, now + 7 * w))
    return out


def _drive(ref, port, windows):
    for reqs, now in windows:
        want = ref.process(_jreqs(reqs), now=now)
        got = port.process(reqs, now=now)
        assert _tuples(got) == _tuples(want)


def _assert_same_state(ref, port, tag=""):
    got = port.export_arena()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref.state, f)),
                                      err_msg=f"{tag} arena.{f}")
    for name, a in zip(GSTATE_FIELDS + GCFG_FIELDS, (*ref.gstate, *ref.gcfg)):
        np.testing.assert_array_equal(got[name], np.asarray(a),
                                      err_msg=f"{tag} {name}")


def test_engine_row_api_matches_the_jax_engine(engines):
    """A source pair and a destination pair take streams with keys in
    common (the destination's older on some keys and newer on others),
    then the source's rows move: every step equals the JAX engine's."""
    src_j, src_p = engines()
    dst_j, dst_p = engines()
    _drive(src_j, src_p, _stream(1, 12, now=T0 + 500))
    # the destination saw some keys earlier (stale: the import wins) and,
    # later, others (fresher: skipped)
    _drive(dst_j, dst_p, _stream(2, 4, now=T0))
    _drive(dst_j, dst_p, _stream(3, 3, now=T0 + 5000))
    keys = src_p.local_keys()
    assert keys == src_j.local_keys() and len(keys) > 20
    gkeys = src_p.global_keys()
    assert gkeys == src_j.global_keys() and gkeys
    rows = src_p.export_rows(keys + ["m_absent"])
    assert rows == src_j.export_rows(keys + ["m_absent"])
    grows = src_p.export_global_rows(gkeys + ["m_absent"])
    assert grows == src_j.export_global_rows(gkeys + ["m_absent"])
    assert pmig.encode_rows(rows, grows) == jmig.encode_rows(rows, grows)
    now = T0 + 6000
    got = dst_p.import_rows(rows, now=now)
    assert got == dst_j.import_rows(rows, now=now)
    assert got[0] > 0 and got[1] > 0
    gout = dst_p.import_global_rows(grows, now=now)
    assert gout == dst_j.import_global_rows(grows, now=now)
    assert gout[0] + gout[1] == len(grows)
    _assert_same_state(dst_j, dst_p, "after import")
    # the destination answers every key as the JAX engine does
    _drive(dst_j, dst_p, _stream(1, 6, now=now + 10))
    _assert_same_state(dst_j, dst_p, "after answers")
    # a second import of the same rows is all stale on both
    assert (dst_p.import_rows(rows, now=now)
            == dst_j.import_rows(rows, now=now) == (0, len(rows)))
    assert src_p.remove_keys(keys[:9] + ["m_absent"]) == \
        src_j.remove_keys(keys[:9] + ["m_absent"]) == 9
    assert src_p.local_keys() == src_j.local_keys() == keys[9:]


def test_export_skips_pending_and_never_written_rows(engines):
    """A key whose initializing window never dispatched is pending: it is
    not a local key and exports nothing, on both engines; a row whose
    device expire is 0 does not export either."""
    ref, port = engines()
    _drive(ref, port, _stream(4, 3))
    for eng in (ref, port):
        t = eng.tables[shard_of("m_new", 8)]
        t.begin_window()
        t.lookup("m_new", T0, 1000)   # staged, never dispatched
    assert "m_new" not in port.local_keys()
    assert port.local_keys() == ref.local_keys()
    assert port.export_rows(["m_new"]) == ref.export_rows(["m_new"]) == []
    row = dict(ROWS[0], key="m_new")
    assert port.import_rows([row]) == ref.import_rows([row]) == (0, 1)


def test_cross_package_payload_imports_both_ways(engines, monkeypatch):
    """The JAX engine's payload (gubernator_tpu.state.migrate) into the
    port's Instance.transfer_buckets, the port's into the JAX Instance's:
    the same acks, and both destinations then answer alike."""
    clock = lambda: T0 + 6000  # noqa: E731
    for mod in (jservice, pservice):
        monkeypatch.setattr(mod, "millisecond_now", clock)
    src_j, src_p = engines()
    dst_j, dst_p = engines()
    _drive(src_j, src_p, _stream(6, 10, now=T0 + 500))
    _drive(dst_j, dst_p, _stream(7, 3, now=T0))
    jpayload = jmig.encode_rows(
        src_j.export_rows(src_j.local_keys()),
        src_j.export_global_rows(src_j.global_keys()),
        [["m_k1", "10.0.0.9", 2, T0 + 60_000, "m", "k1", 11, 61_000]])
    ppayload = pmig.encode_rows(
        src_p.export_rows(src_p.local_keys()),
        src_p.export_global_rows(src_p.global_keys()),
        [["m_k1", "10.0.0.9", 2, T0 + 60_000, "m", "k1", 11, 61_000]])
    assert ppayload == jpayload
    pinst = Instance(engine=dst_p)
    jinst = JInstance(JConfig(), engine=dst_j)

    async def body():
        return (await pinst.transfer_buckets(jpayload),
                await jinst.transfer_buckets(ppayload))
    try:
        pack, jack = asyncio.run(body())
    finally:
        pinst.close()
        jinst.close()
    assert pack == jack
    assert json.loads(pack)["imported"] > 0
    assert pinst.leases.export_rows() == jinst.leases.export_rows() == [
        ("m_k1", "10.0.0.9", 2, T0 + 60_000)]
    assert (vars(pinst._lease_tmpl["m_k1"])
            == {**vars(jinst._lease_tmpl["m_k1"]),
                "algorithm": Algorithm.CONCURRENCY})
    _assert_same_state(dst_j, dst_p, "after transfer")
    _drive(dst_j, dst_p, _stream(6, 5, now=T0 + 6010))


# -------------------------------------------------- the warm tier, import


@pytest.fixture
def jax_one_shard(monkeypatch):
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()
    # device 4 carries no other test's one-device mesh
    yield make_mesh(jax.devices("cpu")[4:5])
    _clear_jax_executable_caches()


def _tier(cls):
    return cls(warm_rows=1000, layout="int64", victim_sample=8,
               demote_watermark=0.9, demote_batch=32)


@pytest.mark.parametrize("last_window_touched_victim", [True, False],
                         ids=["stale_drop", "overwrite"])
def test_import_into_a_full_tiered_table_keeps_the_victim(
        jax_one_shard, last_window_touched_victim):
    """S = 1, C = 2, warm tier on: A and B resident, one row of a third
    key X imported, then A decided again.  An engine that never evicts
    answers A with its counter.  The JAX engine's import runs inside the
    last window: if that window touched A, A drops to cold as stale; if
    not, X's row is scattered into A's slot before the fence gathers A's
    row, so A comes back with X's counter.  The port opens a window for
    the import and resolves the spill before the scatter: it answers as
    the engine that never evicts."""
    ref = jengine.RateLimitEngine(
        mesh=jax_one_shard, capacity_per_shard=2, batch_per_shard=8,
        global_capacity=8, use_native=False, skip_global=True)
    ref.enable_tiers(_tier(JTierConfig), epoch=T0)
    port = RateLimitEngine(capacity_per_shard=2, batch_per_shard=8,
                           global_capacity=8, device="cpu", use_native=False)
    port.enable_tiers(_tier(TierConfig), epoch=T0)
    big = RateLimitEngine(capacity_per_shard=64, batch_per_shard=8,
                          global_capacity=8, device="cpu", use_native=False)

    def r(k, hits=1):
        return RateLimitReq(name="t", unique_key=k, hits=hits, limit=10,
                            duration=60_000)
    windows = [[r("a"), r("b", 3)]]
    if not last_window_touched_victim:
        windows.append([r("b")])
    row = dict(key="t_x", limit=10, duration=60_000, remaining=2,
               tstamp=T0, expire=T0 + 60_000, algo=0)
    answers = {}
    for name, eng in (("jax", ref), ("port", port), ("big", big)):
        jax_side = name == "jax"
        for i, w in enumerate(windows):
            eng.process(_jreqs(w) if jax_side else w, now=T0 + i)
        assert eng.import_rows([row], now=T0 + 5) == (1, 0)
        out = []
        for i, w in enumerate(([r("a")], [r("x")], [r("b")])):
            out += _tuples(eng.process(_jreqs(w) if jax_side else w,
                                       now=T0 + 6 + i))
        answers[name] = out
    assert answers["port"] == answers["big"]
    assert answers["big"][0] == (0, 10, 8, T0 + 60_000, "")
    assert answers["big"][1][2] == 1  # X: its imported 2, less a hit
    assert answers["jax"][0] != answers["big"][0]
    if last_window_touched_victim:
        # dropped as stale: A starts over at the decision's clock
        assert answers["jax"][0] == (0, 10, 9, T0 + 6 + 60_000, "")
        assert ref.tier_stats()["demote_dropped_stale"] == 1
    else:
        # A came back from its spill with X's remaining (2, less a hit)
        assert answers["jax"][0][2] == 1
        assert ref.tier_stats()["promotions_from_spill"] == 1
    assert port.tier_stats()["demote_dropped_stale"] == 0


# ------------------------------------------- cluster grow and shrink


N_KEYS = 40
N_GLOBAL = 24
LIMIT = 10
DURATION = 60_000


def req(key, hits=1, behavior=Behavior.BATCHING):
    return RateLimitReq(name="mig", unique_key=key, hits=hits, limit=LIMIT,
                        duration=DURATION, algorithm=Algorithm.TOKEN_BUCKET,
                        behavior=behavior)


def _holders(cluster, full_key):
    out = []
    for node in cluster.nodes:
        eng = node.instance.engine
        if eng.tables[shard_of(full_key, eng.num_shards)].peek(full_key) \
                is not None:
            out.append(node.address)
    return out


def _slot_of(cluster, address, full_key):
    node = next(n for n in cluster.nodes if n.address == address)
    eng = node.instance.engine
    return eng.tables[shard_of(full_key, eng.num_shards)].peek(full_key)


def _joiner(addresses, keys, gkeys):
    """A free loopback address whose ring point takes some but not all of
    `keys` and at least one of `gkeys` (one point a host: an ephemeral
    port may land on a sliver of the ring)."""
    for _ in range(500):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            addr = f"127.0.0.1:{sock.getsockname()[1]}"
        new = addresses + [addr]
        moved = pmig.ownership_diff(keys, addresses, new).get(addr, [])
        gmoved = pmig.ownership_diff(gkeys, addresses, new).get(addr, [])
        if 0 < len(moved) < len(keys) and gmoved:
            return addr
    raise RuntimeError("no joining address takes a share of the keys")


def _counter(instance, name, labels):
    for fam in instance.metrics.registry.collect():
        for sample in fam.samples:
            if sample.name == name and all(
                    sample.labels.get(k) == v for k, v in labels.items()):
                return sample.value
    return 0.0


def test_ring_grow_migrates_only_rehomed_keys():
    """The mirror of tests/test_migration.py's test on a three-node port
    cluster (Python tables, pinned clocks): grow to four, then shrink
    back.  Only re-homed keys move, all of them to the new node, each
    living on one node; unmoved keys keep their slots; every answer after
    each move equals a serial engine's that saw the same requests; GLOBAL
    keys re-register on the new owner with the state of a founder's
    freshest replica, and the founders keep theirs."""
    keys = [f"acct:{i}" for i in range(N_KEYS)]
    gkeys = [f"gacct:{i}" for i in range(N_GLOBAL)]
    full = {k: f"mig_{k}" for k in keys}
    gfull = {k: f"mig_{k}" for k in gkeys}
    serial = RateLimitEngine(capacity_per_shard=512, batch_per_shard=128,
                             num_shards=2, device="cpu")
    clock = lambda: T0  # noqa: E731

    async def body():
        c = await cluster_mod.start(
            3, behaviors=BehaviorConfig(global_sync_wait=0.05),
            engine=EngineConfig(capacity_per_shard=512, batch_per_shard=128,
                                num_shards=2, global_capacity=128,
                                global_batch_per_shard=32,
                                max_global_updates=32, use_native=False),
            device="cpu")
        turn = [0]

        async def ask(reqs):
            addr = c.addresses[turn[0] % len(c.addresses)]
            turn[0] += 1
            client = AsyncClient(addr)
            try:
                return await client.get_rate_limits(reqs)
            finally:
                await client.close()

        def pin():
            for n in c.nodes:
                n.instance.batcher.now_fn = clock

        def expect(reqs, got):
            want = serial.process(reqs, now=T0)
            assert _tuples(got) == _tuples(want)

        try:
            pin()
            for k in keys:
                for _ in range(3):
                    got = await ask([req(k)])
                    expect([req(k)], got)
            for k in gkeys:
                for _ in range(2):
                    r = (await ask([req(k, behavior=Behavior.GLOBAL)]))[0]
                    assert r.error == ""
            for n in c.nodes:
                await n.instance.global_mgr.flush()
            for n in c.nodes:
                await n.instance.global_mgr.flush()
            owner = lambda k: c.nodes[0].instance.get_peer(k).host  # noqa
            before = {k: owner(full[k]) for k in keys}
            slot_before = {k: _slot_of(c, before[k], full[k]) for k in keys}
            assert all(v is not None for v in slot_before.values())
            gbefore = {}
            for node in c.nodes:
                for k in gkeys:
                    rows = node.instance.engine.export_global_rows([gfull[k]])
                    if not rows or rows[0]["expire"] == 0:
                        continue
                    row = (rows[0]["remaining"], rows[0]["expire"],
                           rows[0]["cfg_limit"])
                    cands = gbefore.setdefault(k, set())
                    best = max((e for _, e, _ in cands), default=0)
                    if row[1] > best:
                        gbefore[k] = {row}
                    elif row[1] == best:
                        cands.add(row)

            added = await c.add_instance(_joiner(c.addresses,
                                                 list(full.values()),
                                                 list(gfull.values())))
            pin()
            assert len(c.addresses) == 4
            after = {k: owner(full[k]) for k in keys}
            moved = [k for k in keys if after[k] != before[k]]
            kept = [k for k in keys if k not in moved]
            assert 0 < len(moved) < N_KEYS
            assert all(after[k] == added.address for k in moved)
            for k in moved:
                assert _holders(c, full[k]) == [added.address], k
            for k in kept:
                assert _holders(c, full[k]) == [before[k]], k
                assert _slot_of(c, before[k], full[k]) == slot_before[k], k
            for k in keys:
                expect([req(k)], await ask([req(k)]))
            gmoved = [k for k in gkeys if owner(gfull[k]) == added.address]
            assert gmoved, "no GLOBAL key re-homed; widen N_GLOBAL"
            new_g = set(added.instance.engine.global_keys())
            for k in gmoved:
                assert gfull[k] in new_g, k
                if k in gbefore:
                    got = added.instance.engine.export_global_rows(
                        [gfull[k]])[0]
                    assert (got["remaining"], got["expire"],
                            got["cfg_limit"]) in gbefore[k], k
            for node in c.nodes[:-1]:
                assert set(node.instance.engine.global_keys())

            # shrink back: the departing node ships everything it owns
            ghost = added.address
            await c.remove_instance(len(c.nodes) - 1)
            assert len(c.addresses) == 3 and ghost not in c.addresses
            final = {k: owner(full[k]) for k in keys}
            for k in moved:
                assert _holders(c, full[k]) == [final[k]], k
            for k in keys:
                got = await ask([req(k)])
                expect([req(k)], got)
                assert got[0].remaining == LIMIT - 5
                assert got[0].status == Status.UNDER_LIMIT
            out = sum(_counter(n.instance, "guber_tpu_migrated_keys_total",
                               {"direction": "out"}) for n in c.nodes)
            into = sum(_counter(n.instance, "guber_tpu_migrated_keys_total",
                                {"direction": "in"}) for n in c.nodes)
            return moved, out, into
        finally:
            await c.stop()

    moved, out, into = asyncio.run(body())
    # the founders shipped the grow's keys; the shrink's went out from the
    # node that left, so only the survivors' imports remain countable
    assert out >= len(moved) and into >= len(moved)
