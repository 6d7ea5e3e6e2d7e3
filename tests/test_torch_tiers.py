"""The port's warm tier (gubernator_tpu_torch/state/tiers.py and the
engine's tier fence) on the CPU.

Mirrors tests/test_tiers.py on the port: the bigkey differential (Zipf
traffic over a 100k-key space through a tiny arena with the warm tier
answers as an arena that never evicts, bit for bit, in both warm layouts),
a key demoted and promoted again inside one window, a large arena as a
no-op, the refusals, eviction under pressure with and without tiers, the
warm rows' snapshot round trip, warm rows into an untiered engine, the
store's overflow, compact32 rows out of range, the config knobs and the
tier metrics.  The stacked case waits for the port's step_stacked
(ROADMAP Queue 1 item 8).  Then the same tiered traffic through the JAX
tiered engine and the port's gives equal responses and equal counters,
and the fence's gather and scatter are one device read and one write a
fence.  Where the JAX tier drops a row whose expire equals the clock, which
the kernels still read as live, the port keeps it and equals the engine
that never evicts (ROADMAP Queue 3; the last test pins it).
"""

import logging
import random

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)
import jax

from gubernator_tpu import compat
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.config import TierConfig as JTierConfig
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu.state import snapshot as jsnap
from gubernator_tpu_torch.api.types import Algorithm, RateLimitReq
from gubernator_tpu_torch.config import TierConfig
from gubernator_tpu_torch.core.engine import RateLimitEngine, shard_of
from gubernator_tpu_torch.state import snapshot as snapmod
from gubernator_tpu_torch.state.tiers import WarmStore

pytestmark = pytest.mark.torch_port

T0 = 1_700_000_000_000


def _engine(capacity, num_shards=8, **kw):
    return RateLimitEngine(capacity_per_shard=capacity, batch_per_shard=64,
                           num_shards=num_shards, global_capacity=8,
                           device="cpu", use_native=False, **kw)


def _tier_conf(warm_rows=100_000, layout="int64", victim_sample=8,
               cls=TierConfig):
    return cls(warm_rows=warm_rows, layout=layout,
               victim_sample=victim_sample, demote_watermark=0.9,
               demote_batch=32)


def _tiered_engine(capacity, warm_rows=100_000, layout="int64",
                   epoch=T0, num_shards=8):
    eng = _engine(capacity, num_shards)
    eng.enable_tiers(_tier_conf(warm_rows, layout), epoch=epoch)
    return eng


def _shard0_keys(eng, prefix, n):
    out = []
    i = 0
    while len(out) < n:
        k = f"{prefix}:{i}"
        if shard_of(f"r_{k}", eng.num_shards) == 0:
            out.append(k)
        i += 1
    return out


def _req(key, limit=10, duration=5_000, hits=1, algo=Algorithm.TOKEN_BUCKET):
    return RateLimitReq(name="r", unique_key=key, hits=hits, limit=limit,
                        duration=duration, algorithm=algo)


def _tuple(r):
    return (int(r.status), r.limit, r.remaining, r.reset_time)


def _zipf_stream(seed, n_windows, namespace=100_000, s=1.2, max_reqs=16):
    """tests/test_tiers.py's law: a heavy head and a long tail of one-shot
    keys, mixed durations and algorithms."""
    rng = np.random.default_rng(seed)
    pyr = random.Random(seed)
    durations = (500, 2_000, 10_000)
    now = T0
    for _ in range(n_windows):
        now += int(rng.integers(1, 60))
        reqs = []
        for _ in range(int(rng.integers(1, max_reqs + 1))):
            k = int(rng.zipf(s)) % namespace
            algo = (Algorithm.TOKEN_BUCKET if k % 3 else
                    Algorithm.LEAKY_BUCKET)
            reqs.append(_req(f"big:{k}", limit=5 + k % 7,
                             duration=durations[k % 3],
                             hits=1 + (k % 2), algo=algo))
        pyr.shuffle(reqs)
        yield now, reqs


# ------------------------------------------- mirrors of tests/test_tiers.py


@pytest.mark.parametrize("layout", ["int64", "compact32"])
def test_bigkey_differential_vs_unbounded_oracle(layout):
    """128 hot slots (64 x 2 shards; the JAX test's 16 x 8, on fewer
    shards because the CPU's plain drain costs a shard at a time) over a
    100k-key space == an arena that never evicts, bit for bit, with
    demotion and promotion exercised."""
    small = _tiered_engine(64, layout=layout, num_shards=2)
    big = _engine(2048, num_shards=2)
    for step, (now, reqs) in enumerate(_zipf_stream(11, 400)):
        got = small.step(reqs, now=now)
        want = big.step(reqs, now=now)
        assert [_tuple(a) for a in got] == [_tuple(b) for b in want], step
        if step % 37 == 0:
            small.tier_maintain(now)
    st = small.tier_stats()
    assert st["demotions"] > 0, "arena pressure never spilled a row"
    assert st["warm_hits"] > 0, "no key ever came back from warm"
    assert st["pending_spills"] == 0 and st["pending_promotions"] == 0
    assert max(len(t) for t in big.tables) < 2048


def test_differential_demote_repromote_same_drain():
    small = _tiered_engine(4, num_shards=2)
    big = _engine(256, num_shards=2)
    pool = _shard0_keys(small, "sd", 12)
    rng = random.Random(3)
    now = T0
    for _ in range(150):
        now += rng.randint(1, 40)
        picks = rng.sample(pool, 3)
        reqs = [_req(k, duration=3_000) for k in picks + [rng.choice(pool)]]
        got = small.step(reqs, now=now)
        want = big.step(reqs, now=now)
        assert [_tuple(a) for a in got] == [_tuple(b) for b in want]
    assert small.tier_stats()["promotions_from_spill"] > 0


def test_tiers_on_large_arena_is_noop_and_identical():
    tiered = _tiered_engine(256, num_shards=2)
    plain = _engine(256, num_shards=2)
    for now, reqs in _zipf_stream(5, 120, namespace=300):
        got = tiered.step(reqs, now=now)
        want = plain.step(reqs, now=now)
        assert [_tuple(a) for a in got] == [_tuple(b) for b in want]
    st = tiered.tier_stats()
    for k in ("promotions", "demotions", "warm_hits", "warm_evictions"):
        assert st[k] == 0, f"unexpected tier activity: {k}={st[k]}"
    assert st["warm_rows"] == 0
    assert st["fences"] == 120


def test_tiers_disabled_engine_has_no_tier_surface():
    eng = _engine(64)
    assert eng.tier_stats() is None and eng._tiers is None
    assert eng.tier_maintain(T0) == 0
    assert not TierConfig(warm_rows=0).enabled


def test_enable_tiers_refusals():
    """Zero warm capacity and an unknown layout are refused as in the JAX
    engine; so is the native router (it keeps no key strings)."""
    eng = _engine(64)
    with pytest.raises(ValueError):
        eng.enable_tiers(TierConfig(warm_rows=0))
    with pytest.raises(ValueError):
        TierConfig(warm_rows=16, layout="int16").validate()
    with pytest.raises(ValueError):
        TierConfig(warm_rows=16, demote_watermark=1.5).validate()
    from gubernator_tpu_torch import native
    if native.available():
        nat = RateLimitEngine(capacity_per_shard=64, batch_per_shard=16,
                              num_shards=2, global_capacity=8, device="cpu",
                              use_native="on")
        with pytest.raises(RuntimeError, match="key strings"):
            nat.enable_tiers(_tier_conf(16))


def test_single_tier_eviction_under_pressure_baseline():
    eng = _engine(4)
    ks = _shard0_keys(eng, "p", 5)
    for i in range(4):
        r = eng.step([_req(ks[i], duration=60_000)], now=T0 + i)[0]
        assert r.remaining == 9
    assert eng.step([_req(ks[4], duration=60_000)],
                    now=T0 + 10)[0].remaining == 9
    assert eng.tables[0].peek(f"r_{ks[0]}") is None
    assert eng.step([_req(ks[1], duration=60_000)],
                    now=T0 + 11)[0].remaining == 8
    # the evicted key lost its history
    assert eng.step([_req(ks[0], duration=60_000)],
                    now=T0 + 12)[0].remaining == 9


def test_tiered_eviction_under_pressure_keeps_counters():
    eng = _tiered_engine(4)
    ks = _shard0_keys(eng, "p", 5)
    for i in range(4):
        eng.step([_req(ks[i], duration=60_000)], now=T0 + i)
    eng.step([_req(ks[4], duration=60_000)], now=T0 + 10)
    assert eng.tables[0].peek(f"r_{ks[0]}") is None
    assert eng.tier_stats()["demotions"] == 1
    r = eng.step([_req(ks[0], duration=60_000)], now=T0 + 12)[0]
    assert r.remaining == 8, "warm promotion must carry the spent hit"
    assert eng.tier_stats()["warm_hits"] == 1


def test_version_bumped_snapshot_degrades_to_cold_start(tmp_path, caplog):
    import struct
    eng = _engine(64)
    eng.step([_req("v:1")], now=T0)
    blob = snapmod.dumps(eng.export_state(now=T0 + 1))
    tampered = (blob[:len(snapmod.MAGIC)] + struct.pack("<I", 99)
                + blob[len(snapmod.MAGIC) + 4:])
    with pytest.raises(snapmod.SnapshotError, match="version"):
        snapmod.loads(tampered)
    path = tmp_path / "arena.snap"
    path.write_bytes(tampered)
    fresh = _engine(64)
    with caplog.at_level(logging.WARNING, logger="gubernator.snapshot"):
        assert snapmod.restore_engine(fresh, str(path)) is None
    assert any("starting cold" in r.message for r in caplog.records)
    assert fresh.cache_size == 0


@pytest.mark.parametrize("layout", ["int64", "compact32"])
def test_warm_tier_snapshot_round_trip(layout):
    """The warm tier rides the arena's snapshot: demoted rows survive a
    restart and answer as the uninterrupted oracle; the JAX loads reads
    the same warm rows."""
    eng = _tiered_engine(2, layout=layout)
    oracle = _engine(256)
    ks = _shard0_keys(eng, "w", 12)
    now = T0
    for k in ks:
        now += 5
        eng.step([_req(k, duration=120_000)], now=now)
        oracle.step([_req(k, duration=120_000)], now=now)
    warm_before = eng.tier_stats()["warm_rows"]
    assert warm_before > 0
    blob = snapmod.dumps(eng.export_state(now=now))
    restored = snapmod.loads(blob)
    assert restored.warm is not None and len(restored.warm[0]) == warm_before
    jwarm = jsnap.loads(blob).warm
    assert jwarm[0] == restored.warm[0]
    for f in restored.warm[1]:
        np.testing.assert_array_equal(jwarm[1][f], restored.warm[1][f])
    eng2 = _tiered_engine(2, layout=layout, epoch=now)
    eng2.import_state(restored, rebase_to=now)
    assert eng2.tier_stats()["warm_rows"] == warm_before
    for k in ks:
        now += 3
        got = eng2.step([_req(k, duration=120_000)], now=now)[0]
        want = oracle.step([_req(k, duration=120_000)], now=now)[0]
        assert _tuple(got) == _tuple(want)


def test_warm_rows_into_untiered_engine_drop_with_warning(caplog):
    eng = _tiered_engine(2)
    now = T0
    for k in _shard0_keys(eng, "d", 10):
        now += 5
        eng.step([_req(k, duration=60_000)], now=now)
    snap = eng.export_state(now=now)
    assert snap.warm is not None and len(snap.warm[0]) > 0
    plain = _engine(2)
    with caplog.at_level(logging.WARNING, logger="gubernator.engine"):
        plain.import_state(snap)
    assert any("warm-tier rows" in r.message for r in caplog.records)


def _row(key, expire, tstamp=T0):
    return {"key": key, "limit": 10, "duration": 1000, "remaining": 5,
            "tstamp": tstamp, "expire": expire, "algo": 0}


def test_warm_store_overflow_prefers_expired_then_oldest():
    ws = WarmStore(3, "int64", epoch=T0)
    now = T0 + 500
    ws.put_batch([_row("a", T0 + 100), _row("b", T0 + 9_000),
                  _row("c", T0 + 9_000)], now)
    ws.put_batch([_row("d", T0 + 9_000)], now)   # evicts expired "a"
    assert "a" not in ws and ws.evictions == 1
    ws.put_batch([_row("e", T0 + 9_000)], now)   # no expired left: "b"
    assert "b" not in ws and "c" in ws and ws.evictions == 2


def test_warm_store_compact32_out_of_range_survives_exactly():
    ws = WarmStore(4, "compact32", epoch=T0)
    far = T0 + 2 ** 33
    ws.put_batch([_row("far", far, tstamp=far - 1000)], T0)
    wide = dict(_row("wide", T0 + 5_000), limit=2 ** 40)
    ws.put_batch([wide], T0)
    got = ws.take("far", T0)
    assert got is not None and not got["rel"]
    assert got["expire"] == far and got["tstamp"] == far - 1000
    got = ws.take("wide", T0)
    assert got is not None and got["limit"] == 2 ** 40


@pytest.mark.parametrize("layout", ["int64", "compact32"])
def test_warm_store_matches_jax_store(layout):
    """The port's WarmStore against the JAX one on the same puts and
    takes: the rows taken (raw compact deltas included), the exported
    rows, the overflow side map and the evictions, around the rebase
    edges."""
    from gubernator_tpu.state.tiers import WarmStore as JWarmStore
    lim = snapmod.REBASE_LIM
    rng = np.random.default_rng(4)
    port, ref = WarmStore(16, layout, epoch=T0), JWarmStore(16, layout, T0)
    offsets = [0, 1, -1, lim, -lim, lim + 1, -lim - 1, 2 ** 35, 5_000]
    for step in range(12):
        now = T0 + 50 * step
        rows = []
        for j in range(int(rng.integers(1, 6))):
            off = int(rng.choice(offsets))
            rows.append(dict(_row(f"k{rng.integers(30)}", T0 + off + 60_000,
                                  tstamp=T0 + off),
                             remaining=int(rng.integers(-3, 2 ** 33))))
        # the last put of a key wins in both stores
        rows = list({r["key"]: r for r in rows}.values())
        assert port.put_batch([dict(r) for r in rows], now) == \
            ref.put_batch([dict(r) for r in rows], now)
        key = f"k{rng.integers(30)}"
        assert port.take(key, now) == ref.take(key, now)
        assert len(port) == len(ref) and port.evictions == ref.evictions
    pk, pc = port.export_rows()
    jk, jc = ref.export_rows()
    assert pk == jk
    for f in pc:
        np.testing.assert_array_equal(pc[f], jc[f], err_msg=f)


def test_config_from_env_tier_knobs(monkeypatch):
    from gubernator_tpu_torch.config import config_from_env
    monkeypatch.setenv("GUBER_TIER_WARM", "4096")
    monkeypatch.setenv("GUBER_TIER_LAYOUT", "compact32")
    monkeypatch.setenv("GUBER_TIER_VICTIM_SAMPLE", "4")
    monkeypatch.setenv("GUBER_TIER_DEMOTE_WATERMARK", "0.75")
    monkeypatch.setenv("GUBER_TIER_DEMOTE_BATCH", "16")
    c = config_from_env()
    assert c.tiers.enabled and c.tiers.warm_rows == 4096
    assert c.tiers.layout == "compact32" and c.tiers.victim_sample == 4
    assert (c.tiers.demote_watermark, c.tiers.demote_batch) == (0.75, 16)
    assert c.engine.use_native is False
    monkeypatch.setenv("GUBER_TIER_LAYOUT", "int16")
    with pytest.raises(ValueError, match="GUBER_TIER_LAYOUT"):
        config_from_env()


def test_config_from_env_tiers_default_off(monkeypatch):
    from gubernator_tpu_torch.config import config_from_env
    monkeypatch.delenv("GUBER_TIER_WARM", raising=False)
    c = config_from_env()
    assert not c.tiers.enabled and c.engine.use_native == "auto"


def test_tier_metrics_exposed_and_advance():
    from gubernator_tpu_torch.observability.metrics import Metrics
    m = Metrics()
    eng = _tiered_engine(4)
    m.watch_tiers(eng)
    ks = _shard0_keys(eng, "m", 12)
    now = T0
    for k in ks:
        now += 5
        eng.step([_req(k, duration=60_000)], now=now)
    eng.step([_req(ks[0], duration=60_000)], now=now + 5)
    text = m.expose().decode("utf-8")
    assert 'guber_tpu_tier_events_total{event="demote"}' in text
    assert 'guber_tpu_tier_events_total{event="warm_hit"}' in text
    rows = [ln for ln in text.splitlines()
            if ln.startswith("guber_tpu_tier_warm_rows ")]
    assert rows and float(rows[0].split()[1]) > 0


def test_instance_with_tiers_maintains_after_each_window():
    """Instance(tiers=...) puts the warm tier on its engine and the
    batcher runs tier_maintain after each classic-lane window; with a
    Metrics registry the tier families are watched."""
    import asyncio

    from gubernator_tpu_torch.core.service import Instance
    from gubernator_tpu_torch.observability.metrics import Metrics
    inst = Instance(engine=_engine(8, num_shards=1), metrics=Metrics(),
                    tiers=_tier_conf(1024))
    calls = []
    real = inst.engine.tier_maintain
    inst.engine.tier_maintain = lambda now=None: calls.append(now) or real(
        now)
    inst.batcher.now_fn = lambda: T0

    async def run():
        return await inst.get_rate_limits(
            [_req(f"i{k}", duration=60_000) for k in range(20)])

    try:
        out = asyncio.run(run())
        assert all(r.remaining == 9 for r in out)
        assert calls and calls[0] == T0
        assert inst.engine.tier_stats()["demotions"] > 0
        assert b"guber_tpu_tier_warm_rows" in inst.metrics.expose()
    finally:
        inst.close()


# ----------------------------------------------- against the JAX package


@pytest.fixture
def jax_tiered(monkeypatch):
    """make(capacity, layout) -> the JAX tiered engine on a two-device
    mesh (Python tables), shard_map's replication check off and the
    executable caches emptied."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))

    def clear():
        for v in vars(jengine).values():
            if callable(getattr(v, "cache_clear", None)):
                v.cache_clear()
    clear()
    mesh = make_mesh(jax.devices("cpu")[2:4])

    def make(capacity, layout):
        eng = jengine.RateLimitEngine(
            mesh=mesh, capacity_per_shard=capacity, batch_per_shard=64,
            global_capacity=8, use_native=False)
        eng.enable_tiers(_tier_conf(100_000, layout, cls=JTierConfig),
                         epoch=T0)
        return eng
    yield make
    clear()


@pytest.mark.parametrize("layout", ["int64", "compact32"])
def test_tiered_engine_matches_jax_tiered_engine(jax_tiered, layout):
    """The same tiered traffic through the JAX tiered engine and the
    port's (two shards of 16 slots): every response, every tier counter,
    the warm rows and the arena, window for window."""
    ref = jax_tiered(16, layout)
    port = _tiered_engine(16, layout=layout, num_shards=2)
    for step, (now, reqs) in enumerate(_zipf_stream(13, 160)):
        want = ref.step([JReq(name=r.name, unique_key=r.unique_key,
                              hits=r.hits, limit=r.limit,
                              duration=r.duration, algorithm=r.algorithm)
                         for r in reqs], now=now)
        got = port.step(reqs, now=now)
        assert [_tuple(a) for a in got] == [_tuple(b) for b in want], step
        if step % 29 == 0:
            assert port.tier_maintain(now) == ref.tier_maintain(now)
    assert port.tier_stats() == ref.tier_stats()
    assert port.tier_stats()["demotions"] > 0
    assert port.tier_stats()["warm_hits"] > 0
    got = port.export_state(now=now, layout="int64")
    want = ref.export_state(now=now, layout="int64")
    for f in got.planes:
        np.testing.assert_array_equal(got.planes[f], want.planes[f])
    assert got.warm[0] == want.warm[0]
    for f in got.warm[1]:
        np.testing.assert_array_equal(got.warm[1][f], want.warm[1][f])
    assert snapmod.dumps(got) == jsnap.dumps(want)


def test_fence_moves_rows_in_one_gather_and_one_scatter(monkeypatch):
    """However many keys a window spills and promotes, its fence reads
    the device once and writes it once, padded to a power of two."""
    eng = _tiered_engine(4)
    gathers, scatters = [], []
    real_g, real_s = eng._gather_rows, eng._scatter_rows
    monkeypatch.setattr(eng, "_gather_rows",
                        lambda w: gathers.append(len(w)) or real_g(w))
    monkeypatch.setattr(eng, "_scatter_rows",
                        lambda w, v: scatters.append(len(w)) or real_s(w, v))
    ks = _shard0_keys(eng, "f", 12)
    eng.step([_req(k, duration=60_000) for k in ks[:4]], now=T0)
    fences = eng.tier_stats()["fences"]
    eng.step([_req(k, duration=60_000) for k in ks[4:8]], now=T0 + 1)
    assert gathers == [4] and not scatters
    eng.step([_req(k, duration=60_000) for k in ks[:4]], now=T0 + 2)
    assert gathers == [4, 4] and scatters == [4]
    assert eng.tier_stats()["fences"] == fences + 2
    out = eng.step([_req(k, duration=60_000) for k in ks[:4]], now=T0 + 3)
    assert [r.remaining for r in out] == [7] * 4


def test_row_expiring_now_stays_live_where_the_jax_tier_drops_it(jax_tiered):
    """A fact of the reference (ROADMAP Queue 3): the kernels read a row
    as expired when expire < now, but the JAX tier drops a demoted row
    whose expire equals the fence's clock (and its store refuses to give
    one back), so a later window at that same clock starts the key cold
    where an arena that never evicts continues it.  Smallest input: one
    shard of one slot; A (hits 1, limit 10, duration 1000) at T, then B and
    A in two windows at T + 1000.  The never-evicting engines and the
    port's tier answer A's second hit with remaining 8; the JAX tier with
    9.  The stream of the differential above never serves a row at its
    expire ms, so it does not meet this."""
    mesh = make_mesh(jax.devices("cpu")[4:5])
    jplain = jengine.RateLimitEngine(mesh=mesh, capacity_per_shard=8,
                                     batch_per_shard=16, global_capacity=8,
                                     use_native=False)
    jtier = jengine.RateLimitEngine(mesh=mesh, capacity_per_shard=1,
                                    batch_per_shard=16, global_capacity=8,
                                    use_native=False)
    jtier.enable_tiers(_tier_conf(16, cls=JTierConfig), epoch=T0)
    port = _tiered_engine(1, warm_rows=16, num_shards=1)
    plain = _engine(8, num_shards=1)
    a, b = _req("a", duration=1000), _req("b", duration=1000)
    steps = [([a], T0), ([b], T0 + 1000), ([a], T0 + 1000)]
    out = {}
    for name, eng in (("port", port), ("plain", plain),
                      ("jax_plain", jplain), ("jax_tier", jtier)):
        for reqs, now in steps:
            jax_side = name.startswith("jax")
            got = eng.step([JReq(name=r.name, unique_key=r.unique_key,
                                 hits=r.hits, limit=r.limit,
                                 duration=r.duration, algorithm=r.algorithm)
                            for r in reqs] if jax_side else reqs, now=now)
        out[name] = _tuple(got[0])
    assert out["port"] == out["plain"] == out["jax_plain"] == (
        0, 10, 8, T0 + 1000)
    assert out["jax_tier"] == (0, 10, 9, T0 + 2000)
    # a, then b to make room for a again; the JAX tier drops a's row
    assert port.tier_stats()["demotions"] == 2
    assert port.tier_stats()["warm_hits"] == 1
    assert jtier.tier_stats()["demote_dropped_expired"] == 1
    assert jtier.tier_stats()["demotions"] == 1
    # the stores alike: a row expiring now is taken by the port's only
    from gubernator_tpu.state.tiers import WarmStore as JWarmStore
    for layout in ("int64", "compact32"):
        ps, js = WarmStore(4, layout, T0), JWarmStore(4, layout, T0)
        for st in (ps, js):
            st.put_batch([_row("k", T0 + 5)], T0)
        assert ps.take("k", T0 + 5) is not None
        assert js.take("k", T0 + 5) is None
