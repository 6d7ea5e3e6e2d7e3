"""The in-window slot reclaim (ROADMAP Queue 3, repaired in the port).

A request with a negative duration sets its key's host expiry estimate to
`now + duration`, behind `now`, while its device row stays live for the
window.  The reference's slot tables (the JAX package's `state/arena.py`
`_reclaim` and its router's `try_reclaim_expired`) then hand that entry to
a later allocation of the same window as "expired", so two keys share one
slot: the warm tier drops a live row and a GLOBAL hit is charged to
another key.  The port never reclaims an entry the current window touched;
the allocation falls through to the LRU victim.

Each smallest input runs on the port's Python tables and on its native
router (built with g++ here), and the port answers as an engine that never
evicts.  The JAX engines' answers are pinned beside it.  Token bucket,
limit 10, hits 1, duration 60000 unless given; windows at T, T + 1, T + 2.
"""

import pytest

import gubernator_tpu  # noqa: F401  (enables x64)
import jax

from gubernator_tpu import compat
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.config import TierConfig as JTierConfig
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch import native
from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.config import TierConfig
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.state.arena import SlotTable

pytestmark = pytest.mark.torch_port

T = 1_700_000_000_000


@pytest.fixture
def jax_engine(monkeypatch):
    """make(capacity, global_capacity, tiers) -> a one-shard JAX engine on
    the Python tables, shard_map's replication check off and the
    executable caches emptied."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))

    def clear():
        for v in vars(jengine).values():
            if callable(getattr(v, "cache_clear", None)):
                v.cache_clear()
    clear()
    mesh = make_mesh(jax.devices("cpu")[4:5])

    def make(capacity, global_capacity=8, tiers=False):
        eng = jengine.RateLimitEngine(
            mesh=mesh, capacity_per_shard=capacity, batch_per_shard=16,
            global_capacity=global_capacity, use_native=False)
        if tiers:
            eng.enable_tiers(_tier_conf(JTierConfig), epoch=T)
        return eng
    yield make
    clear()


def _tier_conf(cls=TierConfig):
    return cls(warm_rows=64, layout="int64", victim_sample=8,
               demote_watermark=0.9, demote_batch=32)


def _port(capacity, router, global_capacity=8, tiers=False):
    eng = RateLimitEngine(capacity_per_shard=capacity, batch_per_shard=16,
                          num_shards=1, global_capacity=global_capacity,
                          device="cpu",
                          use_native="on" if router == "native" else False)
    assert (eng.native is not None) == (router == "native")
    if tiers:
        eng.enable_tiers(_tier_conf(), epoch=T)
    return eng


def _req(key, hits=1, duration=60_000, behavior=Behavior.BATCHING):
    return RateLimitReq(name="r", unique_key=key, hits=hits, limit=10,
                        duration=duration, behavior=behavior)


def _run(eng, windows, jax_side=False):
    out = []
    for i, reqs in enumerate(windows):
        if jax_side:
            reqs = [JReq(name=r.name, unique_key=r.unique_key, hits=r.hits,
                         limit=r.limit, duration=r.duration,
                         behavior=int(r.behavior)) for r in reqs]
        out.append([(int(r.status), r.remaining, r.reset_time)
                    for r in eng.process(reqs, now=T + i)])
    return out


WARM = [[_req("A"), _req("B")],
        [_req("A", duration=-5), _req("C")],
        [_req("A")]]


@pytest.mark.parametrize("router,tiers", [("python", True),
                                          ("python", False),
                                          ("native", False)])
def test_negative_duration_keeps_its_slot_in_its_window(jax_engine, router,
                                                        tiers):
    """Warm tier (S = 1, C = 2, 64 warm rows): [A, B], [A (duration -5),
    C], [A].  An engine that never evicts answers A in the third window
    with remaining 7, reset T + 60000; so does the port at C = 2, tiered
    (the tier demotes B, not A) and untiered on either router (B, the LRU
    entry, is evicted).  The JAX engines, tiered and untiered, reclaim A's
    slot for C and answer 9, T + 60002.  The tiered engine is on the
    Python tables only (the router takes no tier)."""
    if router == "native" and not native.available():
        pytest.fail(f"native router did not build: {native.build_error()}")
    never = _run(_port(64, router), WARM)
    assert never[2] == [(0, 7, T + 60_000)]
    port = _port(2, router, tiers=tiers)
    assert _run(port, WARM) == never
    if tiers:
        assert port.tier_stats()["demotions"] >= 1
    for jtiers in (True, False):
        jax_side = _run(jax_engine(2, tiers=jtiers), WARM, jax_side=True)
        assert jax_side[:2] == never[:2]
        assert jax_side[2] == [(0, 9, T + 60_002)]
    assert _run(jax_engine(64), WARM, jax_side=True) == never


GLOBAL = [[_req("A", behavior=Behavior.GLOBAL),
           _req("B", behavior=Behavior.GLOBAL)],
          [_req("A", duration=-5, behavior=Behavior.GLOBAL),
           _req("C", hits=3, behavior=Behavior.GLOBAL)],
          [_req("A", hits=0, behavior=Behavior.GLOBAL),
           _req("C", hits=0, behavior=Behavior.GLOBAL)]]


@pytest.mark.parametrize("router", ["python", "native"])
def test_global_hit_stays_with_its_key_at_g_2(jax_engine, router):
    """GLOBAL (G = 2; both routers keep GLOBAL keys on a Python SlotTable):
    the keys of the warm input with behavior GLOBAL, C with hits 3, and a
    third window [A, C] of hits 0.  At G = 64 A reads 8 and C 7, and the
    port reads the same at G = 2.  The JAX engine at G = 2 gives C A's slot
    in window 2, so A's acknowledged hit is charged to C: A reads 10
    (reset T + 60002) and C 6."""
    if router == "native" and not native.available():
        pytest.fail(f"native router did not build: {native.build_error()}")
    wide = _run(_port(8, router, global_capacity=64), GLOBAL)
    assert [(r, rs) for _, r, rs in wide[2]] == [(8, T + 60_000),
                                                 (7, T + 60_001)]
    assert _run(_port(8, router, global_capacity=2), GLOBAL) == wide
    assert _run(jax_engine(8, global_capacity=64), GLOBAL,
                jax_side=True) == wide
    jax2 = _run(jax_engine(8, global_capacity=2), GLOBAL, jax_side=True)
    assert [r for _, r, _ in jax2[2]] == [10, 6]
    assert jax2[2][0][2] == T + 60_002


def test_table_skips_touched_entries_and_keeps_their_hints():
    """The SlotTable rule alone: an entry touched in this window is not
    reclaimed through the heap or the expired pool, stays reclaimable in a
    later window, and the 32-step budget still bounds the search."""
    t = SlotTable(2)
    t.begin_window()
    t.lookup("a", T, 60_000)
    t.lookup("b", T, 60_000)
    t.commit_window()
    t.begin_window()
    t.lookup("a", T + 1, -5)           # expired estimate, touched now
    assert t.lookup("c", T + 1, 60_000) == (1, True)   # b (LRU) evicted
    assert "a" in t and "b" not in t
    t.commit_window()
    t.begin_window()                   # a later window: a is reclaimable
    assert t.lookup("d", T + 2, 60_000) == (0, True)
    assert "a" not in t
    # the pool path: a stats() call flags the expired entry into the pool
    t = SlotTable(2)
    t.begin_window()
    t.lookup("a", T, 60_000)
    t.lookup("b", T, 60_000)
    t.commit_window()
    t.stats(T)
    t.begin_window()
    t.lookup("a", T + 1, -5)
    t.stats(T + 1)
    assert t._expired_pool and t._entries["a"][4]
    assert t.lookup("c", T + 1, 60_000)[0] == 1
    assert list(t._expired_pool) == ["a"]
    t.commit_window()
    t.begin_window()
    assert t.lookup("d", T + 2, 60_000)[0] == 0
