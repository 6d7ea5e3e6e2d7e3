"""The port's engine over S = 8 shards with GLOBAL traffic, on the CPU,
against the JAX package's engine on the 8-CPU-device mesh.

The reference is `gubernator_tpu`'s RateLimitEngine on `make_mesh()` (all
eight CPU devices), with the Python slot tables (use_native=False) and
GLOBAL served (skip_global=False); the port is
`RateLimitEngine(num_shards=8, device="cpu")` at the same geometry, which
runs the plain versions of its kernels.  Both get one request stream with
the same clock.  As in tests/test_torch_engine.py, the JAX engine's XLA
step executables need shard_map's trace-time replication check off under
the installed JAX (it computes nothing); the fixture turns it off and
empties the JAX engine's compiled-executable caches before and after, so no
executable built here reaches another test.

Compared exactly, after every window: every response field, every shard's
regular arena (`export_arena()` vs the JAX engine's `state`), the GLOBAL
arena (`gstate`) and its config (`gcfg`), the compact latch and the window
count.  `pipeline_dispatch_global` is held against the JAX engine's
composed drain with GUBER_PALLAS_FUSED=1 - the TPU kernels in interpret
mode, global_combined_staged for the GLOBAL window - on the inputs of
tests/test_mesh_fused_drain.py, including its psum-traffic case.
"""

import asyncio

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)

from gubernator_tpu import compat
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.ops import kernel as jk
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.core.engine import (
    GCFG_FIELDS,
    GSTATE_FIELDS,
    RateLimitEngine,
    shard_of,
)
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.ops import drain_kernel as dk
from gubernator_tpu_torch.ops import global_kernel as gk

from .test_mesh_fused_drain import _random_stack

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000
S = 8
FIELDS = ("limit", "duration", "remaining", "tstamp", "expire", "algo")


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture
def engines(monkeypatch):
    """make(**geometry) -> (jax_engine, port_engine) on the same geometry."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()

    def make(C=64, B=16, G=16, Bg=4, Kg=8):
        ref = jengine.RateLimitEngine(
            mesh=make_mesh(), capacity_per_shard=C, batch_per_shard=B,
            global_capacity=G, global_batch_per_shard=Bg,
            max_global_updates=Kg, use_native=False, skip_global=False)
        assert ref.num_shards == S
        port = RateLimitEngine(
            capacity_per_shard=C, batch_per_shard=B, num_shards=S,
            global_capacity=G, global_batch_per_shard=Bg,
            max_global_updates=Kg, device="cpu")
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


def _assert_same_state(ref, port, tag=""):
    got = port.export_arena()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref.state, f)),
                                      err_msg=f"{tag} arena.{f}")
    for name, a in zip(GSTATE_FIELDS, ref.gstate):
        np.testing.assert_array_equal(got[name], np.asarray(a),
                                      err_msg=f"{tag} {name}")
    for name, a in zip(GCFG_FIELDS, ref.gcfg):
        np.testing.assert_array_equal(got[name], np.asarray(a),
                                      err_msg=f"{tag} {name}")
    assert port._compact_sound == ref._compact_sound, tag
    assert port.windows_processed == ref.windows_processed, tag


def _drive(ref, port, windows):
    """Feed (requests, now[, accumulate]) windows to both engines through
    process(); returns the port's responses after asserting they and every
    arena match the reference."""
    out = []
    for w, (reqs, now, *acc) in enumerate(windows):
        acc = acc[0] if acc else None
        want = ref.process(_jreqs(reqs), now=now, accumulate=acc)
        got = port.process(reqs, now=now, accumulate=acc)
        assert _tuples(got) == _tuples(want), f"window {w}"
        _assert_same_state(ref, port, f"window {w}")
        out.extend(got)
    return out


def _req(key, hits=1, limit=5, duration=60_000, algo=0, glob=False,
         name="t"):
    return RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                        duration=duration, algorithm=algo,
                        behavior=Behavior.GLOBAL if glob else 0)


def _g(key, hits=1, limit=5, duration=60_000, algo=0):
    return _req(key, hits, limit, duration, algo, glob=True)


def test_mixed_regular_and_global_stream(engines):
    """Eight windows mixing regular keys of all five algorithms over the
    shards with GLOBAL token and leaky keys, duplicates of both inside a
    window, reads, over-limit hits and expiries."""
    ref, port = engines()
    rng = np.random.default_rng(61)
    keys = [f"r{i}" for i in range(30)]
    gkeys = [f"g{i}" for i in range(6)]
    cfg = {k: (int(rng.integers(0, 5)) if k in keys else int(rng.integers(0, 2)),
               int(rng.integers(1, 12)), int(rng.choice([40, 2_000, 60_000])))
           for k in keys + gkeys}
    assert len({shard_of(f"t_{k}", S) for k in keys}) == S
    now = T0
    windows = []
    for _ in range(8):
        now += int(rng.choice([3, 50, 900, 30_000]))
        reqs = []
        for _ in range(int(rng.integers(10, 40))):
            glob = rng.random() < 0.35
            k = str(rng.choice(gkeys if glob else keys))
            a, lim, dur = cfg[k]
            h = (int(rng.integers(-3, 4)) if a == 4
                 else int(rng.integers(0, lim + 2)))
            reqs.append(_req(k, h, lim, dur, a, glob=glob))
        windows.append((reqs, now))
    _drive(ref, port, windows)
    for f in ("size", "capacity", "hits", "misses", "free", "live",
              "expired"):
        assert port.cache_stats(now)[f] == ref.cache_stats(now)[f], f


def test_global_stale_then_consistent(engines):
    """tests/test_engine.py:75-120 on both engines: a GLOBAL hit answers
    from the replica as it was before the window (stale), the window's
    summed hits land at its end, the next read sees them; over-limit is
    enforced after the sum lands."""
    ref, port = engines()
    g = lambda hits: _g("account:1234", hits, limit=5, duration=3_000)  # noqa: E731
    o = lambda hits: _g("over", hits, limit=3, duration=3_000)  # noqa: E731
    got = _drive(ref, port, [([g(1), g(1)], T0), ([g(0)], T0 + 10),
                             ([g(1)], T0 + 20), ([g(0)], T0 + 30),
                             ([o(3)], T0), ([o(1)], T0 + 1)])
    assert [(r.status, r.remaining) for r in got] == [
        (0, 4), (0, 4), (0, 3), (0, 3), (0, 2), (0, 0), (1, 0)]


def test_global_limit_raise_on_live_key(engines):
    """A limit raise on a live GLOBAL key reaches the config at once (the
    next reconcile runs under it), and the stored limit after expiry."""
    ref, port = engines()
    g = lambda hits, limit: _g("cfg", hits, limit)  # noqa: E731
    got = _drive(ref, port, [([g(2, 5)], T0), ([g(1, 50)], T0 + 1),
                             ([g(0, 50)], T0 + 2),
                             ([g(0, 50)], T0 + 61_000),
                             ([g(1, 50)], T0 + 61_010)])
    assert (got[-1].limit, got[-1].remaining) == (50, 49)
    assert int(port.export_arena()["gcfg.limit"][port.gtable.peek("t_cfg")]) \
        == 50


def test_global_eviction_and_reallocation_with_small_arena(engines):
    """G = 4 slots under ten GLOBAL keys: slots are evicted and reallocated
    (the state reset path), token and leaky, with short and long
    durations."""
    ref, port = engines(G=4)
    rng = np.random.default_rng(62)
    windows = []
    for w in range(8):
        reqs = [_g(f"e{rng.integers(0, 10)}", int(rng.integers(0, 3)), 4,
                   int(rng.choice([30, 60_000])), int(rng.integers(0, 2)))
                for _ in range(int(rng.integers(1, 4)))]
        windows.append((reqs, T0 + 25 * w))
    _drive(ref, port, windows)
    assert port.gtable.misses > 4


def test_windows_cut_by_global_lane_and_key_caps(engines):
    """process() cuts a window at the GLOBAL lane cap (S x Bg = 32 lanes)
    and at the distinct-GLOBAL-key cap (max_global_updates = 8), exactly
    where the JAX engine cuts."""
    ref, port = engines()
    lanes = [_g(f"l{i % 3}") for i in range(70)]         # 3 windows of lanes
    keys = [_g(f"k{i}", limit=9) for i in range(20)]     # 3 windows of keys
    mixed = [_req(f"m{i}") for i in range(10)] + keys[:12]
    _drive(ref, port, [(lanes, T0), (keys, T0 + 1), (mixed, T0 + 2)])
    assert port.windows_processed == 3 + 3 + 2


def test_accumulate_false_reads_without_spending(engines):
    """accumulate=False lanes read the replica but add no hits and write no
    config (a replica whose hits reconcile elsewhere)."""
    ref, port = engines()
    reqs = [_g("acc", 2, 10), _g("acc", 3, 20), _req("reg", 1)]
    _drive(ref, port, [(reqs, T0, [True, False, False]),
                       (reqs, T0 + 5, [False, True, True]),
                       ([_g("acc", 0, 10)], T0 + 9)])


def test_batcher_carries_accumulate_into_the_window(engines):
    """WindowBatcher.submit(req, accumulate) reaches engine.process: one
    window with a replica-only GLOBAL read and a contributing one answers
    and commits as the JAX engine does with the same flags."""
    ref, port = engines()
    inst = Instance(engine=port, behaviors=BehaviorConfig(batch_wait=0.05))
    inst.batcher.now_fn = lambda: T0
    reqs = [_g("b", 2, 10), _g("b", 1, 10), _req("r", 1)]
    acc = [False, True, True]

    async def run():
        return await asyncio.gather(*(inst.batcher.submit(r, a)
                                      for r, a in zip(reqs, acc)))

    try:
        got = asyncio.run(run())
    finally:
        inst.close()
    want = ref.process(_jreqs(reqs), now=T0, accumulate=acc)
    assert _tuples(got) == _tuples(want)
    _assert_same_state(ref, port, "batcher")
    assert int(port.export_arena()["gstate.remaining"][
        port.gtable.peek("t_b")]) == 9


def test_import_arena_takes_the_jax_engine_state(engines):
    """import_arena loads a JAX engine's state, gstate and gcfg (numpy);
    the two engines then serve the next windows identically."""
    ref, port = engines()
    _drive(ref, port, [([_g("x", 1), _req("y", 2)], T0)])
    fresh = RateLimitEngine(capacity_per_shard=64, batch_per_shard=16,
                            num_shards=S, global_capacity=16,
                            global_batch_per_shard=4, max_global_updates=8,
                            device="cpu")
    planes = {f: np.asarray(getattr(ref.state, f)) for f in FIELDS}
    planes.update({n: np.asarray(a) for n, a in zip(GSTATE_FIELDS, ref.gstate)})
    planes.update({n: np.asarray(a) for n, a in zip(GCFG_FIELDS, ref.gcfg)})
    fresh.import_arena(planes)
    got = fresh.export_arena()
    for name, a in planes.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    with pytest.raises(ValueError, match="partial"):
        fresh.import_arena({**{f: planes[f] for f in FIELDS},
                            "gcfg.limit": planes["gcfg.limit"]})
    with pytest.raises(ValueError, match="gstate.limit"):
        fresh.import_arena({**planes, "gstate.limit": planes["limit"]})


def test_empty_control_matches_jax_engine(engines):
    """The inert GLOBAL control blocks equal the JAX engine's, lane for
    lane: empty_drain_control's, and the (gbatch, gacc, upd) of
    empty_control (whose upsert lanes this engine does not take)."""
    ref, port = engines()
    got = port.empty_drain_control()
    for want in (ref.empty_drain_control(), ref.empty_control()[:3]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                              for x in (g, w))):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


def test_warmup_launches_every_shape_and_leaves_the_arenas(engines):
    _, port = engines()
    dk.reset_counts()
    gk.reset_counts()
    port.warmup(now=T0)
    assert all(not a.any() for a in port.export_arena().values())
    assert port.windows_processed == 2  # full + one compact bucket
    assert dk.plain_calls == {"drain_compact": 2, "drain_compact_stats": 0,
                              "window_full": 1}
    assert gk.plain_calls == {"global_window": 1, "global_stage": 0,
                              "global_apply": 0,
        "global_stage_read": 0, "global_apply_rows": 0}
    assert dk.launches == {"drain_compact": 0, "drain_compact_stats": 0,
                           "window_full": 0}
    assert gk.launches == {"global_window": 0, "global_stage": 0,
                           "global_apply": 0,
        "global_stage_read": 0, "global_apply_rows": 0}


# ---------------------------------------------------------------------------
# pipeline_dispatch_global against the JAX composed drain, TPU kernels in
# interpret mode (tests/test_mesh_fused_drain.py's geometry and inputs)

K, FB, FC, FBg, FG = 4, 16, 64, 8, 16


def _jax_fused(monkeypatch, ref, stack, nows, gb, ga, upd):
    monkeypatch.setenv("GUBER_PALLAS_FUSED", "1")
    try:
        return [np.asarray(a) for a in ref.pipeline_dispatch_global(
            stack, nows, jk.WindowBatch(*gb), ga, upd)]
    finally:
        monkeypatch.delenv("GUBER_PALLAS_FUSED")


def _random_control(rng, eng):
    """GLOBAL lanes on a few slots over every shard, with config writes and
    reallocation resets for them (what a window's staging emits)."""
    gb, ga, upd = eng.empty_drain_control()
    slots = rng.integers(0, FG, 5)
    for s in range(S):
        for lane in range(int(rng.integers(0, FBg))):
            k = int(rng.integers(0, 5))
            gb.slot[s, lane] = slots[k]
            gb.hits[s, lane] = int(rng.integers(0, 4))
            gb.limit[s, lane] = 20 + k
            gb.duration[s, lane] = 60_000
            gb.algo[s, lane] = k % 2
            gb.is_init[s, lane] = rng.random() < 0.2
            ga[s, lane] = gb.hits[s, lane] if rng.random() < 0.8 else 0
    for i, slot in enumerate(np.unique(slots)):
        upd[0][i], upd[1][i], upd[2][i], upd[3][i] = slot, 20, 60_000, 0
        if rng.random() < 0.3:
            upd[4][i] = slot
    return gb, ga, upd


def test_pipeline_dispatch_global_matches_jax_fused_drain(engines,
                                                          monkeypatch):
    """Two composed drains of K = 4 windows over all 8 shards plus one
    GLOBAL window each (random lanes, config writes, resets; then an inert
    one), against the JAX fused drain: every valid word and limit, the
    mismatch flags, the GLOBAL response block on valid lanes, every arena
    plane."""
    ref, port = engines(C=FC, B=FB, G=FG, Bg=FBg)
    rng = np.random.default_rng(42)
    for rnd in range(3):
        stack = _random_stack(rng, K, S, FB, FC)
        nows = np.asarray(
            [T0 + rnd * 10_000_000 + 1000 * k for k in range(K)], np.int64)
        gb, ga, upd = (_random_control(rng, port) if rnd < 2
                       else port.empty_drain_control())
        jw, jl, jm, jg = _jax_fused(monkeypatch, ref, stack, nows, gb, ga,
                                    upd)
        tw, tl, tm, tg = [t.numpy() for t in port.pipeline_dispatch_global(
            stack, nows, gb, ga, upd)]
        valid = (stack[..., 0] & 0xFFFFFFFF) != 0
        np.testing.assert_array_equal(tw[valid], jw[valid], f"{rnd} words")
        np.testing.assert_array_equal(tl[valid], jl[valid], f"{rnd} limits")
        np.testing.assert_array_equal(tm, jm, f"{rnd} mism")
        gvalid = gb.slot >= 0
        np.testing.assert_array_equal(tg[gvalid], jg[gvalid], f"{rnd} gfused")
        assert not tg[~gvalid].any()
        _assert_same_state(ref, port, f"drain {rnd}")


def test_pipeline_dispatch_global_psum_traffic(engines, monkeypatch):
    """tests/test_mesh_fused_drain.py's psum case: GLOBAL lanes for one
    slot on three shards.  Each drain's reads follow the miss-then-prior-
    sum model and the sum of the three hits lands once: reads 49/49/49 with
    the arena at 47, then 47/47/47 with the arena at 44 - on the port as on
    the JAX fused drain.  The JAX engine registers the key; its arenas
    reach the port through import_arena."""
    ref, port = engines(C=FC, B=FB, G=FG, Bg=FBg)
    ref.register_global_keys([("pg_g", 50, 60_000, 0)], now=T0)
    slot = ref.gtable.peek("pg_g")
    planes = {f: np.asarray(getattr(ref.state, f)) for f in FIELDS}
    planes.update({n: np.asarray(a) for n, a in zip(GSTATE_FIELDS, ref.gstate)})
    planes.update({n: np.asarray(a) for n, a in zip(GCFG_FIELDS, ref.gcfg)})
    port.import_arena(planes)
    stack = np.zeros((K, S, FB, 2), np.int64)
    nows = np.asarray([T0 + 10 + k for k in range(K)], np.int64)
    seen = []
    for drain in range(2):
        gb, ga, upd = port.empty_drain_control()
        for s in range(3):
            gb.slot[s, 0] = slot
            gb.hits[s, 0] = 1
            gb.limit[s, 0] = 50
            gb.duration[s, 0] = 60_000
            ga[s, 0] = 1
        jg = _jax_fused(monkeypatch, ref, stack, nows, gb, ga, upd)[3]
        tg = port.pipeline_dispatch_global(stack, nows, gb, ga, upd)[3].numpy()
        np.testing.assert_array_equal(tg[:3, 0], jg[:3, 0], f"drain {drain}")
        assert not tg[3:].any() and not tg[:, 1:].any()
        _assert_same_state(ref, port, f"drain {drain}")
        seen.append(([int(tg[s, 0, 2]) for s in range(3)],
                     int(port.export_arena()["gstate.remaining"][slot])))
    assert seen == [([49, 49, 49], 47), ([47, 47, 47], 44)]


# ---------------------------------------------------------------------------
# the service


def test_instance_serves_global_standalone(engines):
    """Instance.get_rate_limits on the S = 8 port engine: three RPCs mixing
    regular items and GLOBAL token/leaky items answer as the JAX engine
    does on the same items, GLOBAL with GCRA, sliding or concurrency gets
    the JAX service's per-item error, and the arenas match."""
    ref, port = engines(C=128, B=32, G=32, Bg=8, Kg=16)
    inst = Instance(engine=port, behaviors=BehaviorConfig(batch_wait=0.05))
    rng = np.random.default_rng(63)

    async def run():
        out = []
        for i in range(3):
            inst.batcher.now_fn = lambda i=i: T0 + 700 * i
            reqs = [_req(f"i{rng.integers(0, 40)}", int(rng.integers(0, 3)),
                         4, algo=int(rng.integers(0, 5)))
                    if rng.random() < 0.6 else
                    _g(f"gi{rng.integers(0, 6)}", int(rng.integers(0, 3)), 6,
                       algo=int(rng.integers(0, 2)))
                    for _ in range(60)]
            got = await inst.get_rate_limits(reqs)
            want = ref.process(_jreqs(reqs), now=T0 + 700 * i)
            out.append((_tuples(got), _tuples(want)))
        bad = await inst.get_rate_limits([
            _g("bad", algo=a) for a in (2, 3, 4)])
        return out, [r.error for r in bad]

    try:
        out, errors = asyncio.run(run())
    finally:
        inst.close()
    for i, (got, want) in enumerate(out):
        assert got == want, f"rpc {i}"
    assert errors == [
        f"while applying rate limit for 't_bad' - 'GLOBAL behavior does not "
        f"support algorithm '{a}''" for a in (2, 3, 4)]
    _assert_same_state(ref, port, "instance")
