"""The port's raw-RPC lane (core/pipeline.py RpcJob, `submit_rpc`) on the
CPU, against the port's per-item path and the JAX pipeline's bytes.

Mirrors tests/test_fastpath.py.  A serialized GetRateLimitsReq goes through
the router's C parse into the drain's stack, the plain drain, and the C
encode of the response bytes; its answers must equal the per-item path's
(the port engine's process() on the Python tables, replaying the same
order), and its BYTES must equal what the JAX package's pipeline returns
for the same RPC (WindowBatcher.submit_rpc over its router engine on a
two-CPU-device mesh, S = 2) with the same pinned clock and the occupancy
gate off.  Parser refusals (each fallback code) resolve to None, so the
server's protobuf path answers them.  As in the other port tests the
fixture turns shard_map's replication check off for the JAX engine and
empties its executable caches.
"""

import asyncio

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)
import jax

from gubernator_tpu import compat
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.config import AnalyticsConfig as JAnalyticsConfig
from gubernator_tpu.config import BehaviorConfig as JBehaviorConfig
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.core.batcher import WindowBatcher as JBatcher
from gubernator_tpu.observability.analytics import (
    TrafficAnalytics as JTrafficAnalytics,
)
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch.api import pb
from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.config import AnalyticsConfig, BehaviorConfig
from gubernator_tpu_torch.core.batcher import WindowBatcher
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.observability.analytics import TrafficAnalytics
from gubernator_tpu_torch.ops import drain_kernel as dk

pytestmark = pytest.mark.torch_port

T0 = 1_700_000_000_000
S = 2
GEOMETRY = dict(capacity_per_shard=256, batch_per_shard=64,
                global_capacity=16, global_batch_per_shard=8,
                max_global_updates=8)
ANALYTICS = dict(enabled=True, topk=8, sketch_width=64, sketch_depth=3,
                 tenant_slots=6, decay_ms=1_000, over_weight=4)


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture
def jax_engine(monkeypatch):
    """make() -> a JAX engine with the native router on two CPU devices."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()
    mesh = make_mesh(jax.devices("cpu")[2:4])
    yield lambda **kw: jengine.RateLimitEngine(mesh=mesh, use_native="on",
                                               **{**GEOMETRY, **kw})
    _clear_jax_executable_caches()


def _engine(native="on", lanes=64):
    return RateLimitEngine(**{**GEOMETRY, "batch_per_shard": lanes},
                           num_shards=S, use_native=native, device="cpu")


def _setup(b, now, depth=3):
    assert b.pipeline is not None and b.pipeline.enabled
    b.pipeline.now_fn = lambda: now
    b.now_fn = lambda: now
    b.pipeline.depth = depth
    b.pipeline.gate_enabled = False
    return b


def _batcher(eng, now=T0, depth=3, analytics=None):
    return _setup(WindowBatcher(eng, BehaviorConfig(), analytics=analytics),
                  now, depth)


def _jbatcher(eng, now=T0, depth=3, analytics=None):
    return _setup(JBatcher(eng, JBehaviorConfig(), analytics=analytics),
                  now, depth)


def _mk(items):
    return pb.GetRateLimitsReq(requests=[
        pb.RateLimitReq(name=n, unique_key=k, hits=h, limit=lim, duration=d,
                        algorithm=a, behavior=b)
        for (n, k, h, lim, d, a, b) in items
    ]).SerializeToString()


def _reqs(items):
    return [RateLimitReq(name=n, unique_key=k, hits=h, limit=lim,
                         duration=d, algorithm=a, behavior=b)
            for (n, k, h, lim, d, a, b) in items]


def _jreqs(reqs):
    return [JReq(name=r.name, unique_key=r.unique_key, hits=r.hits,
                 limit=r.limit, duration=r.duration, algorithm=r.algorithm,
                 behavior=r.behavior) for r in reqs]


def _decode(out):
    return [(int(r.status), r.limit, r.remaining, r.reset_time, r.error)
            for r in pb.GetRateLimitsResp.FromString(out).responses]


def _tuples(resps):
    return [(int(r.status), int(r.limit), int(r.remaining),
             int(r.reset_time), r.error) for r in resps]


def _rpcs(b, datas, peer_mode=False):
    async def run():
        return await asyncio.gather(
            *(b.submit_rpc(d, peer_mode=peer_mode) for d in datas))
    try:
        return asyncio.run(run())
    finally:
        b.close()


def _items(rng, n, keys, name="rpc", limit=10):
    return [(name, f"k{rng.integers(0, keys)}", int(rng.integers(0, 3)),
             limit, 60_000, int(rng.integers(0, 2)), 0) for _ in range(n)]


def test_rpc_bytes_match_the_per_item_path():
    """Four rounds of 50-item RPCs over 20 keys: the lane's answers equal
    the per-item path's (engine.process on the Python tables)."""
    eng, ref = _engine(), _engine(native=False)
    rng = np.random.default_rng(5)
    for w in range(4):
        now = T0 + w * 300
        items = _items(rng, 50, 20)
        b = _batcher(eng, now)
        (out,) = _rpcs(b, [_mk(items)])
        assert out is not None
        assert b.pipeline.rpc_staged == 1 and b.pipeline.rpc_refused == 0
        assert _decode(out) == _tuples(ref.process(_reqs(items), now=now)), w


@pytest.mark.parametrize("depth", [1, 3])
def test_rpc_bytes_equal_the_jax_pipeline(jax_engine, depth):
    """Concurrent RPCs of 20-80 items (duplicate runs that fold, both
    algorithms, hits 0-2, and a peer_mode round): the response bytes equal
    the JAX pipeline's byte for byte, and so does the arena."""
    je, pe = jax_engine(batch_per_shard=16), _engine(lanes=16)
    rng = np.random.default_rng(40 + depth)
    for w in range(3):
        now = T0 + w * 400
        datas = [_mk(_items(rng, int(rng.integers(20, 80)), 30))
                 for _ in range(6)]
        peer = w == 2
        got_j = _rpcs(_jbatcher(je, now, depth), datas, peer)
        got_p = _rpcs(_batcher(pe, now, depth), datas, peer)
        assert all(o is not None for o in got_p)
        assert got_p == got_j, w
    got = pe.export_arena()
    for f in ("limit", "duration", "remaining", "tstamp", "expire", "algo"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(je.state, f)))


def test_mixed_rpc_and_list_jobs_in_one_drain(jax_engine):
    """Singles, a submit_now list and raw RPC bytes submitted together
    share drains without corrupting each other's demux or key order: the
    answers equal the serial path's and the JAX pipeline's."""
    je, pe, ref = jax_engine(), _engine(), _engine(native=False)
    singles = [RateLimitReq(name="mx", unique_key=f"s{i % 7}", hits=1,
                            limit=100, duration=60_000) for i in range(20)]
    batch = [RateLimitReq(name="mx", unique_key=f"b{i % 5}", hits=2,
                          limit=50, duration=60_000, algorithm=1)
             for i in range(15)]
    rpc_items = [("mx", f"s{i % 7}", 1, 100, 60_000, 0, 0)
                 for i in range(10)]
    data = _mk(rpc_items)

    def run(b, conv):
        async def go():
            t1 = [b.submit(r) for r in conv(singles)]
            t2 = b.submit_now(conv(batch))
            t3 = b.submit_rpc(data)
            return await asyncio.gather(asyncio.gather(*t1), t2, t3)
        try:
            return asyncio.run(go())
        finally:
            b.close()

    js, jbat, jrpc = run(_jbatcher(je), _jreqs)
    ps, pbat, prpc = run(_batcher(pe), list)
    assert prpc == jrpc
    assert _tuples(ps) == _tuples(js) and _tuples(pbat) == _tuples(jbat)
    want = ref.process(singles + batch, now=T0)
    assert _tuples(ps) == _tuples(want[:20])
    assert _tuples(pbat) == _tuples(want[20:])
    assert _decode(prpc) == _tuples(ref.process(_reqs(rpc_items), now=T0))


def test_rpc_spills_across_windows(jax_engine):
    """An RPC bigger than one window (200 items, 16 lanes a shard) spreads
    over the stack with each key's order kept, hot duplicates included."""
    je, pe, ref = jax_engine(batch_per_shard=16), _engine(lanes=16), \
        _engine(native=False, lanes=16)
    items = [("sp", f"k{i % 40}", 1, 30, 60_000, i % 2, 0)
             for i in range(200)]
    data = _mk(items)
    (got_j,) = _rpcs(_jbatcher(je), [data])
    b = _batcher(pe)
    (got_p,) = _rpcs(b, [data])
    assert got_p == got_j
    assert _decode(got_p) == _tuples(ref.process(_reqs(items), now=T0))
    assert b.pipeline.windows_staged > 1


def test_stack_overflow_leaves_rpcs_over_in_key_order(jax_engine):
    """Twelve 60-item RPCs over shared keys, more lanes than one stack of
    K = 8 windows of 16 lanes a shard holds: the RPCs that do not fit wait
    for the next drain ahead of anything newer, so every key answers in
    submission order (the serial path over all items in order), and the
    bytes equal the JAX pipeline's."""
    je, pe, ref = jax_engine(batch_per_shard=16), _engine(lanes=16), \
        _engine(native=False, lanes=16)
    all_items, datas = [], []
    for r in range(12):
        items = [("ov", f"k{(r * 37 + i * 3) % 150}", 1, 4, 60_000,
                  (r + i) % 2, 0) for i in range(60)]
        all_items += items
        datas.append(_mk(items))
    got_j = _rpcs(_jbatcher(je, depth=1), datas)
    b = _batcher(pe, depth=1)
    got_p = _rpcs(b, datas)
    assert b.pipeline.rpc_leftover > 0 and b.pipeline.rpc_refused == 0
    assert got_p == got_j
    want = _tuples(ref.process(_reqs(all_items), now=T0))
    assert [t for o in got_p for t in _decode(o)] == want


def test_stored_limit_mismatch_answers_the_stored_limit(jax_engine):
    """A live bucket hit by a later RPC with another in-range limit answers
    with the STORED limit: the fetch reads the device's limit plane when a
    mismatch flag fired."""
    je, pe = jax_engine(), _engine()
    first = _mk([("lm", "x", 1, 10, 60_000, 0, 0)] * 3)
    second = _mk([("lm", "x", 1, 25, 60_000, 0, 0),
                  ("lm", "y", 1, 25, 60_000, 1, 0)])
    for d in (first, second):
        (got_j,) = _rpcs(_jbatcher(je), [d])
        (got_p,) = _rpcs(_batcher(pe), [d])
        assert got_p == got_j
    assert _decode(got_p)[0][1] == 10 and _decode(got_p)[1][1] == 25


@pytest.mark.parametrize("case", [
    "global", "no_batching", "empty_key", "empty_name", "bad_algorithm",
    "concurrency", "big_limit", "negative_hits", "malformed", "good_then_bad",
    "too_many_items", "never_fits"])
def test_each_parser_refusal_takes_the_protobuf_path(case):
    """Every RPC the parser refuses resolves to None (the server then
    answers it through the protobuf path) before anything is staged: no
    drain, no allocation, the refusal counted."""
    ok = ("f", "k", 1, 5, 1000, 0, 0)
    datas = {
        "global": _mk([("f", "k", 1, 5, 1000, 0, int(Behavior.GLOBAL))]),
        "empty_key": _mk([("f", "", 1, 5, 1000, 0, 0)]),
        "empty_name": _mk([("", "k", 1, 5, 1000, 0, 0)]),
        "bad_algorithm": _mk([("f", "k", 1, 5, 1000, 7, 0)]),
        "concurrency": _mk([("f", "k", 1, 5, 1000, 4, 0)]),
        "no_batching": _mk([("f", "k", 1, 5, 1000, 0,
                             int(Behavior.NO_BATCHING))]),
        "big_limit": _mk([("f", "k", 1, 1 << 40, 1000, 0, 0)]),
        "negative_hits": _mk([("f", "k", -1, 5, 1000, 0, 0)]),
        "malformed": b"\x0a\xff\xff\xff",
        "good_then_bad": _mk([ok, ("f", "", 1, 5, 1000, 0, 0)]),
        "too_many_items": _mk([ok] * 1001),
        # more distinct keys than K windows x S x 16 lanes can take:
        # -6 on an empty stack
        "never_fits": _mk([("f", f"n{i}", 1, 5, 1000, 0, 0)
                           for i in range(400)]),
    }
    eng = _engine(lanes=16)
    size0, w0 = eng.native.size, eng.windows_processed
    b = _batcher(eng)
    assert _rpcs(b, [datas[case]]) == [None]
    assert b.pipeline.rpc_refused == 1 and b.pipeline.rpc_staged == 0
    assert b.pipeline.drains == 0
    assert eng.windows_processed == w0 and eng.native.size == size0


def test_refused_rpc_is_decided_behind_a_later_staged_rpc(jax_engine):
    """An RPC the parser refuses leaves the pipeline, as in the JAX
    pipeline: RPC A (token key x plus a GLOBAL item) resolves to None,
    and its x, submitted again as the server's protobuf path does, is
    decided after RPC B (x alone), submitted after A and staged.  Serial
    order would answer A's x with remaining 4 and B's with 3; both
    pipelines answer B with 4 and A's x with 3 (ROADMAP Queue 3)."""
    x = ("ord", "x", 1, 5, 60_000, 0, 0)
    rpc_a = _mk([x, ("ord", "g", 1, 5, 60_000, 0, int(Behavior.GLOBAL))])
    rpc_b = _mk([x])

    def run(b, again):
        async def refused():
            assert await b.submit_rpc(rpc_a) is None
            return await b.submit(again)

        async def both():
            return await asyncio.gather(refused(), b.submit_rpc(rpc_b))
        try:
            return asyncio.run(both())
        finally:
            b.close()

    (again,) = _reqs([x])
    b = _batcher(_engine())
    got_a, got_b = run(b, again)
    assert b.pipeline.rpc_refused == 1 and b.pipeline.rpc_staged == 1
    assert got_a.remaining == 3 and _decode(got_b)[0][2] == 4
    jgot_a, jgot_b = run(_jbatcher(jax_engine()), _jreqs([again])[0])
    assert jgot_a.remaining == 3 and jgot_b == got_b


def test_leaky_bucket_and_expiry_over_time(jax_engine):
    """One leaky key over leak steps and past its expiry, and a token key
    past its window: bytes equal the JAX pipeline's, answers the serial
    path's."""
    je, pe, ref = jax_engine(), _engine(), _engine(native=False)
    items = [("fpe", "x", 1, 3, 100, 1, 0), ("fpe", "t", 1, 2, 50, 0, 0)]
    data = _mk(items)
    for dt in (0, 10, 35, 36, 37, 60, 500):
        now = T0 + dt
        (got_j,) = _rpcs(_jbatcher(je, now), [data])
        (got_p,) = _rpcs(_batcher(pe, now), [data])
        assert got_p == got_j, dt
        assert _decode(got_p) == _tuples(ref.process(_reqs(items), now=now))


def test_analytics_from_rpc_traffic_equals_the_jax_pipeline(jax_engine):
    """With analytics on, RPC drains run the stats drain and the finisher;
    RPC lanes stay tenant 0 and label no slot, as in the JAX pipeline
    (beside a list job whose lanes carry their tenants): the ingested
    totals, tenants and top-K equal the JAX pipeline's."""
    conf, jconf = AnalyticsConfig(**ANALYTICS), JAnalyticsConfig(**ANALYTICS)
    je, pe = jax_engine(), _engine()
    je.enable_analytics(jconf)
    pe.enable_analytics(conf)
    clock = lambda: 1.0  # noqa: E731
    jan, pan = JTrafficAnalytics(jconf, now_fn=clock), \
        TrafficAnalytics(conf, now_fn=clock)
    rng = np.random.default_rng(31)
    base = dk.plain_calls["drain_compact_stats"]
    for w in range(4):
        now = T0 + w * 700
        datas = [_mk(_items(rng, 70, 12, name=f"t{j}", limit=30))
                 for j in range(3)]
        lst = [RateLimitReq(name="listed", unique_key=f"l{i % 5}", hits=1,
                            limit=30, duration=2_000) for i in range(10)]

        def run(b, conv):
            async def go():
                return await asyncio.gather(
                    *(b.submit_rpc(d) for d in datas),
                    b.submit_now(conv(lst)))
            try:
                return asyncio.run(go())
            finally:
                b.close()

        got_j = run(_jbatcher(je, now, 2, analytics=jan), _jreqs)
        got_p = run(_batcher(pe, now, 2, analytics=pan), list)
        assert got_p[:3] == got_j[:3], w
        assert _tuples(got_p[3]) == _tuples(got_j[3]), w
    assert pan.snapshot() == jan.snapshot()
    snap = pan.snapshot()
    assert snap["totals"]["drains"] >= 4
    assert set(snap["tenants"]) <= {"other", "listed"}
    assert dk.plain_calls["drain_compact_stats"] > base
