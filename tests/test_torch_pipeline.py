"""The port's pipelined serving lane (core/pipeline.py, the batcher's
pipelined lane, Instance) on the CPU, against the JAX package's pipeline
and against the port's own serial path.

The JAX reference is `gubernator_tpu`'s WindowBatcher over its
RateLimitEngine with use_native="on" on a two-CPU-device mesh (S = 2); the
port is WindowBatcher over `RateLimitEngine(num_shards=2, use_native="on",
device="cpu")`, which packs stacks with its own copy of the router and
runs the plain versions of the drain kernels.  Both pipelines get the same
submits with the same pinned clock (`now_fn` on the pipeline and on the
batcher), the occupancy gate off, so the same drains form; every response
field, the arena plane for plane and the window count are compared
exactly.  As in the other port tests the fixture turns shard_map's
replication check off for the JAX engine and empties its executable
caches.

Mirrors tests/test_pipeline_overlap.py and tests/test_fetch_chain.py:
depth 1/2/3 bit-identical to the serial oracle (here the port engine's
process() on the router); concurrent drains; out-of-order fetch
completion; an injected dispatch failure (the engine's pipeline_dispatch
monkeypatched to raise once) that fails only its own drain and commits
nothing; arena recycling; the depth knob; fetch strides 1/2/4 sharing one
fetch; ineligible requests on the legacy lane; and with analytics on, the
ingested totals, tenants and top-K against the JAX pipeline's.
"""

import asyncio
import threading
import time

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
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
)
from gubernator_tpu_torch.config import (
    AnalyticsConfig,
    BehaviorConfig,
    EngineConfig,
    SLOConfig,
)
from gubernator_tpu_torch.core.batcher import WindowBatcher
from gubernator_tpu_torch.core.engine import RateLimitEngine, shard_of
from gubernator_tpu_torch.core.pipeline import ListJob
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.core.window_buffers import RequestColumns
from gubernator_tpu_torch.ops import drain_kernel as dk
from gubernator_tpu_torch.ops import stats_kernel as sk
from gubernator_tpu_torch.observability.analytics import TrafficAnalytics

pytestmark = pytest.mark.torch_port

T0 = 1_700_000_000_000
S = 2
FIELDS = ("limit", "duration", "remaining", "tstamp", "expire", "algo")
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


def _engine(native="on", lanes=64, **kw):
    return RateLimitEngine(**{**GEOMETRY, "batch_per_shard": lanes, **kw},
                           num_shards=S, use_native=native, device="cpu")


def _setup(b, depth=3, now=T0, stride=None, linger=None, coalesce=None):
    assert b.pipeline is not None and b.pipeline.enabled
    p = b.pipeline
    p.now_fn = lambda: now
    b.now_fn = lambda: now
    p.depth = depth
    # the occupancy gate holds small test drains behind one in flight
    # (throughput shaping, not correctness): off, so drains overlap
    p.gate_enabled = False
    if stride is not None:
        p.fetch_stride = stride
        p.depth = max(depth, stride + 1)
    if linger is not None:
        p.chain_linger = linger
    if coalesce is not None:
        p.coalesce_wait = coalesce
    return b


def _batcher(eng, depth=3, now=T0, **kw):
    return _setup(WindowBatcher(eng, BehaviorConfig()), depth, now, **kw)


def _jbatcher(eng, depth=3, now=T0, analytics=None, **kw):
    b = _setup(JBatcher(eng, JBehaviorConfig(), analytics=analytics),
               depth, now, **kw)
    # the JAX pipeline caps the stride (its QoS controller's ceiling)
    p = b.pipeline
    p.fetch_stride_max = max(p.fetch_stride, p.fetch_stride_max)
    return b


def _jreqs(reqs):
    return [JReq(name=r.name, unique_key=r.unique_key, hits=r.hits,
                 limit=r.limit, duration=r.duration, algorithm=r.algorithm,
                 behavior=r.behavior) for r in reqs]


def _tuples(resps):
    return [(int(r.status), int(r.limit), int(r.remaining),
             int(r.reset_time), r.error) for r in resps]


def _same_state(ref, port, tag=""):
    got = port.export_arena()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref.state, f)),
                                      err_msg=f"{tag} arena.{f}")
    assert port.windows_processed == ref.windows_processed, tag
    assert port.cache_stats(T0) == ref.cache_stats(T0), tag


def _burst(rng, n=48, keys=12):
    """Token/leaky burst with duplicate-key runs (folded lanes)."""
    return [RateLimitReq(name="ov", unique_key=f"k{rng.integers(0, keys)}",
                         hits=int(rng.integers(0, 3)), limit=20,
                         duration=60_000, algorithm=int(rng.integers(0, 2)))
            for _ in range(n)]


def _runs(rng, n=60, keys=10):
    """hits=1 runs of one key, long enough to cross windows, token and
    leaky: the router folds them into aggregated lanes whose items the
    pipeline answers from their run positions."""
    out = []
    while len(out) < n:
        k = int(rng.integers(0, keys))
        out += [RateLimitReq(name="run", unique_key=f"r{k}", hits=1,
                             limit=7 + k, duration=60_000,
                             algorithm=k % 2)] * int(rng.integers(1, 12))
    return out


async def _gather_submits(b, reqs):
    return await asyncio.gather(*(b.submit(r) for r in reqs))


def _run_both(jb, pb, jreqs, reqs, runner=_gather_submits):
    got_j = asyncio.run(runner(jb, jreqs))
    got_p = asyncio.run(runner(pb, reqs))
    return got_j, got_p


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_bit_identical_to_jax_pipeline_and_serial_oracle(
        jax_engine, depth):
    """Multi-window single-submit bursts (runs that fold, runs that cross
    a 16-lane window) at depth 1/2/3: the port's pipeline answers as the
    JAX pipeline does, leaves the same arena, and answers as the port's
    serial engine.process on the router replaying the same bursts."""
    je = jax_engine(batch_per_shard=16)
    pe, oracle = _engine(lanes=16), _engine(lanes=16)
    rng = np.random.default_rng(11 + depth)
    for w in range(3):
        now = T0 + w * 500
        reqs = _burst(rng, n=40) + _runs(rng)
        jb, pb = _jbatcher(je, depth, now), _batcher(pe, depth, now)
        try:
            got_j, got_p = _run_both(jb, pb, _jreqs(reqs), reqs)
        finally:
            jb.close()
            pb.close()
        assert _tuples(got_p) == _tuples(got_j), (depth, w)
        _same_state(je, pe, (depth, w))
        assert _tuples(got_p) == _tuples(oracle.process(reqs, now=now))
    assert pb.pipeline.decisions_staged > pb.pipeline.lanes_staged


@pytest.mark.parametrize("depth", [2, 3])
def test_concurrent_drains_match_the_oracle(depth):
    """Batches forced into separate overlapped drains commit in dispatch
    order: per-batch results equal sequential replay."""
    eng, ref = _engine(), _engine()
    rng = np.random.default_rng(29)
    batches = [[RateLimitReq(name="cd", unique_key=f"c{rng.integers(0, 6)}",
                             hits=1, limit=30, duration=60_000,
                             algorithm=int(rng.integers(0, 2)))
                for _ in range(16)] for _ in range(depth * 2)]
    # no coalescing wait: each batch pumps its own drain
    b = _batcher(eng, depth, coalesce=0.0)

    async def run():
        tasks = []
        for batch in batches:
            tasks.append(asyncio.ensure_future(b.submit_now(batch)))
            await asyncio.sleep(0)
        return await asyncio.gather(*tasks)

    try:
        got = asyncio.run(run())
    finally:
        b.close()
    for i, batch in enumerate(batches):
        assert _tuples(got[i]) == _tuples(ref.process(batch, now=T0)), i
    assert b.pipeline.decisions_staged == sum(len(x) for x in batches)
    assert b.pipeline.drains >= 2


def test_out_of_order_fetch_completion_is_safe():
    """Delay the FIRST drain's fetch so a later drain's completes first:
    responses still match the oracle."""
    eng, ref = _engine(), _engine()
    b = _batcher(eng, 3)
    pipe = b.pipeline
    order = []
    inner = pipe._complete_sync_one
    slow = {"armed": True}

    def tardy(res):
        if slow.pop("armed", None):
            time.sleep(0.5)
        out = inner(res)
        order.append(res.n_decisions)
        return out

    pipe._complete_sync_one = tardy
    b1 = [RateLimitReq(name="oo", unique_key=f"a{i}", hits=1, limit=9,
                       duration=60_000) for i in range(8)]
    b2 = [RateLimitReq(name="oo", unique_key=f"b{i}", hits=1, limit=9,
                       duration=60_000, algorithm=Algorithm.LEAKY_BUCKET)
          for i in range(5)]

    async def run():
        t1 = asyncio.ensure_future(b.submit_now(b1))
        await asyncio.sleep(0.02)
        t2 = asyncio.ensure_future(b.submit_now(b2))
        return await asyncio.gather(t1, t2)

    try:
        got1, got2 = asyncio.run(run())
    finally:
        b.close()
    assert order == [len(b2), len(b1)], order
    assert _tuples(got1) == _tuples(ref.process(b1, now=T0))
    assert _tuples(got2) == _tuples(ref.process(b2, now=T0))


def _fail_next_dispatch(eng, monkeypatch):
    real = eng.pipeline_dispatch
    armed = {"on": True}

    def broken(*a, **kw):
        if armed.pop("on", None):
            raise RuntimeError("injected dispatch failure")
        return real(*a, **kw)

    monkeypatch.setattr(eng, "pipeline_dispatch", broken)
    return armed


def test_dispatch_failure_fails_only_that_drain_and_commits_nothing(
        monkeypatch):
    """The faulted drain's jobs fail; the router's staging is aborted (a
    hits=0 probe of the same keys sees the full budget, and their slots
    still report a fresh allocation to the next drain)."""
    eng = _engine()
    b = _batcher(eng, 3)
    faulted = [RateLimitReq(name="ft", unique_key=f"f{i}", hits=3, limit=10,
                            duration=60_000) for i in range(6)]
    probe = [RateLimitReq(name="ft", unique_key=f"f{i}", hits=0, limit=10,
                          duration=60_000) for i in range(6)]
    windows0 = eng.windows_processed

    async def run():
        _fail_next_dispatch(eng, monkeypatch)
        with pytest.raises(RuntimeError, match="injected"):
            await b.submit_now(faulted)
        return await b.submit_now(probe)

    try:
        resps = asyncio.run(run())
    finally:
        b.close()
    for r in resps:
        assert r.error == "" and r.remaining == 10, r
    assert b.pipeline._in_flight == 0
    assert eng.windows_processed == windows0 + 1
    assert eng.decisions_processed == len(probe)


def test_commit_order_holds_around_a_failed_drain(monkeypatch):
    """Drain 2 fails while drains 1 and 3 serve: 1 and 3 commit in
    dispatch order with the right per-key state (keys shared by 1 and 3
    see exactly two rounds of hits)."""
    eng, ref = _engine(), _engine()
    b = _batcher(eng, 3)
    mk = lambda: [RateLimitReq(name="sq", unique_key=f"s{i}", hits=1,  # noqa: E731
                               limit=10, duration=60_000) for i in range(5)]
    r1, r2, r3 = mk(), mk(), mk()

    async def run():
        got1 = await b.submit_now(r1)
        _fail_next_dispatch(eng, monkeypatch)
        with pytest.raises(RuntimeError):
            await b.submit_now(r2)
        got3 = await b.submit_now(r3)
        return got1, got3

    try:
        got1, got3 = asyncio.run(run())
    finally:
        b.close()
    assert _tuples(got1) == _tuples(ref.process(r1, now=T0))
    assert _tuples(got3) == _tuples(ref.process(r3, now=T0))


def test_arena_ring_recycles_buffers():
    """Steady-state drains run out of the arena ring: after the first,
    acquires are reuses, and a recycled arena holds zeros where the last
    drain staged."""
    eng = _engine()
    b = _batcher(eng, 2)
    reqs = [RateLimitReq(name="ar", unique_key=f"k{i % 7}", hits=1, limit=50,
                         duration=60_000) for i in range(10)]

    async def run():
        for _ in range(6):
            await b.submit_now(reqs)

    try:
        asyncio.run(run())
    finally:
        b.close()
    snap = b.pipeline.overlap_snapshot()
    assert snap["arena_reuse_events"] >= 4
    assert snap["arena_alloc_events"] <= 2
    assert sum(snap["stage_busy_seconds"].values()) > 0
    assert snap["active_wall_seconds"] > 0 and snap["inflight_windows"] == 0
    for arena in b.pipeline._arena_ring._free:
        assert not arena.packed.any() and not arena.fills.any()
        assert not arena.packed_t.is_pinned()  # a CPU engine's arenas


def test_request_columns_slice_as_a_jobs_own_columns():
    """The singles lane's columns: any [start, stop) of a RequestColumns
    that grew past its first capacity equals the columns a job over the
    same requests builds for itself."""
    rng = np.random.default_rng(31)
    reqs = [RateLimitReq(name=f"n{i % 3}", unique_key=f"key{i * 7}",
                         hits=int(rng.integers(0, 5)),
                         limit=int(rng.integers(1, 1000)),
                         duration=int(rng.integers(1, 10**6)),
                         algorithm=int(rng.integers(0, 2)))
            for i in range(23)]
    cols = RequestColumns(cap=4)
    assert [cols.append(r) for r in reqs] == list(range(len(reqs)))
    for start, stop in ((0, 23), (0, 4), (3, 9), (17, 23), (22, 23)):
        got = cols.take(start, stop)
        want = ListJob(reqs[start:stop]).columns()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    cols.reset()
    assert cols.n == 0 and cols.append(reqs[5]) == 0


@pytest.mark.parametrize("gate", [True, False])
def test_occupancy_gate_holds_a_small_load_behind_a_drain(gate):
    """With a drain in flight, the gate holds batches smaller than one
    window (S x B lanes) until it completes, so they share the next drain
    and the pipeline runs one drain at a time; without it each batch
    dispatches its own drain up to the depth.  The answers are the serial
    engine's either way, and the counters tell the two apart."""
    eng, ref = _engine(), _engine()
    batches = [[RateLimitReq(name="gt", unique_key=f"g{(j * 5 + i) % 9}",
                             hits=1, limit=40, duration=60_000,
                             algorithm=i % 2) for i in range(16)]
               for j in range(3)]
    b = _batcher(eng, 3, coalesce=0.0)
    pipe = b.pipeline
    pipe.gate_enabled = gate
    taken, go = _hold_drains(pipe, (0,))

    async def run():
        loop = asyncio.get_running_loop()
        head = asyncio.ensure_future(b.submit_now(batches[0]))
        await loop.run_in_executor(None, taken[0].wait, 30)
        rest = []
        for batch in batches[1:]:
            rest.append(asyncio.ensure_future(b.submit_now(batch)))
            await asyncio.sleep(0)
        await asyncio.sleep(0.05)
        go[0].set()
        return await asyncio.gather(head, *rest)

    try:
        got = asyncio.run(run())
    finally:
        b.close()
    for i, batch in enumerate(batches):
        assert _tuples(got[i]) == _tuples(ref.process(batch, now=T0)), i
    snap = pipe.overlap_snapshot()
    if gate:
        assert pipe.drains == 2 and pipe.gate_holds >= 2
        assert abs(snap["mean_inflight"] - 1.0) < 1e-9, snap
    else:
        assert pipe.drains == 3 and pipe.gate_holds == 0
        assert snap["mean_inflight"] > 1.5, snap
    assert snap["gate_holds"] == pipe.gate_holds
    assert snap["inflight_windows"] == 0


def test_depth_env_knob(monkeypatch):
    monkeypatch.setenv("GUBER_PIPELINE_DEPTH", "2")
    b = WindowBatcher(_engine(), BehaviorConfig())
    try:
        assert b.pipeline is not None and b.pipeline.depth == 2
    finally:
        b.close()


def test_no_router_no_pipeline():
    b = WindowBatcher(_engine(native=False), BehaviorConfig())
    try:
        assert b.pipeline is None
    finally:
        b.close()


def _stall(pipe, seconds):
    """Hold the engine thread so the drains pumped next dispatch back to
    back and chain up."""
    pipe._engine_executor.submit(time.sleep, seconds)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_fetch_stride_bit_identical_and_chained_drains_share_a_fetch(
        jax_engine, stride):
    """Drains queued behind a stalled engine thread chain and complete
    through one fetch task (fetch_elided counts the fetches saved); every
    answer equals the JAX pipeline's at the same stride and the serial
    oracle's, and the arenas match."""
    je, pe, oracle = jax_engine(), _engine(), _engine()
    rng = np.random.default_rng(43)
    batches = [[RateLimitReq(name="sf", unique_key=f"c{rng.integers(0, 6)}",
                             hits=1, limit=40, duration=60_000,
                             algorithm=int(rng.integers(0, 2)))
                for _ in range(16)] for _ in range(stride)]

    def runner(b, bs):
        async def run():
            _stall(b.pipeline, 0.3)
            tasks = []
            for batch in bs:
                tasks.append(asyncio.ensure_future(b.submit_now(batch)))
                await asyncio.sleep(0)
            return await asyncio.gather(*tasks)
        try:
            return asyncio.run(run())
        finally:
            b.close()

    kw = dict(stride=stride, linger=5.0, coalesce=0.0)
    got_j = runner(_jbatcher(je, **kw), [_jreqs(x) for x in batches])
    pb = _batcher(pe, **kw)
    got_p = runner(pb, batches)
    for i, batch in enumerate(batches):
        assert _tuples(got_p[i]) == _tuples(got_j[i]), i
        assert _tuples(got_p[i]) == _tuples(oracle.process(batch, now=T0))
    _same_state(je, pe, stride)
    pipe = pb.pipeline
    assert pipe.fetch_elided == stride - 1, pipe.overlap_snapshot()
    # stride 1 fetches each drain on its own; no chain forms
    assert (pipe.chain_flushes >= 1) == (stride > 1)


def test_failed_chain_fetch_fails_every_member():
    """One chained fetch is one failure domain: every member's jobs fail,
    and the pipeline keeps serving."""
    eng = _engine()
    b = _batcher(eng, stride=2, linger=5.0, coalesce=0.0)
    pipe = b.pipeline
    inner = pipe._complete_chain_sync
    armed = {"on": True}

    def broken(group):
        if armed.pop("on", None):
            raise RuntimeError("injected chain fetch failure")
        return inner(group)

    pipe._complete_chain_sync = broken
    mk = lambda pfx: [RateLimitReq(name="ff", unique_key=f"{pfx}{i}",  # noqa: E731
                                   hits=1, limit=10, duration=60_000)
                      for i in range(4)]

    async def run():
        _stall(pipe, 0.3)
        t1 = asyncio.ensure_future(b.submit_now(mk("p")))
        await asyncio.sleep(0)
        t2 = asyncio.ensure_future(b.submit_now(mk("q")))
        for t in (t1, t2):
            with pytest.raises(RuntimeError, match="injected"):
                await t
        return await b.submit_now(mk("r"))

    try:
        got = asyncio.run(run())
    finally:
        b.close()
    for g in got:
        assert g.error == "" and g.remaining == 9, g
    assert pipe._in_flight == 0


def test_leftover_jobs_ride_the_next_drain(jax_engine):
    """More lanes than one stack holds (K = 8 windows of 16 lanes a shard):
    the jobs that do not fit go back to the front of the queue and ride
    the next drains, in order, as in the JAX pipeline."""
    je, pe = jax_engine(batch_per_shard=16), _engine(lanes=16)
    rng = np.random.default_rng(3)
    batches = [[RateLimitReq(name="lo", unique_key=f"u{rng.integers(0, 400)}",
                             hits=2, limit=9, duration=60_000,
                             algorithm=int(rng.integers(0, 2)))
                for _ in range(int(rng.integers(20, 90)))] for _ in range(8)]

    def runner(b, bs):
        async def run():
            return await asyncio.gather(*(b.submit_now(x) for x in bs))
        try:
            return asyncio.run(run())
        finally:
            b.close()

    got_j = runner(_jbatcher(je, depth=1), [_jreqs(x) for x in batches])
    pb = _batcher(pe, depth=1)
    got_p = runner(pb, batches)
    assert [_tuples(x) for x in got_p] == [_tuples(x) for x in got_j]
    _same_state(je, pe)
    assert pb.pipeline.drains >= 2


def test_ineligible_requests_take_the_legacy_lane(jax_engine):
    """GCRA, sliding window, concurrency, configs past the compact caps
    and GLOBAL requests go to the batcher's classic lane
    (engine.process on the router); eligible ones ride the pipeline; the
    answers and arena equal the JAX batcher's."""
    je, pe = jax_engine(), _engine()
    rng = np.random.default_rng(17)
    reqs = []
    for i in range(60):
        kind = i % 6
        key = f"m{rng.integers(0, 10)}"
        if kind == 0:
            reqs.append(RateLimitReq(name="lg", unique_key=key, hits=1,
                                     limit=9, duration=60_000,
                                     algorithm=int(rng.integers(2, 5))))
        elif kind == 1:
            reqs.append(RateLimitReq(name="lg", unique_key=f"g{key}", hits=1,
                                     limit=30, duration=60_000,
                                     behavior=Behavior.GLOBAL))
        else:
            reqs.append(RateLimitReq(name="lg", unique_key=f"p{key}",
                                     hits=int(rng.integers(0, 3)), limit=20,
                                     duration=60_000,
                                     algorithm=int(rng.integers(0, 2))))
    pb = _batcher(pe)
    assert not pb.pipeline.eligible(reqs[0]) and not pb.pipeline.eligible(
        reqs[1]) and pb.pipeline.eligible(reqs[2])
    got_j, got_p = _run_both(_jbatcher(je), pb, _jreqs(reqs), reqs)
    pb.close()
    assert _tuples(got_p) == _tuples(got_j)
    _same_state(je, pe)
    # a config past the compact caps (submit_now with one such item): the
    # whole list takes the legacy lane and latches the full path
    big = RateLimitReq(name="lg", unique_key="huge", hits=2**30,
                       limit=2**40, duration=2**35)
    pb = _batcher(pe)
    assert not pb.pipeline.eligible(big)
    try:
        out = asyncio.run(pb.submit_now([reqs[2], big]))
    finally:
        pb.close()
    assert out[1].remaining == 2**40 - 2**30
    assert not pe._compact_enabled
    pb = _batcher(pe)
    assert not pb.pipeline.eligible(reqs[2])
    pb.close()


def _analytics_pair(jax_engine):
    conf, jconf = AnalyticsConfig(**ANALYTICS), JAnalyticsConfig(**ANALYTICS)
    je, pe = jax_engine(), _engine()
    je.enable_analytics(jconf)
    pe.enable_analytics(conf)
    clock = lambda: 1.0  # noqa: E731
    return (je, JTrafficAnalytics(jconf, now_fn=clock),
            pe, TrafficAnalytics(conf, now_fn=clock))


def test_analytics_from_requests_equals_the_jax_pipeline(jax_engine):
    """With analytics on, every drain runs the stats drain and the
    finisher (plain versions here), tenants staged from each request's
    name, and TrafficAnalytics ingests each drain's stats: totals,
    tenants, top-K and occupancy equal the JAX pipeline's, decay
    included."""
    je, jan, pe, pan = _analytics_pair(jax_engine)
    rng = np.random.default_rng(31)
    base = dict(sk.plain_calls), dict(dk.plain_calls)
    for w in range(4):
        now = T0 + w * 700
        reqs = []
        for i in range(90):
            hot = rng.random() < 0.5
            key = "hot" if hot else f"c{rng.integers(0, 40)}"
            reqs.append(RateLimitReq(
                name=f"tenant{rng.integers(0, 8)}" if not hot else "big",
                unique_key=key, hits=1 if hot else int(rng.integers(0, 3)),
                limit=30, duration=2_000, algorithm=int(rng.integers(0, 2))))
        jb = _jbatcher(je, 2, now, analytics=jan)
        pb = _setup(WindowBatcher(pe, BehaviorConfig(), analytics=pan), 2,
                    now)
        try:
            got_j, got_p = _run_both(jb, pb, _jreqs(reqs), reqs)
        finally:
            jb.close()
            pb.close()
        assert _tuples(got_p) == _tuples(got_j), w
        _same_state(je, pe, w)
    assert pan.snapshot() == jan.snapshot()
    snap = pan.snapshot()
    assert snap["totals"]["drains"] >= 4
    assert snap["topk"][0]["key"] == "big_hot"
    assert "big" in snap["tenants"]
    np.testing.assert_array_equal(pe.export_analytics(),
                                  np.asarray(je._an_sketch))
    assert sk.plain_calls["stats_finish"] > base[0]["stats_finish"]
    assert (dk.plain_calls["drain_compact_stats"]
            > base[1]["drain_compact_stats"])


def test_instance_serves_through_the_pipeline_with_analytics_and_slo():
    """Instance builds the router engine from EngineConfig (use_native
    "auto") and hands analytics and the SLO engine to the batcher's
    pipeline: eligible RPC items ride drains, the rest the legacy lane,
    NO_BATCHING through submit_now; answers equal the serial path's."""
    cfg = EngineConfig(**GEOMETRY, num_shards=S)
    inst = Instance(engine_config=cfg, device="cpu",
                    analytics=AnalyticsConfig(**ANALYTICS),
                    slo=SLOConfig(enabled=True))
    ref = _engine()
    try:
        assert inst.engine.native is not None
        pipe = inst.batcher.pipeline
        assert pipe is not None and pipe.analytics is inst.analytics
        assert pipe.slo is inst.slo
        _setup(inst.batcher, 3, T0)
        rng = np.random.default_rng(5)
        # a key keeps one algorithm, so its requests stay on one lane
        # (two lanes answer in their own order, as in the JAX package)
        rpcs = [[RateLimitReq(name=f"svc{i % 3}", unique_key=f"k{k}",
                              hits=int(rng.integers(0, 3)), limit=20,
                              duration=60_000, algorithm=k % 3)
                 for k in rng.integers(0, 15, 30)] for i in range(4)]
        nob = [RateLimitReq(name="nb", unique_key=f"n{i}", hits=1, limit=3,
                            duration=60_000, behavior=Behavior.NO_BATCHING)
               for i in range(3)]

        async def run():
            out = []
            for rpc in rpcs:
                out.append(await inst.get_rate_limits(rpc))
            out.append(await inst.get_rate_limits(nob))
            return out

        got = asyncio.run(run())
    finally:
        inst.close()
    for i, rpc in enumerate(rpcs + [nob]):
        assert _tuples(got[i]) == _tuples(ref.process(rpc, now=T0)), i
    assert pipe.drains >= 4
    assert inst.analytics.snapshot()["totals"]["drains"] == pipe.drains
    assert inst.slo.snapshot()



def _on_shard(prefix, shard, n):
    """n keys of `prefix` whose hash key lies on `shard` of S."""
    out, i = [], 0
    while len(out) < n:
        if shard_of(f"lf_{prefix}{i}", S) == shard:
            out.append(f"{prefix}{i}")
        i += 1
    return out


def _hold_drains(pipe, held):
    """Make the engine thread's drains numbered in `held` (0 = the first)
    wait: drain i sets taken[i] and waits for go[i] before it packs."""
    taken = {i: threading.Event() for i in held}
    go = {i: threading.Event() for i in held}
    inner, count = pipe._drain_sync, [0]

    def drain(*args, **kw):
        i = count[0]
        count[0] += 1
        if i in held:
            taken[i].set()
            go[i].wait(30)
        return inner(*args, **kw)

    pipe._drain_sync = drain
    return taken, go


async def _until(cond):
    for _ in range(10_000):
        if cond():
            return
        await asyncio.sleep(0.001)
    raise AssertionError("timed out")


def _order_scenario(b, first, second, late, lone, warm):
    """Drain 0 serves `warm`; drain 1 (`lone`) is held on the engine thread
    while `first` and `second` (singles, 1000 each) queue up; drain 2
    takes both chunks and is held until `late` (a single) is queued behind
    it.  Returns the answers to second and to late."""
    pipe = b.pipeline
    taken, go = _hold_drains(pipe, (1, 2))

    async def go_():
        loop = asyncio.get_running_loop()
        await b.submit(warm)
        head = asyncio.ensure_future(b.submit(lone))
        await loop.run_in_executor(None, taken[1].wait, 30)
        early = [asyncio.ensure_future(b.submit(r)) for r in first + second]
        await _until(lambda: len(pipe._singles) == len(early))
        go[1].set()
        await loop.run_in_executor(None, taken[2].wait, 30)
        last = asyncio.ensure_future(b.submit(late))
        await _until(lambda: len(pipe._singles) == 1)
        go[2].set()
        got = await asyncio.gather(head, *early)
        return got[1 + len(first):], await last

    try:
        return asyncio.run(go_())
    finally:
        b.close()


def _req2(key, hits=2, limit=10, name="lf"):
    return RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                        duration=60_000)


def _serial(reqs, **geometry):
    return _engine(**geometry).process(reqs, now=T0)


@pytest.mark.parametrize("case", ["leftover", "fallback"])
def test_pipeline_keeps_key_order_where_the_jax_pipeline_does_not(
        jax_engine, case):
    """One drain takes two 1000-item singles chunks; the second's first
    key X is also hit by the first chunk's last item and by a single that
    arrives after the drain was taken.  "leftover": the first chunk fills
    the stack (500 lanes on each shard of 8 x 64) and the second does not
    fit beside it.  "fallback": the first chunk (999 hits on one key)
    fits no stack and takes the full path.  The port answers every item as
    the serial engine does.  The JAX pipeline answers out of order - a fact
    of the reference, pinned here: its leftovers queue behind the single
    taken meanwhile, and its fallback runs after the drain that staged the
    second chunk."""
    geo = dict(capacity_per_shard=2048, batch_per_shard=64)
    second = [_req2(k) for k in (_on_shard("w", 0, 500)
                                 + _on_shard("w", 1, 500))]
    x = second[0].unique_key
    if case == "leftover":
        first = [_req2(k) for s_ in range(S)
                 for k in _on_shard("a", s_, 500)][:-1] + [_req2(x)]
    else:
        first = [_req2("hot", hits=1, limit=5000)] * 999 + [_req2(x)]
    late, lone, warm = _req2(x, hits=1), _req2("lone"), _req2("warm")
    want = _serial([lone] + first + second + [late], **geo)
    got_second, got_late = _order_scenario(
        _batcher(_engine(**geo), depth=1), first, second, late, lone, warm)
    assert _tuples(got_second) == _tuples(want[1 + len(first):-1])
    assert _tuples([got_late]) == _tuples(want[-1:])
    assert (got_second[0].remaining, got_late.remaining) == (6, 5)
    j_second, j_late = _order_scenario(
        _jbatcher(jax_engine(**geo), depth=1), _jreqs(first),
        _jreqs(second), *_jreqs([late, lone, warm]))
    if case == "leftover":   # the late single went before the second chunk
        assert (j_second[0].remaining, j_late.remaining) == (5, 7)
    else:                    # the second chunk went before the first's item
        assert (j_second[0].remaining, j_late.remaining) == (8, 5)


def _deferred_scenario(b, fillers, single, job_req, warm):
    """Drain 0 (`warm`) is held while the singles `fillers + [single]` and
    then one submit_now job of `job_req` queue up; the congestion window
    (4 decisions) defers `single` out of drain 1.  Returns the answers to
    `single` and to the job."""
    pipe = b.pipeline
    taken, go = _hold_drains(pipe, (0,))

    async def go_():
        loop = asyncio.get_running_loop()
        head = asyncio.ensure_future(b.submit(warm))
        await loop.run_in_executor(None, taken[0].wait, 30)
        early = [asyncio.ensure_future(b.submit(r))
                 for r in fillers + [single]]
        await _until(lambda: len(pipe._singles) == len(early))
        job = asyncio.ensure_future(b.submit_now([job_req]))
        await _until(lambda: len(pipe._jobs) == 1)
        go[0].set()
        got = await asyncio.gather(head, *early)
        return got[-1], (await job)[0]

    try:
        return asyncio.run(go_())
    finally:
        b.close()


def test_job_waits_behind_a_deferred_single_where_the_jax_pipeline_does_not(
        jax_engine):
    """With QoS the congestion window (min = max = 4) cuts drain 1 to the
    four fillers and defers the single on key X; a submit_many job on X
    submitted after it must be answered after it, as the serial engine
    answers the submission order.  The JAX pipeline stages the job in
    drain 1, ahead of the deferred single - a fact of the reference,
    pinned here."""
    from gubernator_tpu.config import QoSConfig as JQoSConfig
    from gubernator_tpu.qos import QoSManager as JQoSManager
    from gubernator_tpu_torch.config import QoSConfig
    from gubernator_tpu_torch.qos import QoSManager
    fillers = [_req2(f"f{i}") for i in range(4)]
    single, job_req, warm = _req2("x"), _req2("x"), _req2("warm")
    want = _serial([warm] + fillers + [single, job_req])
    pb = _setup(WindowBatcher(_engine(), BehaviorConfig(), qos=QoSManager(
        QoSConfig(min_window=4, max_window=4))), depth=1)
    got = _deferred_scenario(pb, fillers, single, job_req, warm)
    assert _tuples(got) == _tuples(want[-2:])
    assert (got[0].remaining, got[1].remaining) == (8, 6)
    jb = _setup(JBatcher(jax_engine(), JBehaviorConfig(), qos=JQoSManager(
        JQoSConfig(min_window=4, max_window=4))), depth=1)
    jb.pipeline.fetch_stride_max = max(jb.pipeline.fetch_stride,
                                       jb.pipeline.fetch_stride_max)
    j_single, j_job = _deferred_scenario(
        jb, _jreqs(fillers), *_jreqs([single, job_req, warm]))
    # the job went in drain 1, before the single it followed
    assert (j_single.remaining, j_job.remaining) == (6, 8)


# ------------------------------------------------- adaptive stride (QoS)
# Mirrors tests/test_fetch_chain.py's adaptive-stride tests: the port's
# congestion controller against the JAX one step for step, the pipeline's
# stride policy (the GUBER_FETCH_STRIDE floor, the GUBER_FETCH_STRIDE_MAX
# cap, the deadline bound) on both pipelines, and an idle chain flushing at
# once.


def _controllers(**over):
    from gubernator_tpu.config import QoSConfig as JQoSConfig
    from gubernator_tpu.qos.congestion import (
        CongestionController as JCongestion,
    )
    from gubernator_tpu_torch.config import QoSConfig
    from gubernator_tpu_torch.qos.congestion import CongestionController
    clock = {"t": 0.0}
    now = lambda: clock["t"]  # noqa: E731
    return (CongestionController(QoSConfig(**over), now_fn=now),
            JCongestion(JQoSConfig(**over), now_fn=now), clock)


def _strides(pair):
    p, j = pair
    assert (p.effective_stride(), p.stride_increases, p.stride_decreases,
            p._stride) == (j.effective_stride(), j.stride_increases,
                           j.stride_decreases, j._stride)
    return p.effective_stride()


def test_adaptive_stride_grows_under_backlog_and_shrinks_idle():
    p, j, _ = _controllers()
    both = (p, j)
    for c in both:
        c.observe_drain(0.01)           # healthy latency: not congested
    assert _strides(both) == 1
    for i in range(3):
        for c in both:
            c.observe_chain(backlog_windows=2.0, cap=8)
        assert _strides(both) == 2 + i  # unit additive growth
    for _ in range(20):
        for c in both:
            c.observe_chain(backlog_windows=2.0, cap=8)
    assert _strides(both) == 8          # capped at the operator max
    shrinks = p.stride_decreases
    while _strides(both) > 1:
        for c in both:
            c.observe_chain(backlog_windows=0.0, cap=8)
    assert p.stride_decreases > shrinks
    for c in both:
        c.observe_chain(backlog_windows=0.0, cap=8)
    assert _strides(both) == 1          # never under 1


def test_adaptive_stride_backs_off_under_congestion():
    p, j, clock = _controllers(target_drain_latency=0.05)
    both = (p, j)
    for c in both:
        c.observe_drain(0.01)
    for _ in range(4):
        for c in both:
            c.observe_chain(backlog_windows=3.0, cap=8)
    grown = _strides(both)
    assert grown == 5
    clock["t"] += 1.0
    for c in both:
        c.observe_drain(10.0)           # latency past target: congested
        c.observe_chain(backlog_windows=3.0, cap=8)
    assert p.congested and j.congested
    assert _strides(both) < grown


def test_stride_bound_respects_deadline():
    p, j, _ = _controllers()
    for c in (p, j):
        assert c.stride_bound(0.1) == 1 << 30   # unobserved stages
        assert c.stride_bound(0.0) == 1 << 30   # no deadline configured
        c.observe_stages(host=0.001, device=0.01, fetch=0.02)
    assert [p.stride_bound(b) for b in (0.1, 0.015)] == \
        [j.stride_bound(b) for b in (0.1, 0.015)] == [8, 1]


def test_pipeline_stride_policy_composes_floor_cap_and_bound(jax_engine):
    """_stride_current = clamp(max(floor, AIMD stride), cap, deadline
    bound) on both pipelines; without a QoS manager the floor alone,
    capped."""
    import types
    bs = [_batcher(_engine()), _jbatcher(jax_engine())]
    try:
        pipes = [b.pipeline for b in bs]
        p, j, _ = _controllers()
        for pipe, cc in zip(pipes, (p, j)):
            pipe.fetch_stride, pipe.fetch_stride_max = 2, 6
            assert pipe._stride_current() == 2
            pipe.qos = types.SimpleNamespace(
                congestion=cc,
                conf=types.SimpleNamespace(default_deadline=0.0))
            cc.observe_drain(0.01)
        got = lambda: [q._stride_current() for q in pipes]  # noqa: E731
        assert got() == [2, 2]          # the floor rules while AIMD is 1
        for _ in range(10):
            for cc in (p, j):
                cc.observe_chain(backlog_windows=2.0, cap=8)
        assert got() == [6, 6]          # AIMD grew; the operator cap
        for pipe, cc in zip(pipes, (p, j)):
            cc.observe_stages(host=0.001, device=0.01, fetch=0.02)
            pipe.qos.conf.default_deadline = 0.05
        assert got() == [3, 3]          # the bound: (0.05 - 0.02) / 0.01
    finally:
        for b in bs:
            b.pipeline.qos = None
            b.close()


def test_single_drain_flushes_immediately_at_idle():
    """Light load degenerates to stride 1: an isolated drain with nothing
    queued behind it flushes its chain of one without waiting out the
    stride or the linger timer."""
    b = _batcher(_engine(), stride=8, linger=30.0)
    pipe = b.pipeline
    reqs = [RateLimitReq(name="id", unique_key=f"i{i}", hits=1, limit=10,
                         duration=60_000) for i in range(6)]

    async def run():
        t0 = time.monotonic()
        got = await asyncio.wait_for(b.submit_now(reqs), timeout=10)
        return got, time.monotonic() - t0

    try:
        assert pipe._stride_current() == 8
        got, wall = asyncio.run(run())
    finally:
        b.close()
    for g in got:
        assert g.error == "" and g.remaining == 9
    assert wall < 5.0
    assert pipe.chain_flushes >= 1 and pipe.fetch_elided == 0


def test_qos_pipeline_grows_the_stride_under_backlog_and_answers_alike():
    """With a QoS manager the pipeline's chain follows the controller:
    under a held backlog the stride grows past the GUBER_FETCH_STRIDE
    floor (up to GUBER_FETCH_STRIDE_MAX), the depth follows the window,
    and every answer equals the serial engine's."""
    from gubernator_tpu_torch.config import QoSConfig
    from gubernator_tpu_torch.qos import QoSManager
    rng = np.random.default_rng(11)
    reqs = [RateLimitReq(name=f"t{int(rng.integers(0, 3))}",
                         unique_key=f"k{int(rng.integers(0, 40))}",
                         hits=int(rng.integers(0, 3)), limit=30,
                         duration=60_000) for _ in range(600)]
    mgr = QoSManager(QoSConfig())
    b = WindowBatcher(_engine(), BehaviorConfig(), qos=mgr)
    _setup(b, depth=3)
    pipe = b.pipeline
    pipe.fetch_stride_max = 4
    mgr.congestion.observe_drain(0.001)
    for _ in range(3):
        mgr.congestion.observe_chain(backlog_windows=2.0, cap=4)
    assert pipe._stride_current() == 4

    async def run():
        return await asyncio.gather(*(b.submit(r) for r in reqs))

    try:
        got = asyncio.run(run())
    finally:
        b.close()
    assert pipe.overlap_snapshot()["fetch_stride_target"] >= 1
    assert mgr.admission.pending == 0
    # fair slotting reorders lanes across tenants only: each key keeps
    # its submission order, so every key answers as in the serial engine
    want = _serial(reqs)
    per_key = lambda rs: {  # noqa: E731
        k: _tuples([g for q, g in zip(reqs, rs) if q.hash_key() == k])
        for k in {q.hash_key() for q in reqs}}
    assert per_key(got) == per_key(want)
