"""Lockstep serving in one process: the port's WindowBatcher on a
LockstepClock against the JAX package's, built as
tests/test_lockstep_drain.py builds it (8 shards, the native router, a
tick clock).

Every request is queued before either tick loop starts, so both run the
same ticks on the same clock and take the same work each tick: the
pipeline's drain (token and leaky singles in the compact ranges, and
GLOBAL singles riding the drain's GLOBAL window) and the tick's stacked
step (the rest: GCRA, sliding window, concurrency, configs past the
compact caps).  Held equal bit for bit: every response, every regular
plane, the GLOBAL replica and its config, and what each pipeline staged.
A multiprocess engine without a clock raises, as in the JAX package.

A tick that fails is realigned only when it issued no all-reduce: on rank
0 of a two-rank mesh whose other rank adds nothing (`_LoopbackMesh`, one
process), a fault injected in the GLOBAL window before its all-reduce
(global_stage_read) is replaced by the empty dispatch and serving goes
on, and one injected after it (global_apply_rows) fail-stops the batcher;
either way every tick issued the same all-reduces and the GLOBAL scratch
is left zero.
"""

import asyncio

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)

from gubernator_tpu import compat
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.config import BehaviorConfig as JBehaviors
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.core.batcher import WindowBatcher as JBatcher
from gubernator_tpu.parallel.distributed import LockstepClock as JClock
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch import native
from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.core.batcher import WindowBatcher
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.ops import kernel
from gubernator_tpu_torch.ops import global_kernel
from gubernator_tpu_torch.parallel.distributed import LockstepClock, Mesh

pytestmark = [pytest.mark.torch_port, pytest.mark.skipif(
    not native.available(), reason="native router unavailable")]

T0 = 1_700_000_000_000
GEOM = dict(capacity_per_shard=64, batch_per_shard=32, global_capacity=16,
            global_batch_per_shard=8, max_global_updates=8)
FIELDS = ("limit", "duration", "remaining", "tstamp", "expire", "algo")
INTERVAL = 0.02


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture
def check_vma_off(monkeypatch):
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()
    yield
    _clear_jax_executable_caches()


def traffic(rng, n=90):
    """Eligible singles with duplicate runs, GLOBAL singles (token and
    leaky, four keys), GCRA / sliding / concurrency and an over-cap limit
    for the stacked step."""
    out = []
    for _ in range(n):
        u = rng.random()
        if u < 0.2:
            out.append(RateLimitReq(
                name="lg", unique_key=f"g{rng.integers(0, 4)}",
                hits=int(rng.integers(0, 3)), limit=40, duration=60_000,
                algorithm=int(rng.integers(0, 2)),
                behavior=Behavior.GLOBAL))
        elif u < 0.35:
            out.append(RateLimitReq(
                name="lo", unique_key=f"o{rng.integers(0, 6)}",
                hits=int(rng.integers(0, 3)), limit=int(rng.integers(2, 9)),
                duration=60_000, algorithm=int(rng.integers(2, 5))))
        elif u < 0.38:
            out.append(RateLimitReq(
                name="lb", unique_key=f"b{rng.integers(0, 2)}", hits=1,
                limit=int(kernel.COMPACT_MAX_LIMIT) + 5, duration=60_000))
        else:
            out.append(RateLimitReq(
                name="lr", unique_key=f"k{rng.integers(0, 12)}",
                hits=int(rng.integers(0, 4)), limit=int(rng.integers(3, 12)),
                duration=60_000, algorithm=int(rng.integers(0, 2))))
    return out


def _serve(b, reqs):
    """Queue every request, then tick until all are answered, then stop
    at the next tick; returns the responses."""
    async def run():
        tasks = [asyncio.ensure_future(b.submit(r)) for r in reqs]
        await asyncio.sleep(0)
        b.start_lockstep()
        out = await asyncio.gather(*tasks)
        b.stop_at_tick = b.clock.tick
        await b._tick_task
        # the last ticks' drains commit before the loop closes (each
        # committed drain writes its timeline row)
        for _ in range(10_000):
            if not b.pipeline._in_flight:
                break
            await asyncio.sleep(0.001)
        return out
    try:
        return asyncio.run(run())
    finally:
        b.close()


@pytest.mark.parametrize("stack", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_lockstep_batcher_equals_the_jax_one(check_vma_off, stack, seed):
    reqs = traffic(np.random.default_rng(40 + seed))
    jeng = jengine.RateLimitEngine(mesh=make_mesh(), **GEOM)
    jb = JBatcher(jeng, JBehaviors(batch_wait=INTERVAL,
                                   lockstep_stack=stack),
                  lockstep_clock=JClock(T0, INTERVAL))
    assert jb.pipeline is not None and jb.pipeline.lockstep
    want = _serve(jb, [JReq(name=r.name, unique_key=r.unique_key,
                            hits=r.hits, limit=r.limit, duration=r.duration,
                            algorithm=r.algorithm, behavior=r.behavior)
                       for r in reqs])
    eng = RateLimitEngine(num_shards=8, device="cpu", use_native="on",
                          **GEOM)
    b = WindowBatcher(eng, BehaviorConfig(batch_wait=INTERVAL,
                                          lockstep_stack=stack),
                      lockstep_clock=LockstepClock(T0, INTERVAL))
    assert b.pipeline is not None and b.pipeline.lockstep
    assert not b.pipeline.rpc_enabled
    got = _serve(b, reqs)
    for j, (g, w) in enumerate(zip(got, want)):
        assert (g.status, g.limit, g.remaining, g.reset_time, g.error) == \
            (int(w.status), w.limit, w.remaining, w.reset_time,
             w.error), (j, reqs[j])
    arena = eng.export_arena()
    for f in FIELDS:
        np.testing.assert_array_equal(arena[f], np.asarray(
            getattr(jeng.state, f)), f)
        np.testing.assert_array_equal(arena[f"gstate.{f}"], np.asarray(
            getattr(jeng.gstate, f)), f)
    for f in ("limit", "duration", "algo"):
        np.testing.assert_array_equal(arena[f"gcfg.{f}"], np.asarray(
            getattr(jeng.gcfg, f)), f)
    # the same work rode each lane: GLOBAL singles in the drain's GLOBAL
    # window, the rest of the eligible traffic folded in its stack
    assert (b.pipeline.decisions_staged, b.pipeline.lanes_staged) == (
        jb.pipeline.decisions_staged, jb.pipeline.lanes_staged)
    n_global = sum(r.behavior == Behavior.GLOBAL for r in reqs)
    assert b.pipeline.decisions_staged >= n_global > 0
    # every tick's drain, an idle one too, committed a timeline row
    rows = b.pipeline.timeline.drains()
    assert len(rows) == b.pipeline.drains
    assert rows["decisions"].sum() == b.pipeline.decisions_staged
    assert (rows["submitted"] > 0).all() and (rows["held_since"] == 0).all()
    for a, c in (("submitted", "started"), ("started", "dispatch_done"),
                 ("dispatch_done", "fetch_done"), ("fetch_done", "committed")):
        assert (rows[a] <= rows[c]).all(), (a, c)


def test_multiprocess_engine_without_a_clock_raises():
    class FakeMultiprocessEngine:
        multiprocess = True
        native = object()

    with pytest.raises(ValueError, match="lockstep_clock"):
        WindowBatcher(FakeMultiprocessEngine(), BehaviorConfig())


class _LoopbackMesh(Mesh):
    """Rank 0 of a two-rank mesh whose other rank adds nothing: the
    all-reduce leaves the sums as they are and only counts itself."""

    def __init__(self, local_shards):
        super().__init__(world_size=2, rank=0, local_shards=local_shards)

    def all_reduce_(self, t):
        self.reductions += 1
        return t


@pytest.mark.parametrize("use_native", [False, "on"],
                         ids=["step", "pipeline"])
@pytest.mark.parametrize("where", ["before", "after"])
def test_a_failed_tick_realigns_only_before_its_all_reduce(
        monkeypatch, where, use_native):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    mesh = _LoopbackMesh(4)
    eng = RateLimitEngine(num_shards=4, device="cpu", use_native=use_native,
                          mesh=mesh, **GEOM)
    eng.register_global_keys([("lf_g", 100, 60_000, 0)], now=T0)
    b = WindowBatcher(eng, BehaviorConfig(batch_wait=INTERVAL),
                      lockstep_clock=LockstepClock(T0, INTERVAL))
    assert (b.pipeline is not None) == bool(use_native)
    # the drain's GLOBAL window and the step's each all-reduce once a tick
    per_tick = 1 + (b.pipeline is not None)
    name = "global_stage_read" if where == "before" else "global_apply_rows"
    real = getattr(global_kernel, name)
    fired = []

    def once(*args, **kw):
        if not fired:
            fired.append(mesh.reductions)
            raise RuntimeError("injected fault")
        return real(*args, **kw)

    req = RateLimitReq(name="lf", unique_key="g", hits=1, limit=100,
                       duration=60_000, behavior=Behavior.GLOBAL)

    async def run():
        b.start_lockstep()
        assert (await b.submit(req)).error == ""
        monkeypatch.setattr(global_kernel, name, once)
        while not fired:
            await asyncio.sleep(0.005)
        if where == "before":
            assert (await b.submit(req)).error == ""
            await b.stop_lockstep(timeout=30)
        else:
            with pytest.raises(RuntimeError, match="injected fault"):
                await asyncio.wait_for(b._tick_task, 30)
            with pytest.raises(RuntimeError, match="left the mesh"):
                await b.submit(req)

    try:
        asyncio.run(run())
    finally:
        b.close()
    # no tick issued a second all-reduce (nor skipped one), and none ran
    # after the fail-stop
    assert mesh.reductions == per_tick * b.clock.tick
    assert not eng._gsums.any()
