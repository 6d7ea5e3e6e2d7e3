"""The port's serving path (RateLimitEngine, WindowBatcher, Instance) on the
CPU against the JAX package's engine, request for request.

Both engines get one request stream with the same clock.  The reference is
`gubernator_tpu`'s RateLimitEngine with the Python slot tables
(use_native=False) and no GLOBAL traffic (skip_global=True) on a
one-CPU-device mesh - the port's geometry, so slot assignment, eviction
and compact-path choice line up.  Under the installed JAX the JAX engine's
XLA step executables fail shard_map's trace-time replication check (it
cannot infer replication of the replicated GLOBAL-arena outputs), on this
mesh as on the default one; the fixture turns that check off.  It
computes nothing, as gubernator_tpu/compat.py says, so the executables
are unchanged.

Compared exactly: every response field, the arena plane for plane
(`export_arena()` vs the JAX engine's `state`), the compact latch, the
window count, and for `pipeline_dispatch` every valid lane's word and
limit plus the mismatch flags.
"""

import asyncio

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)
import jax

from gubernator_tpu import compat
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.core.service import BatchTooLargeError, Instance
from gubernator_tpu_torch.ops import drain_kernel as dk

from .test_fused_megakernel import _random_packed

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000
FIELDS = ("limit", "duration", "remaining", "tstamp", "expire", "algo")


@pytest.fixture
def engines(monkeypatch):
    """make(C, B) -> (jax_engine, port_engine) on matching geometry."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    # device 4 carries no other test's one-device mesh, so the executables
    # cached for it are only ever built here
    mesh = make_mesh(jax.devices("cpu")[4:5])

    def make(C=64, B=64, replay_cap=None):
        ref = jengine.RateLimitEngine(
            mesh=mesh, capacity_per_shard=C, batch_per_shard=B,
            global_capacity=8, global_batch_per_shard=8,
            max_global_updates=8, use_native=False, skip_global=True,
            replay_cap=replay_cap)
        port = RateLimitEngine(capacity_per_shard=C, batch_per_shard=B,
                               replay_cap=replay_cap, device="cpu")
        return ref, port
    return make


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
    assert port._compact_sound == ref._compact_sound, tag
    assert port.windows_processed == ref.windows_processed, tag


def _drive(ref, port, windows):
    """Feed (requests, now) windows to both engines; returns the port's
    responses after asserting they and the arenas match the reference."""
    out = []
    for w, (reqs, now) in enumerate(windows):
        want = ref.process(_jreqs(reqs), now=now)
        got = port.process(reqs, now=now)
        assert _tuples(got) == _tuples(want), f"window {w}"
        _assert_same_state(ref, port, f"window {w}")
        out.extend(got)
    return out


def _req(key, hits=1, limit=5, duration=60_000, algo=0, name="t"):
    return RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                        duration=duration, algorithm=algo)


@pytest.mark.parametrize("algo", [0, 1])
def test_repeated_hits_to_over_limit(engines, algo):
    ref, port = engines()
    windows = [([_req("k", algo=algo)], T0 + 10 * i) for i in range(7)]
    got = _drive(ref, port, windows)
    # limit 5 over 60 s: 5 UNDER then OVER; leaky leaks nothing in 60 ms
    assert [r.status for r in got] == [0] * 5 + [1] * 2


def test_duplicate_key_burst_in_one_window(engines):
    ref, port = engines()
    rng = np.random.default_rng(3)
    burst = [_req(f"k{rng.integers(0, 4)}", hits=int(rng.integers(0, 4)),
                  limit=10, algo=int(rng.integers(0, 5)))
             for _ in range(40)]
    _drive(ref, port, [(burst, T0), (burst, T0 + 30_000)])


def test_flood_larger_than_one_window_chunks(engines):
    ref, port = engines(B=64)
    flood = [_req(f"f{i % 90}", limit=3) for i in range(150)]
    _drive(ref, port, [(flood, T0), (flood, T0 + 5)])
    assert port.windows_processed == 6


def test_tiny_capacity_evicts_and_recycles(engines):
    ref, port = engines(C=8)
    rng = np.random.default_rng(9)
    windows = []
    for w in range(6):
        reqs = [_req(f"e{rng.integers(0, 30)}", hits=int(rng.integers(0, 3)),
                     limit=4, duration=int(rng.choice([50, 60_000])),
                     algo=int(rng.integers(0, 2)))
                for _ in range(12)]
        windows.append((reqs, T0 + 40 * w))
    _drive(ref, port, windows)
    assert port.cache_stats(T0)["size"] == 8


def test_out_of_cap_config_takes_full_path_and_latches(engines):
    ref, port = engines()
    small = [_req(f"s{i}", limit=7) for i in range(10)]
    big = [_req("big", hits=2**30, limit=2**40, duration=2**35)]
    windows = [(small, T0), (small + big, T0 + 1), (small, T0 + 2),
               ([_req(f"s{i}", hits=-2, algo=4, limit=9) for i in range(5)],
                T0 + 3)]
    _drive(ref, port, windows[:1])
    assert port._compact_sound
    _drive(ref, port, windows[1:])
    assert not port._compact_sound and not port._compact_enabled


def test_random_stream_all_algorithms(engines):
    ref, port = engines()
    rng = np.random.default_rng(23)
    keys = [f"a{i}" for i in range(24)]
    algo = {k: int(rng.integers(0, 5)) for k in keys}
    limit = {k: int(rng.integers(1, 30)) for k in keys}
    dur = {k: int(rng.choice([50, 2_000, 60_000])) for k in keys}
    now = T0
    windows = []
    for _ in range(8):
        now += int(rng.choice([3, 40, 700, 30_000, 70_000]))
        reqs = []
        for _ in range(int(rng.integers(1, 40))):
            k = str(rng.choice(keys))
            h = (int(rng.integers(-4, 5)) if algo[k] == 4
                 else int(rng.integers(0, limit[k] + 2)))
            reqs.append(_req(k, hits=h, limit=limit[k], duration=dur[k],
                             algo=algo[k]))
        windows.append((reqs, now))
    _drive(ref, port, windows)
    for f in ("size", "hits", "misses", "live", "expired"):
        assert port.cache_stats(now)[f] == ref.cache_stats(now)[f], f


# request lists for the replay-bound guard: (requests, window prefix the
# guard allows at GUBER_REPLAY_CAP=2)
def _replay_lists():
    mixed = [_req("m", hits=h, algo=1) for h in (1, 1, 0, 2, 1)]
    return {
        "three lanes, hits 1 2 3": ([_req("k", hits=h) for h in (1, 2, 3)],
                                    2),
        "uniform run of 7": ([_req("u") for _ in range(7)], 7),
        "uniform then zero": ([_req("z") for _ in range(4)]
                              + [_req("z", hits=0)] * 2, 4),
        "two keys interleaved": ([_req(f"i{j % 2}", hits=1 + j // 2)
                                  for j in range(8)], 4),
        "mixed leaky run": (mixed, 2),
    }


@pytest.mark.parametrize("cap", ["2", "0", None], ids=["2", "0", "unset"])
def test_replay_cap_env_matches_jax_engine(engines, monkeypatch, cap):
    """GUBER_REPLAY_CAP overrides the engine's argument in both engines
    (2: a non-uniform run is cut after two lanes, a uniform run is not;
    0: no guard; unset: the argument, here 64): the same
    max_window_prefix on every list, and `process` of all the lists in
    one call gives the same responses, arena and windows_processed."""
    if cap is None:
        monkeypatch.delenv("GUBER_REPLAY_CAP", raising=False)
    else:
        monkeypatch.setenv("GUBER_REPLAY_CAP", cap)
    ref, port = engines(replay_cap=64)
    want_cap = 64 if cap is None else int(cap)
    assert port.replay_cap == ref.replay_cap == want_cap
    lists = _replay_lists()
    for name, (reqs, at_two) in lists.items():
        got = port.max_window_prefix(reqs)
        assert got == ref.max_window_prefix(_jreqs(reqs)), name
        assert got == (at_two if cap == "2" else len(reqs)), name
    stream = [r for reqs, _ in lists.values() for r in reqs]
    _drive(ref, port, [(stream, T0), (stream, T0 + 40)])
    assert port.windows_processed == ref.windows_processed
    assert port.windows_processed == (12 if cap == "2" else 2)


def test_replay_cap_env_not_an_integer_raises_in_both(engines, monkeypatch):
    """A GUBER_REPLAY_CAP that is not an integer stops both engines at
    construction with the same ValueError."""
    monkeypatch.setenv("GUBER_REPLAY_CAP", "x")
    with pytest.raises(ValueError) as port_err:
        RateLimitEngine(capacity_per_shard=64, batch_per_shard=64,
                        device="cpu")
    with pytest.raises(ValueError) as ref_err:
        engines()
    assert str(port_err.value) == str(ref_err.value)
    assert "GUBER_REPLAY_CAP must be an integer" in str(port_err.value)


def test_pipeline_dispatch_k4(engines):
    ref, port = engines()
    rng = np.random.default_rng(12)
    K, B, C = 4, 64, 64
    stack = np.zeros((K, 1, B, 2), np.int64)
    for k in range(K):
        stack[k, 0] = np.asarray(_random_packed(rng, B, C, hot=3))
    nows = np.asarray([T0 + 10 * i for i in range(K)], np.int64)
    jw, jl, jm = ref.pipeline_dispatch(stack, nows)
    tw, tl, tm = port.pipeline_dispatch(stack, nows)
    assert tuple(tw.shape) == (K, 1, B) and tuple(tm.shape) == (K, 1)
    valid = (stack[..., 0] & 0xFFFFFFFF) != 0
    np.testing.assert_array_equal(tw.numpy()[valid], np.asarray(jw)[valid])
    np.testing.assert_array_equal(tl.numpy()[valid], np.asarray(jl)[valid])
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert not tw.numpy()[~valid].any()
    _assert_same_state(ref, port, "drain")


def test_warmup_leaves_the_arena_untouched(engines):
    _, port = engines()
    port.warmup(now=T0)
    assert all(not a.any() for a in port.export_arena().values())
    assert port.windows_processed == 2  # full + one compact bucket
    assert dk.launches == {"drain_compact": 0, "drain_compact_stats": 0,
                           "window_full": 0}


def test_global_refuses_algorithms_2_to_4(engines):
    """GLOBAL requests on GCRA, sliding window and concurrency are not
    served: the Instance answers each with the JAX service's per-item error
    and runs no window.  (GLOBAL on token and leaky is served:
    tests/test_torch_engine_global.py.)"""
    _, port = engines()
    inst = Instance(engine=port)

    async def run():
        return await inst.get_rate_limits([
            RateLimitReq(name="g", unique_key="k", hits=1, limit=5,
                         duration=1000, algorithm=a, behavior=Behavior.GLOBAL)
            for a in (2, 3, 4)])

    try:
        errors = [r.error for r in asyncio.run(run())]
    finally:
        inst.close()
    assert errors == [
        f"while applying rate limit for 'g_k' - 'GLOBAL behavior does not "
        f"support algorithm '{a}''" for a in (2, 3, 4)]
    assert port.windows_processed == 0


def test_instance_get_rate_limits_matches_jax_engine(engines):
    """Three RPCs of 100 items through Instance.get_rate_limits (batcher
    window -> engine.process) vs the JAX engine on the same items, plus
    the per-item validation errors and the RPC cap."""
    ref, port = engines(C=256, B=128)
    inst = Instance(engine=port, behaviors=BehaviorConfig(batch_wait=0.05))
    rng = np.random.default_rng(31)

    async def run():
        out = []
        for i in range(3):
            inst.batcher.now_fn = lambda i=i: T0 + 1000 * i
            reqs = [_req(f"i{rng.integers(0, 60)}",
                         hits=int(rng.integers(0, 3)), limit=4,
                         algo=int(rng.integers(0, 5)))
                    for _ in range(100)]
            got = await inst.get_rate_limits(reqs)
            want = ref.process(_jreqs(reqs), now=T0 + 1000 * i)
            out.append((_tuples(got), _tuples(want)))
        bad = await inst.get_rate_limits([
            RateLimitReq(name="n", unique_key=""),
            RateLimitReq(name="", unique_key="k"),
            RateLimitReq(name="n", unique_key="k", algorithm=7),
            RateLimitReq(name="n", unique_key="k", algorithm=2,
                         behavior=Behavior.GLOBAL),
        ])
        with pytest.raises(BatchTooLargeError):
            await inst.get_rate_limits([_req("x")] * 1001)
        health = await inst.health_check()
        return out, [r.error for r in bad], health

    try:
        out, errors, health = asyncio.run(run())
    finally:
        inst.close()
    for i, (got, want) in enumerate(out):
        assert got == want, f"rpc {i}"
    assert port.windows_processed == 3
    assert errors[:3] == [
        "field 'unique_key' cannot be empty",
        "field 'namespace' cannot be empty",
        "while applying rate limit for 'n_k' - "
        "'invalid rate limit algorithm '7''"]
    assert "GLOBAL" in errors[3]
    assert health.status == "healthy"
    _assert_same_state(ref, port, "instance")
