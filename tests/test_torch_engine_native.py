"""The port's engine with the native router against the JAX package's
engine with its native router, on the CPU.

The reference is `gubernator_tpu`'s RateLimitEngine with use_native="on"
on a two-CPU-device mesh (S = 2, GLOBAL served); the port is
`RateLimitEngine(num_shards=2, use_native="on", device="cpu")` at the same
geometry, which routes regular keys through its own copy of the router and
runs the plain versions of its kernels.  Both routers assign slots alike,
so the arenas are compared plane for plane.  As in the other port tests the
fixture turns shard_map's trace-time replication check off for the JAX
engine and empties its executable caches before and after.

Compared exactly after every window: every response field, the regular
arena, the GLOBAL arena and its config, `cache_stats`, the window count
and the compact latch.  The last tests hold the port's router path against
its Python-table path, responses only (the two assign slots differently).
"""

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)
import jax

from gubernator_tpu import compat
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.core.engine import (
    GCFG_FIELDS,
    GSTATE_FIELDS,
    PIPELINE_K_BUCKETS,
    RateLimitEngine,
)
from gubernator_tpu_torch.ops import drain_kernel as dk

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000
S = 2
FIELDS = ("limit", "duration", "remaining", "tstamp", "expire", "algo")


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture
def engines(monkeypatch):
    """make(**geometry) -> (jax_engine, port_engine), both with the
    native router."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()
    mesh = make_mesh(jax.devices("cpu")[2:4])

    def make(C=64, B=16, G=16, Bg=8, Kg=8, replay_cap=None,
             exact_keys=False):
        ref = jengine.RateLimitEngine(
            mesh=mesh, capacity_per_shard=C, batch_per_shard=B,
            global_capacity=G, global_batch_per_shard=Bg,
            max_global_updates=Kg, use_native="on", replay_cap=replay_cap,
            exact_keys=exact_keys)
        port = RateLimitEngine(
            capacity_per_shard=C, batch_per_shard=B, num_shards=S,
            global_capacity=G, global_batch_per_shard=Bg,
            max_global_updates=Kg, replay_cap=replay_cap, device="cpu",
            use_native="on", exact_keys=exact_keys)
        assert ref.native is not None and port.native is not None
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


def _assert_same_state(ref, port, now, tag=""):
    got = port.export_arena()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref.state, f)),
                                      err_msg=f"{tag} arena.{f}")
    for name, a in zip(GSTATE_FIELDS + GCFG_FIELDS, (*ref.gstate, *ref.gcfg)):
        np.testing.assert_array_equal(got[name], np.asarray(a),
                                      err_msg=f"{tag} {name}")
    assert port.cache_stats(now) == ref.cache_stats(now), tag
    assert port._compact_sound == ref._compact_sound, tag
    assert port._compact_enabled == ref._compact_enabled, tag
    assert port.windows_processed == ref.windows_processed, tag
    assert port.decisions_processed == ref.decisions_processed, tag


def _drive(ref, port, windows):
    """Feed (requests, now[, accumulate]) windows to both engines; returns
    the port's responses after asserting they and every arena match."""
    out = []
    for w, (reqs, now, *acc) in enumerate(windows):
        acc = acc[0] if acc else None
        want = ref.process(_jreqs(reqs), now=now, accumulate=acc)
        got = port.process(reqs, now=now, accumulate=acc)
        assert _tuples(got) == _tuples(want), f"window {w}"
        _assert_same_state(ref, port, now, f"window {w}")
        out.extend(got)
    return out


def _req(key, hits=1, limit=5, duration=60_000, algo=0, name="t",
         behavior=Behavior.BATCHING):
    return RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                        duration=duration, algorithm=algo, behavior=behavior)


def _stream(rng, n_windows, n_keys=24, per=40, algos=(0, 1), glob=0.0,
            hits_hi=3, dup=0.5):
    """Windows with duplicate runs: each window repeats some of its
    requests back to back (hits=1 runs fold into aggregated lanes)."""
    keys = [f"s{i}" for i in range(n_keys)]
    cfg = {k: (int(rng.integers(1, 20)), int(rng.choice([50, 2_000, 60_000])),
               int(rng.choice(algos))) for k in keys}
    windows, now = [], T0
    for _ in range(n_windows):
        now += int(rng.choice([0, 7, 400, 70_000]))
        reqs = []
        while len(reqs) < per:
            k = str(rng.choice(keys))
            lim, dur, algo = cfg[k]
            g = rng.random() < glob and algo in (0, 1)
            h = (int(rng.integers(-3, 4)) if algo == 4
                 else int(rng.integers(0, hits_hi)))
            run = int(rng.integers(2, 7)) if rng.random() < dup else 1
            reqs += [_req(k, hits=1 if run > 1 else h, limit=lim,
                          duration=dur, algo=algo,
                          behavior=Behavior.GLOBAL if g else
                          Behavior.BATCHING)] * run
        windows.append((reqs, now))
    return windows


@pytest.mark.parametrize("seed", [1, 2])
def test_random_streams_with_duplicate_runs(engines, seed):
    ref, port = engines()
    _drive(ref, port, _stream(np.random.default_rng(seed), 6))


def test_all_five_algorithms(engines):
    ref, port = engines()
    _drive(ref, port, _stream(np.random.default_rng(5), 6,
                              algos=(0, 1, 2, 3, 4), dup=0.3))


def test_flood_larger_than_the_window_chunks(engines):
    ref, port = engines(B=16)
    flood = [_req(f"f{i % 50}", limit=3) for i in range(120)]
    _drive(ref, port, [(flood, T0), (flood, T0 + 5)])
    assert port.windows_processed > 4


@pytest.mark.parametrize("algo", [0, 1])
def test_global_requests_beside_regular_ones(engines, algo):
    ref, port = engines()
    g = lambda h, key="g1": _req(key, hits=h, limit=50, algo=algo,  # noqa: E731
                                 behavior=Behavior.GLOBAL)
    flood = [_req(f"k{i % 30}", limit=5) for i in range(60)]
    many_g = [g(1, f"g{i % 12}") for i in range(40)]
    _drive(ref, port, [
        ([g(3)] + flood + [g(2)], T0),
        ([g(0)], T0 + 5),
        (many_g + flood, T0 + 10),
        ([g(1), g(2), _req("k1")], T0 + 20, [True, False, True]),
    ])


def test_global_in_a_random_stream(engines):
    ref, port = engines()
    _drive(ref, port, _stream(np.random.default_rng(8), 5, glob=0.25))


def test_int64_config_latches_the_full_path(engines):
    ref, port = engines()
    small = [_req(f"s{i}", limit=7) for i in range(10)]
    big = [_req("big", hits=2**30, limit=2**40, duration=2**35)]
    _drive(ref, port, [(small, T0)])
    assert port._compact_sound
    _drive(ref, port, [(small + big, T0 + 1), (small, T0 + 2),
                       ([_req(f"s{i}", hits=-2, algo=4, limit=9)
                         for i in range(5)], T0 + 3)])
    assert not port._compact_sound and not port._compact_enabled


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


@pytest.mark.parametrize("cap", ["2", "0", None], ids=["2", "0", "unset"])
def test_replay_cap_env(engines, monkeypatch, cap):
    """GUBER_REPLAY_CAP reaches both routers: a mixed-config hot run is
    cut into windows the same way."""
    if cap is None:
        monkeypatch.delenv("GUBER_REPLAY_CAP", raising=False)
    else:
        monkeypatch.setenv("GUBER_REPLAY_CAP", cap)
    ref, port = engines()
    assert port.replay_cap == ref.replay_cap
    mixed = [_req("m", hits=h, algo=1) for h in (1, 1, 0, 2, 1, 3, 1)]
    runs = [_req(f"i{j % 2}", hits=1 + j // 2) for j in range(8)]
    _drive(ref, port, [(mixed + runs, T0), (runs + mixed, T0 + 1)])


def test_exact_keys_env(engines, monkeypatch):
    monkeypatch.setenv("GUBER_EXACT_KEYS", "1")
    ref, port = engines(C=16)
    assert port.native.exact and ref.native.exact
    _drive(ref, port, _stream(np.random.default_rng(4), 5, n_keys=40))


def test_empty_call_dispatches_one_window(engines):
    ref, port = engines()
    _drive(ref, port, [([], T0), ([_req("a")], T0 + 1), ([], T0 + 2)])
    assert port.windows_processed == 3


def test_warmup_launches_every_pipeline_depth(engines):
    """With the router, warmup adds one stacked drain per
    PIPELINE_K_BUCKETS depth, and leaves both engines alike."""
    ref, port = engines()
    before = dict(dk.plain_calls)
    port.warmup(now=T0)
    ref.warmup(now=T0)
    got = dk.plain_calls["drain_compact"] - before["drain_compact"]
    assert got == len(port._lane_bucket_list) + len(PIPELINE_K_BUCKETS)
    _assert_same_state(ref, port, T0, "warmup")
    _drive(ref, port, _stream(np.random.default_rng(6), 2))


def _python_twin(port):
    return RateLimitEngine(
        capacity_per_shard=port.capacity_per_shard,
        batch_per_shard=port.batch_per_shard, num_shards=port.num_shards,
        global_capacity=port.global_capacity,
        global_batch_per_shard=port.global_batch_per_shard,
        max_global_updates=port.max_global_updates, device="cpu")


@pytest.mark.parametrize("seed", [3, 4])
def test_router_path_answers_as_the_python_tables(seed):
    """Responses only: the router and the tables assign slots differently.
    Capacity stays above the live keys so no eviction order differs, and
    the stream has no GLOBAL request: a GLOBAL read sees the hits of
    earlier windows only, and the two paths cut a long call into windows
    at different places (the router by lanes, the tables by
    max_window_prefix)."""
    port = RateLimitEngine(capacity_per_shard=128, batch_per_shard=16,
                           num_shards=S, global_capacity=32,
                           global_batch_per_shard=8, max_global_updates=8,
                           device="cpu", use_native="on")
    tables = _python_twin(port)
    assert tables.native is None
    for w, (reqs, now) in enumerate(_stream(
            np.random.default_rng(seed), 6, algos=(0, 1, 2, 3, 4))):
        assert _tuples(port.process(reqs, now=now)) == _tuples(
            tables.process(reqs, now=now)), w
