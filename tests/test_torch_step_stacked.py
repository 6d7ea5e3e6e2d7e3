"""The port's step_stacked (K windows at one `now`, the lockstep tick's
stacked step) against the JAX engine's `step_stacked` on the same windows,
the mirror of tests/test_step_stacked.py.

Both engines run all eight shards on the CPU: the JAX engine on
make_mesh() (shard_map's replication check off, as in
tests/test_torch_engine_global.py), the port's with num_shards=8 on the
plain versions of its kernels; with the Python slot tables or both with
their native routers (the same C++ router, so the same slots).  Held equal
bit for bit: every response of every window and, after each stack, every
regular plane, the GLOBAL replica and its config.  Cases: random windows
with GLOBAL lanes (each window's GLOBAL window reads what the previous one
applied, the stack's config writes merged before window 0, as in the JAX
engine), a stack padded to k_stack, a key first seen in the middle of the
stack, and skip_global (no GLOBAL window runs; a GLOBAL lane raises in
both).
"""

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)

from gubernator_tpu import compat
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch import native
from gubernator_tpu_torch.api.types import Algorithm, Behavior, RateLimitReq
from gubernator_tpu_torch.core.engine import RateLimitEngine

pytestmark = pytest.mark.torch_port

T0 = 1_700_000_000_000
S = 8
GEOM = dict(capacity_per_shard=64, batch_per_shard=16, global_capacity=32,
            global_batch_per_shard=8, max_global_updates=8)
FIELDS = ("limit", "duration", "remaining", "tstamp", "expire", "algo")
NATIVE = [False, pytest.param("on", marks=pytest.mark.skipif(
    not native.available(), reason="native router unavailable"))]


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture
def engines(monkeypatch):
    """make(use_native, **kw) -> (jax engine, port engine)."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()

    def make(use_native=False, **kw):
        ref = jengine.RateLimitEngine(mesh=make_mesh(), use_native=use_native,
                                      **GEOM, **kw)
        port = RateLimitEngine(num_shards=S, device="cpu",
                               use_native=use_native, **GEOM, **kw)
        return ref, port
    yield make
    _clear_jax_executable_caches()


def random_windows(rng, k=4, per_window=24):
    """tests/test_step_stacked.py's windows: 15% GLOBAL lanes on four
    keys, the rest token and leaky over 30 keys."""
    wins = []
    for _ in range(k):
        reqs = []
        for _ in range(per_window):
            if rng.random() < 0.15:
                reqs.append(RateLimitReq(
                    name="ssg", unique_key=f"g{rng.integers(0, 4)}",
                    hits=int(rng.integers(0, 3)), limit=50,
                    duration=60_000, behavior=Behavior.GLOBAL))
            else:
                reqs.append(RateLimitReq(
                    name="ss", unique_key=f"k{rng.integers(0, 30)}",
                    hits=int(rng.integers(0, 3)), limit=10,
                    duration=60_000,
                    algorithm=int(rng.integers(0, 2))))
        wins.append(reqs)
    return wins


def _j(reqs):
    return [JReq(name=r.name, unique_key=r.unique_key, hits=r.hits,
                 limit=r.limit, duration=r.duration, algorithm=r.algorithm,
                 behavior=r.behavior) for r in reqs]


def _same(got, want):
    assert len(got) == len(want)
    for k, (gw, ww) in enumerate(zip(got, want)):
        assert len(gw) == len(ww)
        for j, (g, r) in enumerate(zip(gw, ww)):
            assert (g.status, g.limit, g.remaining, g.reset_time) == \
                (int(r.status), r.limit, r.remaining, r.reset_time), (k, j)


def _same_arenas(ref, port):
    got = port.export_arena()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref.state,
                                                                 f)), f)
        np.testing.assert_array_equal(got[f"gstate.{f}"],
                                      np.asarray(getattr(ref.gstate, f)), f)
    for f in ("limit", "duration", "algo"):
        np.testing.assert_array_equal(got[f"gcfg.{f}"],
                                      np.asarray(getattr(ref.gcfg, f)), f)


@pytest.mark.parametrize("use_native", NATIVE)
@pytest.mark.parametrize("seed", [0, 1])
def test_stacked_windows_equal_the_jax_engine(engines, use_native, seed):
    rng = np.random.default_rng(seed)
    ref, port = engines(use_native)
    for stack in range(2):
        wins = random_windows(rng)
        now = T0 + 1000 * stack
        _same(port.step_stacked(wins, now=now),
              ref.step_stacked([_j(w) for w in wins], now=now))
        _same_arenas(ref, port)
    assert port.windows_processed == ref.windows_processed == 8


@pytest.mark.parametrize("use_native", NATIVE)
def test_stack_padded_to_k_stack_and_a_key_first_seen_mid_stack(
        engines, use_native):
    """k_stack pads the stack with empty windows (the tick's fixed shape);
    a key allocated in window 1 is initialized once across the stack, so
    window 2 decrements it (tests/test_step_stacked.py)."""
    ref, port = engines(use_native)
    req = RateLimitReq(name="mid", unique_key="x", hits=1, limit=5,
                       duration=60_000)
    g = RateLimitReq(name="mg", unique_key="h", hits=1, limit=20,
                     duration=60_000, behavior=Behavior.GLOBAL,
                     algorithm=Algorithm.LEAKY_BUCKET)
    wins = [[], [req, g], [req, g]]
    got = port.step_stacked(wins, now=T0, k_stack=4)
    _same(got, ref.step_stacked([_j(w) for w in wins], now=T0, k_stack=4))
    assert [r.remaining for w in got for r in w][0::2] == [4, 3]
    assert port.windows_processed == ref.windows_processed == 4
    _same_arenas(ref, port)


def test_skip_global_runs_no_global_window_and_refuses_a_lane(engines):
    """skip_global: the stack's GLOBAL windows do not run (none is
    launched, the scratch is never touched) and answers equal the JAX
    engine's; a GLOBAL lane under the promise raises in both."""
    from gubernator_tpu_torch.ops import global_kernel as gk
    ref, port = engines(False, skip_global=True)
    rng = np.random.default_rng(11)
    wins = [[RateLimitReq(name="sgc", unique_key=f"k{rng.integers(0, 20)}",
                          hits=int(rng.integers(0, 3)), limit=10,
                          duration=60_000,
                          algorithm=int(rng.integers(0, 2)))
             for _ in range(16)] for _ in range(3)]
    gk.reset_counts()
    _same(port.step_stacked(wins, now=T0),
          ref.step_stacked([_j(w) for w in wins], now=T0))
    assert not any(gk.plain_calls.values()) and not any(
        gk.launches.values())
    _same_arenas(ref, port)
    greq = [RateLimitReq(name="sgv", unique_key="h", hits=1, limit=20,
                         duration=60_000, behavior=Behavior.GLOBAL)]
    with pytest.raises(ValueError, match="skip_global"):
        port.step_stacked([greq], now=T0 + 1)
    with pytest.raises(ValueError, match="skip_global"):
        ref.step_stacked([_j(greq)], now=T0 + 1)
