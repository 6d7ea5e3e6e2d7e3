"""The port's engine under GUBER_PALLAS=1 (the per-op lowering), on the
CPU, against the JAX package's engine under GUBER_PALLAS=1 and against the
port's default engine.

GUBER_PALLAS=1 is set with monkeypatch before the engines are built, as
tests/test_pallas.py sets it: the port reads it once at construction, the
JAX engine when its executables build.  The JAX engine runs on its own
two-CPU-device mesh (devices 6 and 7, as tests/test_pallas.py gives its
Pallas engines their own meshes), with the Python slot tables and GLOBAL
served; there its compact windows run window_step_pallas(compact32=True)
and its full-format windows window_step_pallas (int64), both in interpret
mode, its GLOBAL window global_read then global_apply_pallas, and its
composed drain's analytics the XLA shard_stats.  The port runs
RateLimitEngine(num_shards=2, device="cpu"), whose per-op kernels take
their plain versions.  As in tests/test_torch_engine_global.py the fixture
turns shard_map's replication check off and empties the JAX engine's
compiled-executable caches before and after.  The traffic keeps the
compact32 kernel exact: a monotonic clock, configs inside the caps except
on the full-format window.

Compared exactly after every call: every response field (valid lanes),
every word and limit, the mismatch flags, the GLOBAL read block, every
arena plane, the sketch and the stats vectors; the default engine must
agree with the per-op engine on everything, pad lanes included, and the
kernel counters show which lowering each took.
"""

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)
import jax

from gubernator_tpu import compat
from gubernator_tpu.config import AnalyticsConfig as JAnalyticsConfig
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.ops import kernel as jk
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch.config import AnalyticsConfig
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.ops import drain_kernel as dk
from gubernator_tpu_torch.ops import global_kernel as gk
from gubernator_tpu_torch.ops import stats_kernel as sk
from gubernator_tpu_torch.ops import window_math_kernel as wm

from .test_mesh_fused_drain import _random_stack
from .test_torch_engine_global import (
    _assert_same_state,
    _g,
    _jreqs,
    _req,
    _tuples,
)

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000
S = 2
K, B, C, G, Bg, Kg = 3, 16, 64, 16, 4, 8
GEOMETRY = dict(topk=8, sketch_width=64, sketch_depth=4, tenant_slots=8,
                over_weight=4)


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


def _counts():
    return ({**dk.launches, **gk.launches, **sk.launches, **wm.launches},
            {**dk.plain_calls, **gk.plain_calls, **sk.plain_calls,
             **wm.plain_calls})


def _reset():
    for m in (dk, gk, sk, wm):
        m.reset_counts()


@pytest.fixture
def engines(monkeypatch):
    """() -> (jax_engine, per_op_port_engine, default_port_engine), all at
    one geometry; GUBER_PALLAS=1 stays set for the test."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()
    geo = dict(capacity_per_shard=C, batch_per_shard=B, global_capacity=G,
               global_batch_per_shard=Bg, max_global_updates=Kg)

    def make():
        monkeypatch.delenv("GUBER_PALLAS", raising=False)
        default = RateLimitEngine(num_shards=S, device="cpu", **geo)
        monkeypatch.setenv("GUBER_PALLAS", "1")
        ref = jengine.RateLimitEngine(
            mesh=make_mesh(jax.devices("cpu")[6:8]), use_native=False,
            skip_global=False, **geo)
        port = RateLimitEngine(num_shards=S, device="cpu", **geo)
        assert ref.num_shards == S and port.per_op and not default.per_op
        return ref, port, default
    yield make
    _clear_jax_executable_caches()


def _same_engines(a, b, tag):
    ea, eb = a.export_arena(), b.export_arena()
    for name in ea:
        np.testing.assert_array_equal(ea[name], eb[name],
                                      err_msg=f"{tag} {name}")
    assert a.windows_processed == b.windows_processed, tag
    assert a._compact_sound == b._compact_sound, tag


def _stream(rng, n_windows):
    """Windows of requests: regular keys of all five algorithms over the
    shards, GLOBAL token and leaky keys, duplicates, reads, over-limit
    hits and expiries, a monotonic clock."""
    keys = [f"r{i}" for i in range(20)]
    gkeys = [f"g{i}" for i in range(5)]
    cfg = {k: (int(rng.integers(0, 5)) if k in keys else int(rng.integers(0, 2)),
               int(rng.integers(1, 12)), int(rng.choice([40, 2_000, 60_000])))
           for k in keys + gkeys}
    now, windows = T0, []
    for _ in range(n_windows):
        now += int(rng.choice([3, 50, 900, 30_000]))
        reqs = []
        for _ in range(int(rng.integers(10, 30))):
            glob = rng.random() < 0.3
            k = str(rng.choice(gkeys if glob else keys))
            a, lim, dur = cfg[k]
            h = (int(rng.integers(-3, 4)) if a == 4
                 else int(rng.integers(0, lim + 2)))
            reqs.append(_req(k, h, lim, dur, a, glob=glob))
        windows.append((reqs, now))
    return windows


def _control(rng, eng):
    """GLOBAL lanes on a few slots over both shards, with config writes and
    reallocation resets for them."""
    gb, ga, upd = eng.empty_drain_control()
    slots = rng.integers(0, G, 4)
    for s in range(S):
        for lane in range(int(rng.integers(1, Bg + 1))):
            k = int(rng.integers(0, 4))
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


def test_process_matches_jax_per_op_engine(engines):
    """Six windows of mixed regular and GLOBAL traffic, then a window past
    the compact caps (the full-format lowering, which latches compact off):
    every response and every arena of the per-op port equals the JAX
    engine's under GUBER_PALLAS=1, and the default port engine answers and
    commits alike."""
    ref, port, default = engines()
    windows = _stream(np.random.default_rng(71), 6)
    windows.append(([_req("huge", 2**30, 2**40, 2**35), _req("r1", 1, 5),
                     _g("g1", 1, 5)], windows[-1][1] + 10))
    for w, (reqs, now) in enumerate(windows):
        want = ref.process(_jreqs(reqs), now=now)
        _reset()
        steps = port.windows_processed
        got = port.process(reqs, now=now)
        steps = port.windows_processed - steps
        launches, plain = _counts()
        assert _tuples(got) == _tuples(want), f"window {w}"
        _assert_same_state(ref, port, f"window {w}")
        # one window_math per shard and step, one global_stage and one
        # global_apply at most
        assert not any(launches.values())
        assert plain["window_math"] == S * steps
        assert plain["global_apply"] == plain["global_stage"] <= steps
        assert plain["drain_compact"] == plain["window_full"] == 0
        assert plain["global_window"] == 0
        assert _tuples(default.process(reqs, now=now)) == _tuples(got)
        _same_engines(default, port, f"window {w}")
    assert not port._compact_sound


def test_pipeline_dispatch_matches_jax_per_op_drain(engines):
    """Two K = 3 drains over both shards (duplicates, folds, inits, pads,
    AGG lanes; shard 1 idle in the second): every valid word and limit,
    the mismatch flags and the arena equal the JAX per-op drain's; the
    default port engine gives the same words, limits (pads 0 on both) and
    flags."""
    ref, port, default = engines()
    rng = np.random.default_rng(72)
    for d in range(2):
        stack = _random_stack(rng, K, S, B, C,
                              empty_shards=(1,) if d else ())
        nows = np.asarray([T0 + 10_000 * d + 100 * k for k in range(K)],
                          np.int64)
        jw, jl, jm = [np.asarray(a) for a in ref.pipeline_dispatch(stack,
                                                                   nows)]
        _reset()
        tw, tl, tm = [t.numpy() for t in port.pipeline_dispatch(stack, nows)]
        assert _counts()[1]["window_math"] == K * S
        assert _counts()[1]["drain_compact"] == 0
        valid = (stack[..., 0] & 0xFFFFFFFF) != 0
        np.testing.assert_array_equal(tw[valid], jw[valid], f"d{d} words")
        np.testing.assert_array_equal(tl[valid], jl[valid], f"d{d} limits")
        np.testing.assert_array_equal(tm, jm, f"d{d} mism")
        assert not tw[~valid].any() and not tl[~valid].any()
        _assert_same_state(ref, port, f"drain {d}")
        for a, b in zip(default.pipeline_dispatch(stack, nows), (tw, tl, tm)):
            np.testing.assert_array_equal(a.numpy(), b, f"d{d} default")
        _same_engines(default, port, f"drain {d}")


@pytest.mark.parametrize("analytics", [False, True],
                         ids=["plain_drain", "analytics"])
def test_pipeline_dispatch_global_matches_jax_per_op(engines, analytics):
    """Three composed drains (GLOBAL lanes, config writes and resets; the
    last inert), with analytics from one non-zero sketch and decay on the
    second drain, or without: every valid word and limit, the flags, the
    GLOBAL read block (pads 0), every arena plane, the sketch and the
    stats equal the JAX engine's under GUBER_PALLAS=1 (its XLA
    shard_stats); the default port engine (the drain kernels' plain
    versions) agrees on all of it."""
    ref, port, default = engines()
    rng = np.random.default_rng(73 + analytics)
    if analytics:
        ref.enable_analytics(JAnalyticsConfig(enabled=True, **GEOMETRY))
        sketch = rng.integers(0, 200, (S, GEOMETRY["sketch_depth"],
                                       GEOMETRY["sketch_width"]))
        ref._an_sketch = ref._put_sharded(sketch.astype(np.int64), np.int64)
        for e in (port, default):
            e.enable_analytics(AnalyticsConfig(enabled=True, **GEOMETRY))
            e.import_analytics(sketch)
        # the per-op lowering reduces in torch ops: no stats accumulator
        assert port._an_acc is None and default._an_acc is not None
    for d in range(3):
        stack = _random_stack(rng, K, S, B, C)
        nows = np.asarray([T0 + 10_000 * d + 100 * k for k in range(K)],
                          np.int64)
        gb, ga, upd = (_control(rng, port) if d < 2
                       else port.empty_drain_control())
        extra = {}
        if analytics:
            tenants = rng.integers(-1, GEOMETRY["tenant_slots"] + 2,
                                   (K, S, B)).astype(np.int32)
            extra = dict(analytics_args=(tenants, int(d == 1)))
        want = [np.asarray(a) for a in ref.pipeline_dispatch_global(
            stack, nows, jk.WindowBatch(*gb), ga, upd, **extra)]
        _reset()
        got = [t.numpy() for t in port.pipeline_dispatch_global(
            stack, nows, gb, ga, upd, **extra)]
        launches, plain = _counts()
        assert not any(launches.values())
        assert plain["global_apply"] == (1 if d < 2 else 0)
        assert plain["global_stage"] == plain["global_apply"]
        assert plain["global_window"] == plain["drain_compact"] == 0
        assert plain["drain_compact_stats"] == plain["stats_finish"] == 0
        valid = (stack[..., 0] & 0xFFFFFFFF) != 0
        gvalid = gb.slot >= 0
        tag = f"drain {d}"
        np.testing.assert_array_equal(got[0][valid], want[0][valid],
                                      f"{tag} words")
        np.testing.assert_array_equal(got[1][valid], want[1][valid],
                                      f"{tag} limits")
        np.testing.assert_array_equal(got[2], want[2], f"{tag} mism")
        np.testing.assert_array_equal(got[3][gvalid], want[3][gvalid],
                                      f"{tag} gfused")
        assert not got[3][~gvalid].any()
        _assert_same_state(ref, port, tag)
        if analytics:
            np.testing.assert_array_equal(got[4], want[4], f"{tag} stats")
            np.testing.assert_array_equal(port.export_analytics(),
                                          np.asarray(ref._an_sketch),
                                          f"{tag} sketch")
        dflt = [t.numpy() for t in default.pipeline_dispatch_global(
            stack, nows, gb, ga, upd, **extra)]
        for i, (a, b) in enumerate(zip(dflt, got)):
            np.testing.assert_array_equal(a, b, f"{tag} default output {i}")
        _same_engines(default, port, tag)
        if analytics:
            np.testing.assert_array_equal(default.export_analytics(),
                                          port.export_analytics())


def test_per_op_engine_matches_default_engine(engines):
    """The two lowerings of the port on one stream (process windows with
    GLOBAL keys, a drain, a composed drain with analytics): identical
    responses, outputs, arenas and sketches; the default engine ran only
    the drain, global_window and stats kernels' plain versions, the
    per-op engine only window_math's, global_stage's and global_apply's."""
    _, port, default = engines()
    rng = np.random.default_rng(74)
    for e in (port, default):
        e.enable_analytics(AnalyticsConfig(enabled=True, **GEOMETRY))
    stack = _random_stack(rng, K, S, B, C)
    nows = np.asarray([T0 + 50_000 + k for k in range(K)], np.int64)
    tenants = rng.integers(0, 8, (K, S, B)).astype(np.int32)
    ctl = _control(rng, port)
    seen = {}
    for name, e in (("per_op", port), ("default", default)):
        _reset()
        out = [_tuples(e.process(reqs, now=now))
               for reqs, now in _stream(np.random.default_rng(75), 4)]
        out.append([t.numpy() for t in e.pipeline_dispatch(stack, nows)])
        out.append([t.numpy() for t in e.pipeline_dispatch_global(
            stack, nows + 5, *ctl, analytics_args=(tenants, 1))])
        seen[name] = (out, _counts(), e.export_arena(), e.export_analytics())
    (po, (pl, pp), pa, ps), (do, (dl, dp), da, ds) = (seen["per_op"],
                                                      seen["default"])
    for w in range(4):
        assert po[w] == do[w], f"window {w}"
    for a, b in zip(po[4] + po[5], do[4] + do[5]):
        np.testing.assert_array_equal(a, b)
    for name in pa:
        np.testing.assert_array_equal(pa[name], da[name], err_msg=name)
    np.testing.assert_array_equal(ps, ds)
    assert not any(pl.values()) and not any(dl.values())
    assert {k for k, v in pp.items() if v} == {"window_math", "global_stage",
                                               "global_apply"}
    assert {k for k, v in dp.items() if v} == {
        "drain_compact", "global_window", "drain_compact_stats",
        "stats_finish"}


def test_per_op_warmup_leaves_the_arenas(engines):
    """warmup goes through the per-op lowering (window_math, global_stage
    and global_apply's plain versions here, no drain kernel) and leaves the
    arenas and the sketch as they were."""
    _, port, _ = engines()
    port.enable_analytics(AnalyticsConfig(enabled=True, **GEOMETRY))
    _reset()
    port.warmup(now=T0)
    launches, plain = _counts()
    assert {k for k, v in plain.items() if v} == {"window_math",
                                                  "global_stage",
                                                  "global_apply"}
    assert not any(launches.values())
    assert all(not a.any() for a in port.export_arena().values())
    assert not port.export_analytics().any()


@pytest.mark.parametrize("value,want", [("1", True), ("true", True),
                                        ("0", False), ("", False)])
def test_guber_pallas_is_read_once_at_construction(monkeypatch, value, want):
    monkeypatch.setenv("GUBER_PALLAS", value)
    eng = RateLimitEngine(capacity_per_shard=8, batch_per_shard=8,
                          device="cpu")
    monkeypatch.setenv("GUBER_PALLAS", "0" if want else "1")
    assert eng.per_op is want
    _reset()
    eng.process([_req("k")], now=T0)
    plain = _counts()[1]
    assert (plain["window_math"] == 1) is want
    assert (plain["drain_compact"] == 1) is not want
