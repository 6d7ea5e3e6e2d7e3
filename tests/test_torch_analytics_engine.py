"""The port's engine with traffic analytics, on the CPU, against the JAX
package's engine on the 8-CPU-device mesh.

Both engines run at the same geometry with analytics enabled at the same
(small) sketch and table sizes, start from the same non-zero sketch
(`import_analytics` on the port; the JAX engine's resident sketch put on
its mesh), and take the same composed drains:
`pipeline_dispatch_global(..., analytics_args=(tenants, decay))` with
decay set on one drain, then `analytics_dispatch` on the last drain's
arrays.  The fixture is tests/test_torch_engine_global.py's (shard_map's
replication check off, the JAX engine's executable caches emptied).

Two JAX arms:

  * the XLA arm (GUBER_PALLAS_FUSED unset): the drain's XLA scan and
    analytics.shard_stats, compared on all traffic, CONCURRENCY releases
    included;
  * the staged arm (GUBER_PALLAS_FUSED=1): the TPU kernels in interpret
    mode (the K-grid drain kernel folding the stats, global_combined_staged,
    staged_stats_finish), compared on tests/test_mesh_fused_drain.py's
    `_random_stack` traffic, which has no release lanes (with releases the
    TPU kernels count hits negative, ROADMAP Queue 3).

Compared exactly: every valid word and limit, the mismatch flags, the
GLOBAL responses on valid lanes, every arena plane, the sketch and every
stats vector.
"""

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)

from gubernator_tpu.config import AnalyticsConfig as JAnalyticsConfig
from gubernator_tpu.ops import kernel as jk
from gubernator_tpu_torch.config import AnalyticsConfig
from gubernator_tpu_torch.ops import drain_kernel as dk
from gubernator_tpu_torch.ops import stats_kernel as sk

from .test_mesh_fused_drain import _random_stack
from .test_torch_engine_global import (  # noqa: F401  (fixture)
    FB,
    FBg,
    FC,
    FG,
    K,
    S,
    T0,
    _assert_same_state,
    _random_control,
    engines,
)

pytestmark = pytest.mark.torch_port

GEOMETRY = dict(topk=8, sketch_width=64, sketch_depth=4, tenant_slots=8,
                over_weight=4)


def _enable(ref, port, rng):
    """Analytics on both engines at GEOMETRY, from one non-zero sketch."""
    jc = JAnalyticsConfig(enabled=True, **GEOMETRY)
    ref.enable_analytics(jc)
    port.enable_analytics(AnalyticsConfig(enabled=True, **GEOMETRY))
    sketch = rng.integers(0, 200, (S, GEOMETRY["sketch_depth"],
                                   GEOMETRY["sketch_width"])).astype(np.int64)
    ref._an_sketch = ref._put_sharded(sketch, np.int64)
    port.import_analytics(sketch)
    np.testing.assert_array_equal(port.export_analytics(), sketch)


def _with_releases(rng, stack):
    """_random_stack traffic with a third of the lanes moved to the other
    algorithms: CONCURRENCY acquires and releases (negative hits), GCRA,
    sliding window."""
    out = stack.copy()
    for k in range(stack.shape[0]):
        for s in range(stack.shape[1]):
            bt = [np.asarray(a).copy()
                  for a in jk.decode_batch(np.asarray(stack[k, s]))]
            slot, hits, limit, duration, algo, init = bt
            move = rng.random(slot.shape[0]) < 0.35
            algo[move] = rng.integers(2, 5, int(move.sum()))
            conc = move & (algo == jk.CONCURRENCY)
            hits[conc] = rng.choice([-3, -1, 1, 2], int(conc.sum()))
            limit[move & (algo == jk.SLIDING_WINDOW)] %= 1000
            out[k, s] = np.asarray(jk.encode_batch_host(
                slot, hits, limit, duration, algo, init))
    return out


def _drive(monkeypatch, ref, port, rng, fused, releases, rounds=3):
    """`rounds` composed drains with analytics (decay on the second), then
    analytics_dispatch on the last drain's arrays, compared after each."""
    if fused:
        monkeypatch.setenv("GUBER_PALLAS_FUSED", "1")
    else:
        monkeypatch.delenv("GUBER_PALLAS_FUSED", raising=False)
    T = GEOMETRY["tenant_slots"]
    for rnd in range(rounds):
        stack = _random_stack(rng, K, S, FB, FC, empty_shards=(3,))
        if releases:
            stack = _with_releases(rng, stack)
        tenants = rng.integers(-1, T + 2, (K, S, FB)).astype(np.int32)
        decay = int(rnd == 1)
        nows = np.asarray([T0 + rnd * 1_000_000 + 500 * k for k in range(K)],
                          np.int64)
        gb, ga, upd = (_random_control(rng, port) if rnd < 2
                       else port.empty_drain_control())
        jw, jl, jm, jg, js = [np.asarray(a) for a in ref.pipeline_dispatch_global(
            stack, nows, jk.WindowBatch(*gb), ga, upd,
            analytics_args=(tenants, decay))]
        tw, tl, tm, tg, ts = [t.numpy() for t in port.pipeline_dispatch_global(
            stack, nows, gb, ga, upd, analytics_args=(tenants, decay))]
        tag = f"{'staged' if fused else 'xla'} drain {rnd}"
        valid = (stack[..., 0] & 0xFFFFFFFF) != 0
        np.testing.assert_array_equal(tw[valid], jw[valid], f"{tag} words")
        np.testing.assert_array_equal(tl[valid], jl[valid], f"{tag} limits")
        np.testing.assert_array_equal(tm, jm, f"{tag} mism")
        gvalid = gb.slot >= 0
        np.testing.assert_array_equal(tg[gvalid], jg[gvalid], f"{tag} gfused")
        _assert_same_state(ref, port, tag)
        np.testing.assert_array_equal(port.export_analytics(),
                                      np.asarray(ref._an_sketch),
                                      f"{tag} sketch")
        np.testing.assert_array_equal(ts, js, f"{tag} stats")
        assert ts.shape == (S, 8 + 3 * T + 4 * GEOMETRY["topk"])
    # the standalone reduction over the last drain's arrays
    now = int(nows[0])
    js = np.asarray(ref.analytics_dispatch(stack, jw, tenants, now, 1))
    ts = port.analytics_dispatch(stack, tw, tenants, now, 1).numpy()
    np.testing.assert_array_equal(ts, js, "analytics_dispatch stats")
    np.testing.assert_array_equal(port.export_analytics(),
                                  np.asarray(ref._an_sketch),
                                  "analytics_dispatch sketch")


def test_composed_drain_with_analytics_matches_jax_xla_arm(engines,
                                                           monkeypatch):
    ref, port = engines(C=FC, B=FB, G=FG, Bg=FBg)
    rng = np.random.default_rng(301)
    _enable(ref, port, rng)
    _drive(monkeypatch, ref, port, rng, fused=False, releases=True)


def test_composed_drain_with_analytics_matches_jax_staged_arm(engines,
                                                              monkeypatch):
    ref, port = engines(C=FC, B=FB, G=FG, Bg=FBg)
    rng = np.random.default_rng(302)
    _enable(ref, port, rng)
    _drive(monkeypatch, ref, port, rng, fused=True, releases=False, rounds=2)


def test_composed_drain_without_analytics_args_is_unchanged(engines):
    """With analytics enabled, a composed drain without analytics_args is
    the drain without analytics: the same four outputs as an engine that
    never enabled it, the plain drain only, the sketch untouched."""
    _, port = engines(C=FC, B=FB, G=FG, Bg=FBg)
    _, bare = engines(C=FC, B=FB, G=FG, Bg=FBg)
    port.enable_analytics(AnalyticsConfig(enabled=True, **GEOMETRY))
    rng = np.random.default_rng(303)
    stack = _random_stack(rng, K, S, FB, FC)
    nows = np.asarray([T0 + k for k in range(K)], np.int64)
    gb, ga, upd = _random_control(rng, port)
    dk.reset_counts()
    sk.reset_counts()
    got = port.pipeline_dispatch_global(stack, nows, gb, ga, upd)
    assert len(got) == 4
    assert dk.plain_calls == {"drain_compact": 1, "drain_compact_stats": 0,
                              "window_full": 0}
    assert sk.plain_calls == {"stats_finish": 0}
    want = bare.pipeline_dispatch_global(stack, nows, gb, ga, upd)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not port.export_analytics().any()
    assert port._an_acc.pending == 0


def test_warmup_launches_the_analytics_drain_once(engines):
    """warmup with analytics enabled also runs the composed drain with
    analytics once (the plain versions, on the CPU), leaving the arenas,
    the sketch and the accumulator as they were."""
    _, port = engines(C=FC, B=FB, G=FG, Bg=FBg)
    port.enable_analytics(AnalyticsConfig(enabled=True, **GEOMETRY))
    dk.reset_counts()
    sk.reset_counts()
    port.warmup(now=T0)
    assert dk.plain_calls["drain_compact_stats"] == 1
    assert sk.plain_calls == {"stats_finish": 1}
    assert all(not a.any() for a in port.export_arena().values())
    assert not port.export_analytics().any()
    acc = port._an_acc
    assert acc.pending == 0 and not acc.count.any() and not acc.index.any()
    with pytest.raises(ValueError, match="sketch"):
        port.import_analytics(np.zeros((S, 1, 1), np.int64))


def test_analytics_calls_need_enable_analytics(engines):
    _, port = engines(C=FC, B=FB, G=FG, Bg=FBg)
    stack = np.zeros((1, S, FB, 2), np.int64)
    nows = np.full(1, T0, np.int64)
    tenants = np.zeros((1, S, FB), np.int32)
    with pytest.raises(RuntimeError, match="not enabled"):
        port.pipeline_dispatch_global(stack, nows,
                                      *port.empty_drain_control(),
                                      analytics_args=(tenants, 0))
    with pytest.raises(RuntimeError, match="not enabled"):
        port.analytics_dispatch(stack, np.zeros((1, S, FB), np.int64),
                                tenants, T0, 0)
    with pytest.raises(RuntimeError, match="not enabled"):
        port.export_analytics()
