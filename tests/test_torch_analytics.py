"""The port's traffic analytics (gubernator_tpu_torch/ops/analytics.py, the
stats drain of ops/drain_kernel.py, the finisher of ops/stats_kernel.py,
observability/analytics.py) on CPU tensors against the JAX package.

On the CPU the two wrappers run their kernels' plain versions; the CUDA
kernels are held against those same plain versions on the card by
chip_smoke.py phase 6, and their device code against the oracle here by
tests/test_torch_drain_host.py.  References, on the same numpy-seeded
inputs:

  * `oracle_stats` (numpy), `shard_stats` (XLA), `hash_slots` and
    `staged_stats_tail` of gubernator_tpu/ops/analytics.py;
  * the TPU kernels in interpret mode: `window_drain_fused_planes(...,
    tenants=...)` for the in-drain sums (its i32 lo/hi planes reassembled
    to int64) and `staged_stats_finish` for the finisher - on traffic
    without CONCURRENCY release lanes, where the TPU kernels count hits
    as the oracle does (with releases they count them negative; the
    port follows the oracle, and
    test_release_lanes_part_jax_kernels_from_the_oracle pins the
    difference);
  * `TrafficAnalytics` / `SLOEngine` of gubernator_tpu/observability.

Every comparison is exact: every value is an integer.
"""

import numpy as np
import pytest
import torch

import gubernator_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp

from gubernator_tpu.config import AnalyticsConfig as JAnalyticsConfig
from gubernator_tpu.config import SLOConfig as JSLOConfig
from gubernator_tpu.observability import analytics as jobs
from gubernator_tpu.ops import analytics as ja
from gubernator_tpu.ops import kernel as jk
from gubernator_tpu.ops import pallas_kernel as pk
from gubernator_tpu_torch.config import AnalyticsConfig, SLOConfig
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.observability import analytics as tobs
from gubernator_tpu_torch.ops import analytics as ta
from gubernator_tpu_torch.ops import drain_kernel as dk
from gubernator_tpu_torch.ops import kernel as tk
from gubernator_tpu_torch.ops import stats_kernel as sk

from .test_fused_megakernel import _random_state
from .test_mesh_fused_drain import _random_stack

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000
NOW = T0


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair64(lo, hi):
    """An int64 plane from the TPU kernel's i32 (lo, hi) pair planes."""
    lo = np.asarray(lo).astype(np.int64) & 0xFFFFFFFF
    return (np.asarray(hi).astype(np.int64) << 32) | lo


def _wire_round(rng, C, B, K, T, release=True, big_hits=True):
    """One drain's wire arrays (tests/test_analytics.py _synthetic_round's
    kinds, plus the edges): request words with pads, AGG-tagged slots,
    inits, CONCURRENCY release lanes (negative hits in the 28-bit field),
    hits near 2^28 - 1, slots past the arena and past 2^31 (rows clipped
    to C - 1), the lone AGG bit (a pad for the oracle); response words
    with random fields around the status bit; tenant ids past both ends."""
    packed = np.zeros((K, B, 2), np.int64)
    words = np.zeros((K, B), np.int64)
    tenants = rng.integers(-2, T + 3, size=(K, B)).astype(np.int32)
    for k in range(K):
        n = int(rng.integers(1, B))
        slot = np.full(B, -1, np.int64)
        slot[:n] = rng.integers(0, C, n)
        slot[:n][rng.random(n) < 0.3] = rng.integers(0, 4)
        hits = rng.integers(0, 50, B).astype(np.int64)
        algo = rng.integers(0, 5, B).astype(np.int64)
        if release:
            rel = (algo == jk.CONCURRENCY) & (rng.random(B) < 0.5)
            hits[rel] = -rng.integers(1, 9, int(rel.sum()))
        else:
            algo[algo == jk.CONCURRENCY] = 0
        if big_hits:
            big = rng.random(B) < 0.1
            hits[big] = jk.COMPACT_MAX_HITS - 1 - rng.integers(0, 3,
                                                               int(big.sum()))
        agg = rng.integers(0, 2, B).astype(np.int64)
        is_init = rng.integers(0, 2, B).astype(np.int64)
        w0 = ((slot + 1) | (agg * jk.AGG_SLOT_BIT) | (is_init << 32)
              | ((algo & 1) << 33)
              | ((hits & (jk.COMPACT_MAX_HITS - 1)) << 34)
              | (((algo >> 1) & 3) << 62))
        w0 = np.where(slot < 0, 0, w0)
        if k == 0:
            w0[-1] = C + 5 + 1                      # past the arena
            w0[-2] = (1 << 31) + 7                  # past 2^31
            w0[-3] = jk.AGG_SLOT_BIT                # a pad to the oracle
        packed[k, :, 0] = w0
        packed[k, :, 1] = rng.integers(1, 1 << 20, B)
        words[k] = (rng.integers(0, 1 << 31, B)
                    | (rng.integers(0, 2, B).astype(np.int64) << 31)
                    | (rng.integers(0, 1 << 20, B).astype(np.int64) << 32))
    return packed, words, tenants


def _expire(rng, C):
    return rng.choice([0, NOW - 5_000, NOW, NOW + 60_000],
                      size=C).astype(np.int64)


# ---------------------------------------------------------------------------
# 1. ops/analytics.py against the JAX package's


def test_hash_slots_matches_jax_package():
    slots = np.concatenate([np.arange(4096), [2**30, 2**31 - 1, 2**40]])
    for row in range(ja.MAX_SKETCH_DEPTH + 2):
        for width in (16, 61, 2048):
            want = np.asarray(ja.hash_slots(np, slots, row, width))
            assert np.array_equal(
                ta.hash_slots(torch, _t(slots), row, width).numpy(), want)
            assert np.array_equal(ta.hash_slots(np, slots, row, width), want)
    assert ta._MULTS == ja._MULTS and ta._SLOT_MASK == ja._SLOT_MASK
    assert (ta.HEADER, ta.TENANT_COLS, ta.CAND_COLS, ta.MAX_SKETCH_DEPTH) == (
        ja.HEADER, ja.TENANT_COLS, ja.CAND_COLS, ja.MAX_SKETCH_DEPTH)
    assert [ta.stats_len(T, k) for T, k in ((64, 32), (8, 8))] == [
        ja.stats_len(T, k) for T, k in ((64, 32), (8, 8))] == [328, 64]


@pytest.mark.parametrize("seed", [0, 1])
def test_shard_stats_and_oracle_match_jax_package(seed):
    """Carried-sketch rounds with a decay round and a non-zero start, on
    every wire edge (release lanes included): the port's shard_stats and
    oracle_stats equal the JAX package's shard_stats and oracle_stats."""
    rng = np.random.default_rng(40 + seed)
    C, B, K, T, topk, D, W = 256, 64, 3, 8, 8, 4, 64
    kw = dict(tenant_slots=T, topk=topk, over_weight=4)
    sketch = rng.integers(0, 1000, (D, W)).astype(np.int64)
    s_port, s_jax = _t(sketch.copy()), sketch.copy()
    for rnd, decay in enumerate((0, 1, 0)):
        packed, words, tenants = _wire_round(rng, C, B, K, T)
        expire = _expire(rng, C)
        want_sk, want = ja.oracle_stats(s_jax, packed, words, tenants,
                                        expire, NOW, decay, **kw)
        x_sk, x = ja.shard_stats(jnp.asarray(s_jax), packed, words, tenants,
                                 expire, NOW, decay, **kw)
        assert np.array_equal(np.asarray(x_sk), want_sk)
        assert np.array_equal(np.asarray(x), want)
        o_sk, o = ta.oracle_stats(s_jax, packed, words, tenants, expire,
                                  NOW, decay, **kw)
        assert np.array_equal(o_sk, want_sk) and np.array_equal(o, want)
        s_port, got = ta.shard_stats(s_port, _t(packed), _t(words),
                                     _t(tenants), _t(expire), NOW, decay,
                                     **kw)
        assert np.array_equal(s_port.numpy(), want_sk), f"round {rnd}"
        assert np.array_equal(got.numpy(), want), f"round {rnd}"
        s_jax = want_sk


def _jax_planes(ds):
    """The TPU drain kernel's nine i32 planes from int64 DrainStats."""
    lo = lambda a: (a.numpy() & 0xFFFFFFFF).astype(np.uint32).view(np.int32)  # noqa: E731
    hi = lambda a: (a.numpy() >> 32).astype(np.int32)  # noqa: E731
    hdr = np.zeros(8, np.int32)
    lanes, hits, over, init = ds.hdr.numpy()
    hdr[:5] = (lanes, lo(ds.hdr[1:2])[0], hi(ds.hdr[1:2])[0], over, init)
    return tuple(jnp.asarray(a) for a in (
        ds.d_occ.numpy().astype(np.int32), ds.d_over.numpy().astype(np.int32),
        lo(ds.d_hits), hi(ds.d_hits), ds.t_occ.numpy().astype(np.int32),
        ds.t_over.numpy().astype(np.int32), lo(ds.t_hits), hi(ds.t_hits),
        hdr))


def test_staged_stats_tail_matches_jax_package():
    """staged_stats_tail on one drain's sums (release lanes included):
    the JAX tail takes them as i32 lo/hi planes, the port's as int64."""
    rng = np.random.default_rng(44)
    C, B, K, T, topk, D, W = 128, 32, 2, 4, 8, 3, 32
    kw = dict(tenant_slots=T, topk=topk, over_weight=3)
    sketch = rng.integers(0, 50, (D, W)).astype(np.int64)
    for decay in (0, 1):
        packed, words, tenants = _wire_round(rng, C, B, K, T)
        expire = _expire(rng, C)
        ds = ta.drain_stats(_t(packed), _t(words), _t(tenants), C, T)
        want_sk, want = ja.staged_stats_tail(
            jnp.asarray(sketch), _jax_planes(ds), jnp.asarray(expire),
            jnp.int64(NOW), jnp.int64(decay), **kw)
        got_sk, got = ta.staged_stats_tail(_t(sketch), ds, _t(expire), NOW,
                                           decay, **kw)
        assert np.array_equal(got_sk.numpy(), np.asarray(want_sk))
        assert np.array_equal(got.numpy(), np.asarray(want))
        o_sk, o = ja.oracle_stats(sketch, packed, words, tenants, expire,
                                  NOW, decay, **kw)
        assert np.array_equal(got_sk.numpy(), o_sk)
        assert np.array_equal(got.numpy(), o)


# ---------------------------------------------------------------------------
# 2-3. the stats drain and the finisher (plain versions) against the TPU
# kernels in interpret mode and the oracle


def _arena(st):
    return tk.BucketState(*[_t(np.asarray(a))[None].clone() for a in st])


def _drain_with_stats(st0, packed, nows, tenants, T, acc=None):
    """drain_compact_stats at S = 1 on a fresh accumulator (or `acc`)."""
    C = np.asarray(st0.limit).shape[0]
    arena = _arena(st0)
    acc = acc or sk.StatsAccumulator(1, C, T, "cpu")
    words, limits, mism = dk.drain_compact_stats(
        arena, _t(packed[:, None]), _t(nows), _t(tenants[:, None]), acc)
    return arena, words[:, 0], limits[:, 0], mism[:, 0], acc


def _jax_drain_with_stats(st0, packed, nows, tenants, T):
    new32, words, limits, mism, planes = pk.window_drain_fused_planes(
        pk.fused_state_to_planes(st0), jnp.asarray(packed), jnp.asarray(nows),
        interpret=True, tenants=jnp.asarray(tenants), tenant_slots=T)
    return (pk.fused_state_from_planes(new32), np.asarray(words),
            np.asarray(limits), np.asarray(mism), planes)


def _assert_sums_equal_jax_planes(acc, planes, tag):
    ds = acc.dense()
    d_occ, d_over, d_hlo, d_hhi, t_occ, t_over, t_hlo, t_hhi, hdr = [
        np.asarray(p) for p in planes]
    for name, got, want in (
            ("d_occ", ds.d_occ[0], d_occ), ("d_over", ds.d_over[0], d_over),
            ("d_hits", ds.d_hits[0], _pair64(d_hlo, d_hhi)),
            ("t_occ", ds.t_occ[0], t_occ), ("t_over", ds.t_over[0], t_over),
            ("t_hits", ds.t_hits[0], _pair64(t_hlo, t_hhi))):
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{tag} {name}")
    np.testing.assert_array_equal(
        ds.hdr[0].numpy(),
        [hdr[0], _pair64(hdr[1:2], hdr[2:3])[0], hdr[3], hdr[4]],
        err_msg=f"{tag} header")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_drain_matches_jax_drain_kernel_without_releases(seed):
    """K = 4 drains of _random_stack traffic (token/leaky, duplicates,
    AGG, inits, pads) with tenant ids past both ends: the port's stats
    drain and the TPU drain kernel in interpret mode give the same arena,
    words, limits, flags and per-row / per-tenant / header sums."""
    rng = np.random.default_rng(70 + seed)
    K, B, C, T = 4, 16, 32, 4
    st0 = _random_state(rng, C, T0)
    packed = _random_stack(rng, K, 1, B, C)[:, 0]
    nows = np.asarray([T0 + 1000 * k for k in range(K)], np.int64)
    tenants = rng.integers(-1, T + 2, (K, B)).astype(np.int32)
    arena, words, limits, mism, acc = _drain_with_stats(st0, packed, nows,
                                                        tenants, T)
    want_st, jw, jl, jm, planes = _jax_drain_with_stats(st0, packed, nows,
                                                        tenants, T)
    valid = (packed[..., 0] & 0xFFFFFFFF) != 0
    np.testing.assert_array_equal(words.numpy()[valid], jw[valid])
    np.testing.assert_array_equal(limits.numpy()[valid], jl[valid])
    np.testing.assert_array_equal(mism.numpy(), jm)
    for f, a, b in zip(tk.BucketState._fields, arena, want_st):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b),
                                      err_msg=f"state.{f}")
    _assert_sums_equal_jax_planes(acc, planes, f"seed {seed}")
    assert acc.pending == K * B


def _drain_stack(rng, K, B, C, release):
    """A drain stack for the stats tests: _random_stack's kinds plus, with
    `release`, CONCURRENCY lanes with negative hits, and hits near
    2^28 - 1 on token lanes."""
    stack = _random_stack(rng, K, 1, B, C)[:, 0]
    if release:
        bt = jk.decode_batch(jnp.asarray(stack))
        slot, hits, limit, duration, algo, init = [np.asarray(a).copy()
                                                   for a in bt]
        conc = rng.random((K, B)) < 0.3
        algo[conc] = jk.CONCURRENCY
        hits[conc] = rng.choice([-3, -1, 1, 2], int(conc.sum()))
        big = (rng.random((K, B)) < 0.1) & ~conc
        hits[big] = jk.COMPACT_MAX_HITS - 1
        stack = np.asarray(jk.encode_batch_host(slot, hits, limit, duration,
                                                algo, init))
    return stack


@pytest.mark.parametrize("release", [False, True])
def test_stats_drain_and_finisher_match_oracle(release):
    """Drains carried over a non-zero sketch, with a decay drain, tenant ids
    past both ends, slots past the arena, AGG lanes, hits near 2^28 - 1
    and (with `release`) CONCURRENCY releases: drain_compact_stats then
    stats_finish (plain versions) give the oracle's sketch and stats of
    each drain's own words; the accumulator is empty after each finish."""
    rng = np.random.default_rng(90 + release)
    K, B, C, T, topk, D, W = 3, 32, 48, 6, 8, 4, 32
    kw = dict(tenant_slots=T, topk=topk, over_weight=4)
    arena = _arena(_random_state(rng, C, T0))
    acc = sk.StatsAccumulator(1, C, T, "cpu")
    sketch = _t(rng.integers(0, 30, (1, D, W)).astype(np.int64))
    want_sk = sketch[0].numpy().copy()
    for d, decay in enumerate((0, 1, 0)):
        packed = _drain_stack(rng, K, B, C, release)
        packed[0, 0, 0] = (packed[0, 0, 0] & ~0xFFFFFFFF) | (C + 3)
        tenants = rng.integers(-2, T + 2, (K, B)).astype(np.int32)
        nows = np.asarray([T0 + 7 * d + k for k in range(K)], np.int64)
        words, _, _ = dk.drain_compact_stats(
            arena, _t(packed[:, None]), _t(nows), _t(tenants[:, None]), acc)
        stats = sk.stats_finish(sketch, acc, arena.expire, int(nows[0]),
                                decay, topk=topk, over_weight=4)
        want_sk, want = ja.oracle_stats(
            want_sk, packed, words[:, 0].numpy(), tenants,
            arena.expire[0].numpy(), int(nows[0]), decay, **kw)
        np.testing.assert_array_equal(sketch[0].numpy(), want_sk,
                                      err_msg=f"drain {d} sketch")
        np.testing.assert_array_equal(stats[0].numpy(), want,
                                      err_msg=f"drain {d} stats")
        assert not acc.index.any() and not acc.count.any()
        assert not acc.tenant.any() and not acc.header.any()
        assert acc.pending == 0


def _finisher_cases():
    """(name, K, B, C, T, topk, D, W, decay, sketch kind): ties (a narrow
    sketch under a flat start), fewer touched rows than topk, decay, a
    non-zero start."""
    return [
        ("ties", 2, 16, 32, 4, 8, 2, 16, 0, "flat"),
        ("few_touched", 1, 8, 64, 4, 8, 4, 32, 0, "zero"),
        ("decay_nonzero", 3, 16, 48, 6, 6, 4, 64, 1, "random"),
        ("wide", 4, 32, 256, 8, 8, 4, 64, 1, "random"),
    ]


@pytest.mark.parametrize("case", _finisher_cases(), ids=lambda c: c[0])
def test_finisher_matches_jax_staged_finish_and_oracle(case):
    """The plain finisher on the stats drain's accumulator equals
    staged_stats_finish (interpret mode) on the TPU drain kernel's planes
    of the same drain (no release lanes), and the oracle."""
    name, K, B, C, T, topk, D, W, decay, kind = case
    rng = np.random.default_rng(sum(map(ord, name)))
    kw = dict(tenant_slots=T, topk=topk, over_weight=4)
    st0 = _random_state(rng, C, T0)
    packed = _drain_stack(rng, K, B, C, release=False)
    if name == "few_touched":
        keep = np.zeros((K, B), bool)
        keep[0, :3] = True
        packed[~keep] = 0
    tenants = rng.integers(0, T, (K, B)).astype(np.int32)
    nows = np.asarray([T0 + 3 * k for k in range(K)], np.int64)
    sketch0 = {"zero": np.zeros((D, W), np.int64),
               "flat": np.full((D, W), 6, np.int64),
               "random": rng.integers(0, 5000, (D, W)).astype(np.int64)}[kind]

    arena, words, _, _, acc = _drain_with_stats(st0, packed, nows, tenants, T)
    sketch = _t(sketch0[None].copy())
    stats = sk.stats_finish(sketch, acc, arena.expire, int(nows[0]), decay,
                            topk=topk, over_weight=4)

    want_st, _, _, _, planes = _jax_drain_with_stats(st0, packed, nows,
                                                     tenants, T)
    j_sk, j_stats = pk.staged_stats_finish(
        jnp.asarray(sketch0), planes, jnp.asarray(want_st.expire),
        jnp.int64(nows[0]), jnp.int64(decay), interpret=True, **kw)
    np.testing.assert_array_equal(sketch[0].numpy(), np.asarray(j_sk))
    np.testing.assert_array_equal(stats[0].numpy(), np.asarray(j_stats))
    o_sk, o = ja.oracle_stats(sketch0, packed, words.numpy(), tenants,
                              arena.expire[0].numpy(), int(nows[0]), decay,
                              **kw)
    np.testing.assert_array_equal(sketch[0].numpy(), o_sk)
    np.testing.assert_array_equal(stats[0].numpy(), o)
    cand = stats[0, ta.HEADER + T * ta.TENANT_COLS:].reshape(topk, 4)
    if name == "few_touched":
        assert (cand[:, 0] == -1).sum() >= topk - 3
    if name == "ties":
        est = cand[cand[:, 0] >= 0, 1]
        assert (est[1:] == est[:-1]).any(), "no tie in the estimate"


def test_release_lanes_part_jax_kernels_from_the_oracle():
    """The reference's own disagreement, pinned: on a drain with a
    CONCURRENCY release, the TPU kernels (stats drain + staged finisher,
    interpret mode) count the release's hits as negative, while
    oracle_stats and shard_stats read the raw 28-bit field; the port's
    stats drain and finisher give the oracle's answer."""
    C, B, T, topk, D, W = 64, 8, 4, 4, 4, 32
    kw = dict(tenant_slots=T, topk=topk, over_weight=4)
    slot = np.array([3, 3, 5, 9, -1, -1, -1, -1], np.int32)
    hits = np.array([2, -1, 1, -3, 0, 0, 0, 0], np.int64)
    algo = np.array([4, 4, 0, 4, 0, 0, 0, 0], np.int32)
    packed = np.asarray(jk.encode_batch_host(
        slot, hits, np.full(B, 10, np.int64), np.full(B, 60_000, np.int64),
        algo, np.zeros(B, bool)))[None]
    tenants = np.array([[1, 1, 2, 3, 0, 0, 0, 0]], np.int32)
    nows = np.asarray([T0], np.int64)
    st0 = _random_state(np.random.default_rng(5), C, T0)
    sketch0 = np.zeros((D, W), np.int64)

    want_st, jw, _, _, planes = _jax_drain_with_stats(st0, packed, nows,
                                                      tenants, T)
    j_sk, j_stats = pk.staged_stats_finish(
        jnp.asarray(sketch0), planes, jnp.asarray(want_st.expire),
        jnp.int64(T0), jnp.int64(0), interpret=True, **kw)
    o_sk, o = ja.oracle_stats(sketch0, packed, jw, tenants,
                              np.asarray(want_st.expire), T0, 0, **kw)
    j_stats = np.asarray(j_stats)
    assert j_stats[ta.IDX_HITS] == -1 and o[ta.IDX_HITS] == 536870911
    t1 = ta.HEADER + 1 * ta.TENANT_COLS + 1
    assert j_stats[t1] == 1 and o[t1] == 268435457
    assert not np.array_equal(np.asarray(j_sk), o_sk)

    arena, _, _, _, acc = _drain_with_stats(st0, packed, nows, tenants, T)
    sketch = _t(sketch0[None].copy())
    stats = sk.stats_finish(sketch, acc, arena.expire, T0, 0, topk=topk,
                            over_weight=4)
    np.testing.assert_array_equal(stats[0].numpy(), o)
    np.testing.assert_array_equal(sketch[0].numpy(), o_sk)


def test_stats_wrappers_check_their_inputs():
    C, T = 32, 4
    arena = tk.BucketState.zeros(C, device="cpu")
    arena = tk.BucketState(*[t[None].clone() for t in arena])
    acc = sk.StatsAccumulator(1, C, T, "cpu")
    packed = torch.zeros((2, 1, 8, 2), dtype=torch.int64)
    nows = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="tenants"):
        dk.drain_compact_stats(arena, packed, nows,
                               torch.zeros((2, 1, 8), dtype=torch.int64), acc)
    with pytest.raises(ValueError, match="accumulator"):
        dk.drain_compact_stats(arena, packed, nows,
                               torch.zeros((2, 1, 8), dtype=torch.int32),
                               sk.StatsAccumulator(1, C + 1, T, "cpu"))
    dk.drain_compact_stats(arena, packed, nows,
                           torch.zeros((2, 1, 8), dtype=torch.int32), acc)
    assert acc.entry_capacity == 16 and acc.pending == 16
    with pytest.raises(RuntimeError, match="unfinished"):
        acc.reserve(1)
    sketch = torch.zeros((1, 4, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="decay"):
        sk.stats_finish(sketch, acc, arena.expire, 0, 2, topk=4,
                        over_weight=4)
    with pytest.raises(ValueError, match="topk"):
        sk.stats_finish(sketch, acc, arena.expire, 0, 0, topk=C + 1,
                        over_weight=4)
    sk.stats_finish(sketch, acc, arena.expire, 0, 0, topk=4, over_weight=4)
    assert acc.pending == 0
    acc.reserve(40)
    assert acc.entry_capacity == 40


# ---------------------------------------------------------------------------
# 7. the host side: TrafficAnalytics and SLOEngine against the JAX
# package's, and the Instance wiring


def _stats_stream(rng, S, T, topk, n):
    """n drains' stats blocks [S, V]: counts, tenant rows, candidates on a
    few recurring slots, pads, as the device ships them."""
    V = ta.stats_len(T, topk)
    out = []
    for _ in range(n):
        st = np.zeros((S, V), np.int64)
        st[:, :7] = rng.integers(0, 100, (S, 7))
        st[:, ta.HEADER:ta.HEADER + 3 * T] = rng.integers(0, 9, (S, 3 * T))
        cand = st[:, ta.HEADER + 3 * T:].reshape(S, topk, 4)
        cand[:, :, 0] = rng.integers(-1, 12, (S, topk))
        cand[:, :, 1] = rng.integers(0, 500, (S, topk))
        cand[:, :, 2:] = rng.integers(0, 20, (S, topk, 2))
        cand[cand[:, :, 0] < 0] = (-1, 0, 0, 0)
        out.append((st, int(rng.random() < 0.3)))
    return out


def _both(conf_kw, now_fn):
    jc, tc = JAnalyticsConfig(), AnalyticsConfig()
    for k, v in conf_kw.items():
        setattr(jc, k, v)
        setattr(tc, k, v)
    return (jobs.TrafficAnalytics(jc, now_fn=now_fn),
            tobs.TrafficAnalytics(tc, now_fn=now_fn))


def test_traffic_analytics_matches_jax_package():
    """One stats stream (decayed drains, overflowing the rolling table)
    into both packages' TrafficAnalytics: equal snapshot(), topk_snapshot(),
    occupancy and tenant registry."""
    rng = np.random.default_rng(77)
    clock = {"t": 0.0}
    j, t = _both(dict(topk=4, tenant_slots=5), lambda: clock["t"])
    for name in ("a", "b", "c", "d", "e", "a"):
        assert j.tenant_id(name) == t.tenant_id(name)
    for i in range(9):
        j.label_slot(i % 2, i, f"key{i}")
        t.label_slot(i % 2, i, f"key{i}")
    for stats, decayed in _stats_stream(rng, 2, 5, 4, 12):
        clock["t"] += 250.0
        j.ingest(stats, decayed)
        t.ingest(stats, decayed)
    assert t.snapshot() == j.snapshot()
    assert t.topk_snapshot(3) == j.topk_snapshot(3)
    assert t.occupancy() == j.occupancy()


def test_rolling_table_decay_and_labels():
    """tests/test_analytics.py's case on the port: host-side halving,
    s<shard>:slot<n> until a label arrives, the decay cadence."""
    conf = AnalyticsConfig()
    conf.topk = 4
    clock = {"t": 0.0}
    an = tobs.TrafficAnalytics(conf, now_fn=lambda: clock["t"])
    V = ta.stats_len(conf.tenant_slots, conf.topk)
    stats = np.zeros((1, V), np.int64)
    base = ta.HEADER + conf.tenant_slots * ta.TENANT_COLS
    stats[0, base:base + 4] = (9, 100, 10, 1)
    an.ingest(stats)
    row = an.topk_snapshot(1)[0]
    assert row["key"] == "s0:slot9" and row["score"] == 100
    an.label_slot(0, 9, "tenantA_hot")
    assert an.topk_snapshot(1)[0]["key"] == "tenantA_hot"
    an.ingest(np.zeros((1, V), np.int64), decayed=1)
    assert an.topk_snapshot(1)[0]["score"] == 50
    assert an.decay_flag(0.0) == 0
    assert an.decay_flag(conf.decay_ms + 1.0) == 1
    assert an.decay_flag(conf.decay_ms + 2.0) == 0


def test_tenant_registry_overflow_to_other():
    conf = AnalyticsConfig()
    conf.tenant_slots = 4
    an = tobs.TrafficAnalytics(conf)
    ids = [an.tenant_id(f"t{i}") for i in range(6)]
    assert ids[:3] == [1, 2, 3] and ids[3:] == [0, 0, 0]
    assert an.tenant_id("t1") == 2


def _slo_pair(windows, budget, now_fn):
    out = []
    for cls, conf in ((jobs.SLOEngine, JSLOConfig()),
                      (tobs.SLOEngine, SLOConfig())):
        conf.drain_p99_ms = 100.0
        conf.drain_budget = budget
        conf.shed_budget = budget
        conf.availability = 0.999
        conf.burn_windows = windows
        out.append(cls(conf, now_fn=now_fn))
    return out


def _slo_fires_and_clears(slo, clock):
    for i in range(60):
        clock["t"] += 1.0
        slo.observe_drain(0.2 if i % 2 else 0.01, decisions=10)
    rates = slo.burn_rates()
    assert rates["drain_p99"]["firing"] is True
    assert rates["drain_p99"]["windows"]["60s"] == pytest.approx(50.0,
                                                                 rel=0.1)
    assert rates["shed_rate"]["firing"] is False
    for _ in range(70):
        clock["t"] += 1.0
        slo.observe_drain(0.01, decisions=10)
    assert slo.burn_rates()["drain_p99"]["firing"] is False


def _slo_short_window_gates(slo, clock):
    for _ in range(20):
        clock["t"] += 1.0
        slo.observe_drain(0.5, decisions=10)
    for _ in range(10):
        clock["t"] += 1.0
        slo.observe_drain(0.01, decisions=10)
    rates = slo.burn_rates()["drain_p99"]
    assert rates["windows"]["60s"] > 2.0
    assert rates["firing"] is False


def _slo_shed_and_error(slo, clock):
    for _ in range(10):
        clock["t"] += 1.0
        slo.observe_drain(0.01, decisions=90)
        slo.observe_shed(10)
    rates = slo.burn_rates()
    assert rates["shed_rate"]["firing"] is True
    assert rates["availability"]["firing"] is True
    slo.observe_error(5)
    assert slo.burn_rates()["availability"]["windows"]["30s"] > 0


@pytest.mark.parametrize("case,windows", [
    (_slo_fires_and_clears, "60:2"), (_slo_short_window_gates, "60:2"),
    (_slo_shed_and_error, "30:1")],
    ids=["test_slo_burn_fires_and_clears_deterministically",
         "test_slo_short_window_gates_stale_burn",
         "test_slo_shed_and_error_feed_availability"])
def test_slo_engine_matches_jax_package(case, windows):
    """tests/test_analytics.py's SLO cases on both packages' engines, fed
    the same evidence under one fake clock: each case holds on the port,
    and the two snapshots agree."""
    clock = {"t": 1000.0}
    j, t = _slo_pair(windows, 0.01, lambda: clock["t"])
    for slo in (j, t):
        clock["t"] = 1000.0
        case(slo, clock)
    assert t.snapshot() == j.snapshot()


def test_config_env_knobs(monkeypatch):
    monkeypatch.setenv("GUBER_ANALYTICS", "1")
    monkeypatch.setenv("GUBER_ANALYTICS_TOPK", "8")
    monkeypatch.setenv("GUBER_ANALYTICS_SKETCH_DEPTH", "2")
    c = AnalyticsConfig()
    assert c.enabled and c.topk == 8 and c.sketch_depth == 2
    c.validate()
    assert vars(c) == vars(JAnalyticsConfig())
    monkeypatch.setenv("GUBER_ANALYTICS_SKETCH_DEPTH", "99")
    with pytest.raises(ValueError):
        AnalyticsConfig().validate()
    monkeypatch.setenv("GUBER_SLO", "true")
    monkeypatch.setenv("GUBER_SLO_BURN_WINDOWS", "60:2, 600:1,junk")
    s = SLOConfig()
    assert s.enabled
    assert s.windows() == [(60.0, 2.0), (600.0, 1.0)]
    assert vars(s) == vars(JSLOConfig())
    monkeypatch.setenv("GUBER_SLO_BURN_WINDOWS", "garbage")
    assert SLOConfig().windows() == [(300.0, 14.4), (1800.0, 6.0),
                                     (7200.0, 1.0)]


def test_instance_wires_analytics_and_slo():
    """Instance(analytics=, slo=) allocates the engine's sketch and
    accumulator at the configured geometry and builds TrafficAnalytics /
    SLOEngine; both stay off by default and when disabled."""
    conf = AnalyticsConfig(enabled=True, topk=8, sketch_width=64,
                           sketch_depth=3, tenant_slots=5)
    slo = SLOConfig(enabled=True)
    inst = Instance(device="cpu", analytics=conf, slo=slo)
    try:
        eng = inst.engine
        assert tuple(eng._an_sketch.shape) == (eng.num_shards, 3, 64)
        assert not eng._an_sketch.any()
        assert eng._an_acc.shape == (eng.num_shards,
                                     eng.capacity_per_shard, 5)
        assert isinstance(inst.analytics, tobs.TrafficAnalytics)
        assert isinstance(inst.slo, tobs.SLOEngine)
        assert eng.export_analytics().shape == (eng.num_shards, 3, 64)
    finally:
        inst.close()
    for kw in ({}, {"analytics": AnalyticsConfig(enabled=False),
                    "slo": SLOConfig(enabled=False)}):
        inst = Instance(device="cpu", **kw)
        try:
            assert inst.analytics is None and inst.slo is None
            assert inst.engine._an_sketch is None
        finally:
            inst.close()
    with pytest.raises(ValueError, match="sketch_depth"):
        Instance(device="cpu", analytics=AnalyticsConfig(enabled=True,
                                                         sketch_depth=9))
