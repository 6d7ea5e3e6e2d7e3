"""The port's GLOBAL window (ops/global_kernel.py) on CPU tensors against the
JAX package's composition of the same window.

The JAX engine runs a GLOBAL window as `_apply_config` (config writes and
state resets, gubernator_tpu/core/engine.py:2645), `kernel.
global_accumulate` on every shard's lanes summed over the shards (the mesh
psum), then `kernel.global_combined` - or, under GUBER_PALLAS=1,
`kernel.global_read` then `kernel.global_apply`.  The port packs the
window's control into one int64 block and runs `global_window`, or
`global_stage`, its torch reads and `global_apply`, over an arena and
config updated in place with a scratch of per-slot sums that must come back
all zero.  Held here, on numpy-seeded inputs through both:

  * the port's `apply_config` against JAX `_apply_config` on negative and
    out-of-range write and reset slots (JAX's scatter writes row G + idx
    for idx in [-G, 0) and drops the rest);
  * the packed control block round-tripping every field at its dtype;
  * `global_window` and the per-op trio against the JAX composition:
    every plane of the arena and config, every lane's read (pads 0) and
    the scratch.

Tolerance: exact equality (every quantity is an integer).
"""

import numpy as np
import pytest
import torch

import gubernator_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp

from gubernator_tpu.core import engine as jengine
from gubernator_tpu.ops import kernel as jk
from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.ops import global_kernel as gk
from gubernator_tpu_torch.ops import kernel as tk

from .test_torch_global import global_inputs

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000
I64_MAX, I64_MIN = 2**63 - 1, -2**63
EDGE_SLOTS = lambda G: (-G - 1, -G, -1, 0, G - 1, G, G + 1)  # noqa: E731


# ---------------------------------------------------------------- inputs

def random_control(rng, G, S, Bg, Kg, algos=(0, 1), wrap=False):
    """numpy (gbatch [S, Bg], gacc [S, Bg], upd [Kg] x 5) of one GLOBAL
    window with every edge: lanes from several shards on a few hot slots
    and on other slots, pads below 0 and slots at G and past it, is_init,
    hits that cancel (releases beside hits), lanes whose hits do not
    contribute; config writes on distinct rows, some named by their
    negative index, some switching the row's algorithm; resets on slots
    the lanes read, some negative; write and reset pads below -G and at G
    and past it.  `wrap` puts int64 extremes into hits, limits and
    durations."""
    n = S * Bg
    keys = rng.choice(G, min(G, max(1, Kg // 2)), replace=False)
    hot = keys[:max(1, keys.size // 8)]
    slot = np.where(rng.random(n) < 0.5, rng.choice(hot, n),
                    rng.choice(keys, n))
    edge = rng.random(n)
    slot = np.where(edge < 0.08, rng.choice([-1, -2, -G - 3], n), slot)
    slot = np.where((edge >= 0.08) & (edge < 0.14),
                    rng.choice([G, G + 1, G + 7], n), slot)
    hits = rng.choice([0, 1, 1, 2, 5, -1, -3], n).astype(np.int64)
    limit = rng.integers(0, 200, n)
    duration = rng.integers(0, 120_000, n)
    if wrap:
        ends = np.asarray([I64_MAX, I64_MIN, I64_MIN + 1, 2**62, -2**62,
                           2**32 + 7], np.int64)
        for a in (hits, limit, duration):
            m = rng.random(n) < 0.2
            a[m] = rng.choice(ends, int(m.sum()))
    gacc = np.where(rng.random(n) < 0.8, hits, 0).reshape(S, Bg)
    gbatch = tk.WindowBatch(
        slot=slot.astype(np.int32).reshape(S, Bg),
        hits=hits.reshape(S, Bg), limit=limit.astype(np.int64).reshape(S, Bg),
        duration=duration.astype(np.int64).reshape(S, Bg),
        algo=rng.choice(np.asarray(algos, np.int32), n).reshape(S, Bg),
        is_init=(rng.random(n) < 0.15).reshape(S, Bg))
    upd = (np.full(Kg, G, np.int32), np.zeros(Kg, np.int64),
           np.zeros(Kg, np.int64), np.zeros(Kg, np.int32),
           np.full(Kg, G, np.int32))
    rows = rng.permutation(keys)[:Kg]
    k = rows.size
    upd[0][:k] = np.where(rng.random(k) < 0.3, rows - G, rows)
    upd[1][:k] = rng.integers(0, 200, k)
    upd[2][:k] = rng.integers(0, 120_000, k)
    upd[3][:k] = rng.choice(np.asarray(algos, np.int32), k)
    reset = rows[rng.random(k) < 0.3]
    upd[4][:reset.size] = np.where(rng.random(reset.size) < 0.3, reset - G,
                                   reset)
    # pads on both sides in both kinds of config lane
    for col in (upd[0], upd[4]):
        if Kg > k + 1:
            col[k:k + 2] = (-G - 1, G + 1)
    return gbatch, gacc, upd


def arena(rng, G, algos=(0, 1), wrap=False):
    """numpy (state, cfg) dicts of a GLOBAL arena with the edges of
    tests/test_torch_global.py."""
    state, cfg, _, _ = global_inputs(rng, algos, wrap, G=G, n=2)
    return state, cfg


def _jax_planes(state, cfg):
    return (jk.BucketState(**{k: jnp.asarray(v) for k, v in state.items()}),
            jk.GlobalConfig(**{k: jnp.asarray(v) for k, v in cfg.items()}))


def _torch_planes(state, cfg):
    return (tk.BucketState(**{k: torch.from_numpy(np.array(v))
                              for k, v in state.items()}),
            tk.GlobalConfig(**{k: torch.from_numpy(np.array(v))
                               for k, v in cfg.items()}))


def jax_window(state, cfg, gbatch, gacc, upd, now, per_op=False):
    """The JAX engine's GLOBAL window on numpy inputs: _apply_config, each
    shard's kernel.global_accumulate summed over the shards, then
    kernel.global_combined (or, per_op, global_read then global_apply).
    Returns numpy (state, cfg, read i64[n, 4] with pad lanes 0)."""
    js, jc = _jax_planes(state, cfg)
    js, jc = jengine._apply_config(js, jc, tuple(jnp.asarray(a) for a in upd))
    G = js.limit.shape[0]
    summed = sum(jk.global_accumulate(
        jnp.zeros(G, jnp.int64),
        jk.WindowBatch(*[jnp.asarray(a[s]) for a in gbatch])._replace(
            hits=jnp.asarray(gacc[s]))) for s in range(gacc.shape[0]))
    flat = jk.WindowBatch(*[jnp.asarray(np.asarray(a).reshape(-1))
                            for a in gbatch])
    if per_op:
        out = jk.global_read(js, flat, jnp.int64(now))
        new = jk.global_apply(js, jc, summed, jnp.int64(now))
    else:
        new, out = jk.global_combined(js, jc, flat, summed, jnp.int64(now))
    read = np.stack([np.asarray(out.status).astype(np.int64),
                     np.asarray(out.limit), np.asarray(out.remaining),
                     np.asarray(out.reset_time)], axis=-1)
    read[np.asarray(flat.slot) < 0] = 0
    return ([np.asarray(a) for a in new], [np.asarray(a) for a in jc], read)


def assert_window(got_state, got_cfg, got_read, want, tag):
    w_state, w_cfg, w_read = want
    for f, a, b in zip(tk.BucketState._fields, got_state, w_state):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=f"{tag} gstate.{f}")
    for f, a, b in zip(tk.GlobalConfig._fields, got_cfg, w_cfg):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=f"{tag} gcfg.{f}")
    np.testing.assert_array_equal(np.asarray(got_read), w_read,
                                  err_msg=f"{tag} read")


# ---------------------------------------------------------------- apply_config

def _apply_both(G, uslot, rslot, seed=0):
    rng = np.random.default_rng(seed)
    state, cfg = arena(rng, G)
    Kg = len(uslot)
    upd = (np.asarray(uslot, np.int32), rng.integers(1, 99, Kg),
           rng.integers(1, 9999, Kg), rng.integers(0, 5, Kg).astype(np.int32),
           np.asarray(rslot, np.int32))
    js, jc = jengine._apply_config(*_jax_planes(state, cfg),
                                   tuple(jnp.asarray(a) for a in upd))
    ts, tc = _torch_planes(state, cfg)
    gk.apply_config(ts, tc, tuple(torch.from_numpy(np.array(a)) for a in upd))
    for f, a, b in zip(tk.BucketState._fields, ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"G={G} gstate.{f}")
    for f, a, b in zip(tk.GlobalConfig._fields, tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"G={G} gcfg.{f}")
    return tc, upd


@pytest.mark.parametrize("G", [1, 4, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_config_matches_jax_on_edge_slots(G, seed):
    """Write and reset slots drawn from {-G-1, -G, -1, 0, G-1, G, G+1}: the
    write slots on distinct rows (a scatter with duplicates has no order),
    the resets any of them."""
    rng = np.random.default_rng(seed)
    edges = np.asarray(EDGE_SLOTS(G))
    row = np.where(edges < 0, edges + G, edges)
    uslot, seen = [], set()
    for i in rng.permutation(edges.size):
        r = int(row[i])
        if 0 <= r < G:
            if r in seen:
                continue
            seen.add(r)
        uslot.append(int(edges[i]))
    rslot = rng.choice(edges, len(uslot))
    _apply_both(G, uslot, rslot, seed)


def test_apply_config_writes_row_g_minus_1_for_slot_minus_1():
    """The smallest input that showed the port's old rule (negative slots
    dropped) apart from JAX's: G = 4, uslot = [-1] writes row 3."""
    tc, upd = _apply_both(4, [-1], [4])
    assert (int(tc.limit[3]), int(tc.duration[3]), int(tc.algo[3])) == \
        (int(upd[1][0]), int(upd[2][0]), int(upd[3][0]))


# ---------------------------------------------------------------- the block

@pytest.mark.parametrize("S,Bg,Kg", [(1, 1, 0), (2, 5, 3), (8, 16, 16)])
def test_control_block_round_trips_every_field(S, Bg, Kg):
    rng = np.random.default_rng(S * 100 + Bg)
    G = 64
    if Kg:
        gbatch, gacc, upd = random_control(rng, G, S, Bg, Kg, wrap=True)
    else:
        gbatch, gacc, _ = random_control(rng, G, S, Bg, 2, wrap=True)
        upd = tuple(np.zeros(0, d) for d in
                    (np.int32, np.int64, np.int64, np.int32, np.int32))
    ctl = gk.make_control(gbatch, gacc, upd, "cpu")
    n = S * Bg
    assert ctl.n == n and ctl.kg == Kg
    assert ctl.block.shape == (gk.control_words(n, Kg),)
    assert ctl.block.dtype == torch.int64
    lanes, g, u = gk.unpack_control(ctl)
    for f, a, b in zip(tk.WindowBatch._fields, lanes, gbatch):
        b = np.asarray(b).reshape(-1)
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    np.testing.assert_array_equal(g.numpy(), gacc.reshape(-1))
    for f, a, b in zip(gk.UPD_FIELDS, u, upd):
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    # pack_control writes into a longer buffer from its start
    big = np.full(gk.control_words(n, Kg) + 5, -9, np.int64)
    assert gk.pack_control(big, gbatch, gacc, upd) == (n, Kg)
    np.testing.assert_array_equal(big[:-5], ctl.block.numpy())
    assert (big[-5:] == -9).all()


# ---------------------------------------------------------------- the window

CASES = {
    "token_leaky": ((0, 1), False),
    "all_algorithms": (tuple(range(7)), False),
    "wrapped_i64": (tuple(range(7)), True),
}


def _port_window(state, cfg, ctl_np, now, per_op):
    ts, tc = _torch_planes(state, cfg)
    ctl = gk.make_control(*ctl_np, "cpu")
    scratch = torch.zeros(ts.limit.shape[0], dtype=torch.int64)
    planes = [t.data_ptr() for t in (*ts, *tc)]
    gk.reset_counts()
    if per_op:
        gk.global_stage(ts, tc, ctl, scratch)
        read = gk.global_read_block(ts, ctl, now)
        gk.global_apply(ts, tc, ctl, scratch, now)
        assert gk.plain_calls == {"global_window": 0, "global_stage": 1,
                                  "global_apply": 1,
        "global_stage_read": 0, "global_apply_rows": 0}
    else:
        read = gk.global_window(ts, tc, ctl, scratch, now)
        assert gk.plain_calls == {"global_window": 1, "global_stage": 0,
                                  "global_apply": 0,
        "global_stage_read": 0, "global_apply_rows": 0}
    assert not any(gk.launches.values())
    assert not scratch.any(), "the scratch is not back at zero"
    # in place: the same planes
    assert planes == [t.data_ptr() for t in (*ts, *tc)]
    return ts, tc, read


@pytest.mark.parametrize("per_op", [False, True], ids=["window", "per_op"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_global_window_matches_jax_composition(case, seed, per_op):
    algos, wrap = CASES[case]
    rng = np.random.default_rng(400 + seed)
    G, S, Bg, Kg = 256, 4, 32, 48
    state, cfg = arena(rng, G, algos, wrap)
    ctl = random_control(rng, G, S, Bg, Kg, algos, wrap)
    now = T0 + seed
    want = jax_window(state, cfg, *ctl, now, per_op=per_op)
    assert_window(*_port_window(state, cfg, ctl, now, per_op), want,
                  f"{case} seed {seed}")


def test_global_window_rejects_malformed_inputs():
    rng = np.random.default_rng(9)
    G = 16
    state, cfg = arena(rng, G)
    ts, tc = _torch_planes(state, cfg)
    ctl = gk.make_control(*random_control(rng, G, 2, 4, 4), "cpu")
    sc = torch.zeros(G, dtype=torch.int64)
    with pytest.raises(ValueError, match="scratch"):
        gk.global_window(ts, tc, ctl, sc.to(torch.int32), T0)
    with pytest.raises(ValueError, match="gstate.algo"):
        gk.global_window(ts._replace(algo=ts.limit), tc, ctl, sc, T0)
    with pytest.raises(ValueError, match="gcfg.limit"):
        gk.global_window(ts, tc._replace(limit=tc.limit[:-1]), ctl, sc, T0)
    with pytest.raises(ValueError, match="control.block"):
        gk.global_window(ts, tc, ctl._replace(block=ctl.block[:-1]), sc, T0)
    with pytest.raises(ValueError, match="control"):
        gk.global_stage(ts, tc, ctl._replace(n=0), sc)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gk.global_apply(*[type(x)(*[t.to("meta") for t in x])
                          for x in (ts, tc)],
                        ctl._replace(block=ctl.block.to("meta")),
                        sc.to("meta"), T0)


def test_engine_updates_the_global_arena_in_place():
    """The engine's GLOBAL arena and config keep their tensors across
    windows (the kernels write in place), and the sums scratch is all zero
    after every window."""
    eng = RateLimitEngine(num_shards=2, capacity_per_shard=64,
                          batch_per_shard=16, global_capacity=32,
                          global_batch_per_shard=8, max_global_updates=8,
                          device="cpu")
    planes = [t.data_ptr() for t in (*eng.gstate, *eng.gcfg)]
    for w in range(3):
        reqs = [RateLimitReq(name="g", unique_key=f"k{i % 5}", hits=1,
                             limit=4, duration=10_000,
                             behavior=Behavior.GLOBAL) for i in range(12)]
        eng.process(reqs, now=T0 + w)
        assert not eng._gsums.any()
    assert planes == [t.data_ptr() for t in (*eng.gstate, *eng.gcfg)]
    assert int(eng.export_arena()["gstate.remaining"].sum()) > 0


def _dispatch_inputs(eng):
    packed = np.zeros((1, eng.num_shards, eng.batch_per_shard, 2), np.int64)
    gb, ga, upd = eng.empty_drain_control()
    return packed, np.full(1, T0, np.int64), gb, ga, upd


@pytest.mark.parametrize("where", ["nows", "gbatch", "gacc", "upd"])
def test_pipeline_dispatch_global_refuses_device_tensors(where):
    """nows and the GLOBAL control cross from the host: a tensor that lives
    on a device (here the meta device, which holds no data) raises instead
    of being fetched, which would wait for the device."""
    eng = RateLimitEngine(num_shards=2, capacity_per_shard=64,
                          batch_per_shard=16, global_capacity=32,
                          global_batch_per_shard=8, max_global_updates=8,
                          device="cpu")
    packed, nows, gb, ga, upd = _dispatch_inputs(eng)
    meta = lambda a: torch.from_numpy(np.asarray(a)).to("meta")  # noqa: E731
    if where == "nows":
        nows = meta(nows)
    elif where == "gbatch":
        gb = gb._replace(hits=meta(gb.hits))
    elif where == "gacc":
        ga = meta(ga)
    else:
        upd = (meta(upd[0]), *upd[1:])
    with pytest.raises(TypeError, match="host array"):
        eng.pipeline_dispatch_global(packed, nows, gb, ga, upd)


def test_pipeline_dispatch_global_takes_cpu_tensors_as_host_arrays():
    """CPU tensors for nows and the GLOBAL control give what numpy arrays
    give: the same reads, arena and config."""
    outs = []
    for as_tensor in (False, True):
        eng = RateLimitEngine(num_shards=2, capacity_per_shard=64,
                              batch_per_shard=16, global_capacity=32,
                              global_batch_per_shard=8, max_global_updates=8,
                              device="cpu")
        packed, nows, _, _, _ = _dispatch_inputs(eng)
        gb, ga, upd = random_control(np.random.default_rng(5), 32, 2, 8, 8)
        if as_tensor:
            t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
            nows, gb, ga = t(nows), tk.WindowBatch(*[t(a) for a in gb]), t(ga)
            upd = tuple(t(a) for a in upd)
        gf = eng.pipeline_dispatch_global(packed, nows, gb, ga, upd)[3]
        outs.append((gf.numpy(), eng.export_arena()))
        assert not eng._gsums.any()
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    for k in outs[0][1]:
        np.testing.assert_array_equal(outs[0][1][k], outs[1][1][k], err_msg=k)


def test_stamp_split_reads_a_launch_timeline():
    """gk.stamp_split on stamps of two CTAs: globaltimer times since the
    first CTA's start (the latest CTA), clock64 cycles since each CTA's
    own start (the mean over CTAs)."""
    buf = gk.debug_stamps(2, "cpu")
    assert tuple(buf.shape) == (2, 2, len(gk.STAMPS))
    base = 10**15
    buf[0, 0] = torch.tensor([0, 1000, 1500, 4000, 4300, 4500]) + base
    buf[1, 0] = torch.tensor([200, 900, 1500, 4200, 4300, 4400]) + base
    buf[0, 1] = torch.tensor([0, 10, 20, 30, 40, 50]) + 7
    buf[1, 1] = torch.tensor([0, 30, 40, 50, 60, 70]) + 99
    got = gk.stamp_split(buf)
    assert got["start spread us"] == 0.2
    assert got["phase A us"] == 1.0
    assert got["barrier 1 us"] == 1.5
    assert got["phase B us"] == 4.2
    assert got["barrier 2 us"] == 4.3
    assert got["end us"] == 4.5
    assert got["phase A cycles"] == 20.0
    assert got["end cycles"] == 60.0


# ---------------------------------------------------------------- upserts
#
# An owner's broadcast lands on a replica as upsert lanes of its next
# GLOBAL window (JAX engine.py:2617 _apply_control): written before the
# window's config lanes and resets, so on a row both name the config
# lane's fields (and a reset's expire = 0) win.

def random_upserts(rng, G, ku, upd):
    """numpy upsert lanes (pslot, plimit, pduration, premaining, ptstamp,
    pexpire, palgo) of [ku] on distinct rows, some by their negative
    index, about half of them on rows the config lanes `upd` write or
    reset, with pads below -G and at G and past it."""
    urows = np.where(upd[0] < 0, upd[0] + G, upd[0])
    rrows = np.where(upd[4] < 0, upd[4] + G, upd[4])
    named = list(dict.fromkeys(int(r) for r in np.concatenate(
        [urows, rrows]) if 0 <= r < G))
    other = [r for r in rng.permutation(G).tolist() if r not in named]
    half = max(1, (ku - 2) // 2)
    rows = np.asarray(list(rng.permutation(named))[:half]
                      + other[:ku - 2 - min(half, len(named))], np.int64)
    k = rows.size
    pslot = np.full(ku, G, np.int32)
    pslot[:k] = np.where(rng.random(k) < 0.3, rows - G, rows)
    if ku > k + 1:
        pslot[k:k + 2] = (-G - 1, G + 3)
    ups = (pslot, rng.integers(0, 300, ku).astype(np.int64),
           rng.integers(1, 120_000, ku).astype(np.int64),
           rng.integers(-5, 300, ku).astype(np.int64),
           T0 + rng.integers(-60_000, 60_000, ku),
           T0 + rng.integers(-60_000, 120_000, ku),
           rng.choice(np.asarray([0, 1], np.int32), ku))
    return ups


def jax_window_ups(state, cfg, gbatch, gacc, upd, ups, now, per_op=False):
    """jax_window with the upserts: _apply_control in place of
    _apply_config."""
    js, jc = jengine._apply_control(*_jax_planes(state, cfg),
                                    tuple(jnp.asarray(a) for a in upd),
                                    tuple(jnp.asarray(a) for a in ups))
    G = js.limit.shape[0]
    state = {f: np.asarray(a) for f, a in zip(jk.BucketState._fields, js)}
    cfg = {f: np.asarray(a) for f, a in zip(jk.GlobalConfig._fields, jc)}
    # the config lanes were applied with the upserts: none are left
    empty = (np.full(1, G, np.int32), np.zeros(1, np.int64),
             np.zeros(1, np.int64), np.zeros(1, np.int32),
             np.full(1, G, np.int32))
    return jax_window(state, cfg, gbatch, gacc, empty, now, per_op=per_op)


@pytest.mark.parametrize("G", [8, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_control_matches_jax_with_upserts(G, seed):
    """The plain apply_control against JAX _apply_control: upsert rows
    also written or reset by config lanes (those fields end as the config
    lane and the reset left them), negative indices, pads."""
    rng = np.random.default_rng(700 + seed)
    state, cfg = arena(rng, G)
    _, _, upd = random_control(rng, G, 1, 4, max(2, G // 4))
    ups = random_upserts(rng, G, max(6, G // 4), upd)
    js, jc = jengine._apply_control(*_jax_planes(state, cfg),
                                    tuple(jnp.asarray(a) for a in upd),
                                    tuple(jnp.asarray(a) for a in ups))
    ts, tc = _torch_planes(state, cfg)
    gk.apply_control(ts, tc, tuple(torch.from_numpy(a) for a in upd),
                     tuple(torch.from_numpy(a) for a in ups))
    assert_window(ts, tc, np.zeros(0), ([np.asarray(a) for a in js],
                                        [np.asarray(a) for a in jc],
                                        np.zeros(0)), f"G={G}")
    # the case the kernels order by lookup: some row named by both
    urows = {int(r) % G for r in upd[0] if -G <= r < G}
    rrows = {int(r) % G for r in upd[4] if -G <= r < G}
    prows = {int(r) % G for r in ups[0] if -G <= r < G}
    assert prows & urows and prows - urows - rrows


def test_upsert_and_config_lane_on_one_slot():
    """The smallest such window: G = 4, an upsert and a config lane on row
    2 and a reset on it: the row ends with the upsert's remaining and
    tstamp, the config lane's limit, duration and algorithm, expire 0."""
    rng = np.random.default_rng(5)
    state, cfg = arena(rng, 4)
    upd = (np.asarray([2], np.int32), np.asarray([7]), np.asarray([900]),
           np.asarray([1], np.int32), np.asarray([-2], np.int32))
    ups = (np.asarray([-2], np.int32), np.asarray([50]), np.asarray([60]),
           np.asarray([33]), np.asarray([T0]), np.asarray([T0 + 60]),
           np.asarray([0], np.int32))
    ts, tc = _torch_planes(state, cfg)
    gk.apply_control(ts, tc, tuple(torch.from_numpy(a) for a in upd),
                     tuple(torch.from_numpy(a) for a in ups))
    js, jc = jengine._apply_control(*_jax_planes(state, cfg),
                                    tuple(jnp.asarray(a) for a in upd),
                                    tuple(jnp.asarray(a) for a in ups))
    got = [int(p[2]) for p in (*ts, *tc)]
    assert got == [int(np.asarray(p)[2]) for p in (*js, *jc)]
    assert got == [50, 60, 33, T0, 0, 0, 7, 900, 1]


@pytest.mark.parametrize("per_op", [False, True], ids=["window", "per_op"])
@pytest.mark.parametrize("seed", [0, 1])
def test_global_window_with_upserts_matches_jax_composition(seed, per_op):
    """global_window (and global_stage + reads + global_apply) on a control
    block carrying upsert lanes against the JAX composition with
    _apply_control: the reads see the upserted rows."""
    rng = np.random.default_rng(800 + seed)
    G, S, Bg, Kg = 128, 2, 16, 24
    state, cfg = arena(rng, G)
    gbatch, gacc, upd = random_control(rng, G, S, Bg, Kg)
    ups = random_upserts(rng, G, 12, upd)
    # lanes read some upserted rows
    prow = np.asarray(ups[0])[:6] % G
    gbatch.slot.reshape(-1)[:6] = prow
    now = T0 + seed
    want = jax_window_ups(state, cfg, gbatch, gacc, upd, ups, now, per_op)
    ts, tc = _torch_planes(state, cfg)
    ctl = gk.make_control(gbatch, gacc, upd, "cpu", ups)
    assert (ctl.n, ctl.kg, ctl.ku) == (S * Bg, Kg, 12)
    assert ctl.block.shape == (gk.control_words(S * Bg, Kg, 12),)
    for f, a, b in zip(gk.UPS_FIELDS, gk.unpack_upserts(ctl), ups):
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    scratch = torch.zeros(G, dtype=torch.int64)
    if per_op:
        gk.global_stage(ts, tc, ctl, scratch)
        read = gk.global_read_block(ts, ctl, now)
        gk.global_apply(ts, tc, ctl, scratch, now)
    else:
        read = gk.global_window(ts, tc, ctl, scratch, now)
    assert not scratch.any()
    assert_window(ts, tc, read, want, f"seed {seed}")


def _upsert_engines(monkeypatch, per_op):
    from gubernator_tpu import compat
    from gubernator_tpu.parallel.mesh import make_mesh
    import jax
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()
    geo = dict(capacity_per_shard=32, batch_per_shard=8, global_capacity=16,
               global_batch_per_shard=4, max_global_updates=4)
    ref = jengine.RateLimitEngine(mesh=make_mesh(jax.devices("cpu")[4:6]),
                                  use_native=False, skip_global=False, **geo)
    if per_op:
        monkeypatch.setenv("GUBER_PALLAS", "1")
    port = RateLimitEngine(num_shards=2, device="cpu", **geo)
    monkeypatch.delenv("GUBER_PALLAS", raising=False)
    assert port.per_op == per_op
    return ref, port


@pytest.mark.parametrize("per_op", [False, True], ids=["default", "per_op"])
def test_engine_step_upserts_match_the_jax_engine(monkeypatch, per_op):
    """engine.step([], upserts=...) against the JAX engine's on the same
    arena: token and leaky records on live slots and on fresh keys (more
    than one window's lanes, so the native path chunks them), then reads
    with and without accumulation; every answer, the GLOBAL arena and its
    config after every window.  A key twice in one window raises."""
    from gubernator_tpu.api.types import RateLimitReq as JReq
    from gubernator_tpu.api.types import RateLimitResp as JResp
    from gubernator_tpu.api.types import UpdatePeerGlobal as JUp
    from gubernator_tpu_torch.api.types import RateLimitResp, UpdatePeerGlobal
    ref, port = _upsert_engines(monkeypatch, per_op)

    def reqs(cls, hits, keys):
        return [cls(name="u", unique_key=k, hits=hits, limit=9,
                    duration=4000, algorithm=a, behavior=2)
                for k, a in keys]

    def ups(up_cls, resp_cls, recs):
        return [up_cls(key=f"u_{k}", status=resp_cls(
            status=0, limit=lim, remaining=rem, reset_time=rst),
            algorithm=a, duration=d) for k, lim, rem, rst, a, d in recs]

    def compare(tag):
        for f, a, b in zip(tk.BucketState._fields, port.gstate, ref.gstate):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{tag} gstate.{f}")
        for f, a, b in zip(tk.GlobalConfig._fields, port.gcfg, ref.gcfg):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{tag} gcfg.{f}")

    def both(tag, hits, keys, now, acc=None, recs=()):
        p = port.step(reqs(RateLimitReq, hits, keys), now, acc,
                      upserts=ups(UpdatePeerGlobal, RateLimitResp, recs))
        j = ref.step(reqs(JReq, hits, keys), now, acc,
                     upserts=ups(JUp, JResp, recs))
        assert [(int(r.status), r.limit, r.remaining, r.reset_time)
                for r in p] == [(int(r.status), r.limit, r.remaining,
                                 r.reset_time) for r in j], tag
        compare(tag)

    live = [("a", 0), ("b", 1)]
    both("live", 2, live, T0)
    recs = [("a", 9, 3, T0 + 4000, 0, 4000), ("b", 9, 5, 0, 1, 4000),
            ("c", 8, 1, T0 + 3000, 0, 3000), ("d", 6, 4, 0, 1, 2000)]
    both("upserts", 1, [], T0 + 10, recs=recs)
    fresh = [("c", 0), ("d", 1), ("a", 0), ("b", 1)]
    both("replica reads", 0, fresh, T0 + 20, acc=[False] * 4)
    both("owner hits", 1, fresh, T0 + 30)
    with pytest.raises(ValueError, match="twice"):
        port.step([], T0 + 40, upserts=ups(UpdatePeerGlobal, RateLimitResp,
                                           recs[:1] * 2))
