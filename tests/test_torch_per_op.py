"""The per-op lowering's kernels on CPU tensors against the JAX package's
int64 oracle and its per-op TPU kernels.

The port's GUBER_PALLAS=1 lowering has two kernels:
ops/window_math_kernel.py `window_math` (ops/csrc/window_math.cu, the
counterpart of pallas_kernel.window_step_pallas) inside
`window_step_per_op` (torch prep, the kernel, torch commit), and
ops/global_kernel.py `global_stage` then `global_apply`
(ops/csrc/global_apply.cu, the counterpart of
pallas_kernel.global_apply_pallas), which take a window's packed control:
an arbitrary per-slot sum travels as one contributing lane per row.  On the CPU the
wrappers run their plain versions; the CUDA kernels are held against those
on the card by chip_smoke.py phase 7, and as host-built source against the
oracle by tests/test_torch_drain_host.py.  References, on the same
numpy-seeded inputs:

  * `kernel.global_apply` and `global_apply_pallas(..., interpret=True)`
    on tests/test_pallas.py's GLOBAL inputs, and the oracle on
    tests/test_torch_global.py's edge inputs (all five algorithms, int64
    values wrapped at both ends);
  * `kernel.window_step` (the int64 oracle) over chained windows of all
    five algorithms and out-of-range values at full int64 range, with hot
    runs that fold and runs that replay, AGG lanes, inits, pads, slots past
    the arena beside lanes on row C - 1, and a clock that steps backwards:
    tests/test_pallas.py's slow int64 differential, through the oracle
    rather than interpret mode;
  * `window_step_pallas(..., interpret=True, compact32=True)` - the only
    form of the TPU kernel Mosaic lowers - on tests/test_pallas.py's
    compact-range traffic with a monotonic clock.  On a clock that steps
    backwards that kernel parts from the oracle; the port follows the
    oracle, and a test pins the divergence (ROADMAP Queue 3).

Compared exactly (every quantity is an integer): every valid lane's
response fields, every arena plane; the port's pad lanes answer 0.
"""

import numpy as np
import pytest
import torch

import gubernator_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from gubernator_tpu.ops import kernel as jk
from gubernator_tpu.ops.pallas_kernel import (
    global_apply_pallas,
    window_step_pallas,
)
from gubernator_tpu_torch.ops import global_kernel as gk
from gubernator_tpu_torch.ops import kernel as tk
from gubernator_tpu_torch.ops import window_math_kernel as wm

from .test_pallas import _random_state, _random_window
from .test_torch_global import CASES, global_inputs, summed_control

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000
I64_MAX, I64_MIN = 2**63 - 1, -2**63
_jstep = jax.jit(jk.window_step)


def _t(a, dtype=None):
    a = np.ascontiguousarray(np.asarray(a))
    return torch.from_numpy(a.astype(dtype) if dtype else a.copy())


def _tstate(st):
    return tk.BucketState(*[_t(a) for a in st])


def _tbatch(bt):
    return tk.WindowBatch(*[_t(a) for a in bt])


def _jbatch(bt):
    return jk.WindowBatch(*[jnp.asarray(np.asarray(a)) for a in bt])


# ---------------------------------------------------------------------------
# inputs


def per_op_state(rng, C, now, wide):
    """numpy BucketState fields for C rows: every algorithm value 0..6,
    about half expired, some never initialized; `wide` draws limits,
    durations, balances and times far outside the compact caps and puts
    int64 extremes in a few rows."""
    if wide:
        st = dict(limit=rng.integers(0, 2**40, C),
                  duration=rng.integers(0, 2**36, C),
                  remaining=rng.integers(-5, 2**33, C),
                  tstamp=now + rng.integers(-2**33, 2**33, C),
                  expire=now + rng.integers(-2**33, 2**33, C))
        ends = np.asarray([I64_MAX, I64_MIN, I64_MAX - 1, -2**62, 2**62],
                          np.int64)
        for k in st:
            m = rng.random(C) < 0.05
            st[k] = np.where(m, rng.choice(ends, C), st[k])
    else:
        st = dict(limit=rng.integers(1, 900, C),
                  duration=rng.integers(1, 500_000, C),
                  remaining=rng.integers(0, 1000, C),
                  tstamp=now + rng.integers(-400_000, 400_000, C),
                  expire=now + rng.integers(-400_000, 400_000, C))
    st["expire"] = np.where(rng.random(C) < 0.1, 0, st["expire"])
    st = {k: v.astype(np.int64) for k, v in st.items()}
    st["algo"] = rng.integers(0, 7, C).astype(np.int32)
    return jk.BucketState(**st)


def per_op_window(rng, B, C, wide, n_hot=4):
    """numpy WindowBatch fields of one window: half the lanes on `n_hot`
    hot slots and on row C - 1, each hot slot with one config and one
    nonzero hit (reads mixed in) so its runs fold, a fifth of those lanes
    breaking the run (another config, algorithm or hit) so it replays;
    AGG runs, inits, pads, slots past the arena; every algorithm value
    0..6 and CONCURRENCY releases; `wide` draws configs and hits far
    outside the compact caps."""
    hot = np.append(rng.integers(0, C - 1, n_hot), C - 1)
    slot = rng.integers(0, C, B)
    on_hot = rng.random(B) < 0.5
    slot[on_hot] = hot[rng.integers(0, hot.size, int(on_hot.sum()))]
    past = rng.random(B) < 0.1
    slot[past] = C + rng.integers(0, 6, int(past.sum()))
    hi_l, hi_d = (2**40, 2**36) if wide else (900, 500_000)
    cfg_algo = rng.integers(0, 7, C + 6)
    cfg_limit = rng.integers(1, hi_l, C + 6)
    cfg_dur = rng.integers(1, hi_d, C + 6)
    hstar = np.where(cfg_algo == jk.CONCURRENCY,
                     rng.choice([-3, -1, 1, 2], C + 6),
                     rng.integers(1, 4, C + 6))
    algo = cfg_algo[slot].astype(np.int32)
    limit = cfg_limit[slot].astype(np.int64)
    duration = cfg_dur[slot].astype(np.int64)
    hits = np.where(rng.random(B) < 0.3, 0, hstar[slot]).astype(np.int64)
    brk = rng.random(B) < 0.2
    kind = rng.integers(0, 3, B)
    limit[brk & (kind == 0)] = rng.integers(1, hi_l, int((brk & (kind == 0)).sum()))
    algo[brk & (kind == 1)] = rng.integers(0, 7, int((brk & (kind == 1)).sum()))
    hits[brk & (kind == 2)] = rng.integers(1, 9, int((brk & (kind == 2)).sum()))
    if wide:
        big = rng.random(B) < 0.1
        hits[big] = rng.integers(2**28, 2**33, int(big.sum()))
    is_init = rng.random(B) < 0.05
    agg = (rng.random(B) < 0.1) & (algo <= jk.LEAKY_BUCKET) & (hits > 0)
    eslot = np.where(agg, slot | jk.AGG_SLOT_BIT, slot)
    eslot[rng.random(B) < 0.1] = jk.PAD_SLOT
    return jk.WindowBatch(slot=eslot.astype(np.int32), hits=hits,
                          limit=limit, duration=duration, algo=algo,
                          is_init=is_init)


def per_op_clock(rng, W):
    """W window times: mostly forward by up to a few minutes, a fifth of
    the steps backwards."""
    steps = rng.integers(1, 300_000, W)
    steps[rng.random(W) < 0.2] *= -1
    return T0 + np.cumsum(steps)


def _assert_window(got_st, got_out, want_st, want_out, batch, tag):
    valid = np.asarray(batch.slot) >= 0
    for name, g, w in zip(jk.WindowOutput._fields, got_out, want_out):
        g = g.numpy()
        np.testing.assert_array_equal(g[valid], np.asarray(w)[valid],
                                      err_msg=f"{tag} out.{name}")
        assert not g[~valid].any(), f"{tag} out.{name} pad lanes"
    for name, g, w in zip(jk.BucketState._fields, got_st, want_st):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{tag} state.{name}")


# ---------------------------------------------------------------------------
# global_apply (global_apply_pallas)


@pytest.mark.parametrize("kind", ["mixed_sums", "config_is_state"])
def test_global_apply_matches_oracle_and_tpu_kernel(kind):
    """tests/test_pallas.py's two GLOBAL inputs at G = 2048 (two of the TPU
    kernel's 1024-row blocks): random rows and configs with sums mixing
    zeros, small, over-ask and huge hits; and the config equal to the
    rows' own with sums 0..2."""
    rng = np.random.default_rng(11 if kind == "mixed_sums" else 12)
    G = 2048
    state = _random_state(rng, G)
    if kind == "mixed_sums":
        cfg = jk.GlobalConfig(
            limit=jnp.asarray(rng.integers(1, 100, G), jnp.int64),
            duration=jnp.asarray(rng.integers(1, 10_000, G), jnp.int64),
            algo=jnp.asarray(rng.integers(0, 2, G), jnp.int32))
        summed = jnp.asarray(rng.choice([0, 0, 1, 3, 50, 10_000], size=G),
                             jnp.int64)
        now = T0
    else:
        cfg = jk.GlobalConfig(limit=state.limit, duration=state.duration,
                              algo=state.algo)
        summed = jnp.asarray(rng.integers(0, 3, G), jnp.int64)
        now = T0 + 123
    want = jk.global_apply(state, cfg, summed, now)
    tpu = global_apply_pallas(state, cfg, summed, now, interpret=True)
    t_state = _tstate(state)
    gk.reset_counts()
    _stage_apply(t_state, tk.GlobalConfig(*[_t(a) for a in cfg]),
                 np.asarray(summed), now)
    assert gk.plain_calls == {"global_window": 0, "global_stage": 1,
                              "global_apply": 1,
        "global_stage_read": 0, "global_apply_rows": 0}
    assert gk.launches == {"global_window": 0, "global_stage": 0,
                           "global_apply": 0,
        "global_stage_read": 0, "global_apply_rows": 0}
    for name, g, w, p in zip(jk.BucketState._fields, t_state, want, tpu):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(p), err_msg=name)


_NO_LANES = {f: np.zeros(0, np.int32 if f in ("slot", "algo") else
                         bool if f == "is_init" else np.int64)
             for f in tk.WindowBatch._fields}


def _stage_apply(state, cfg, summed, now):
    """global_stage then global_apply, in place, on a control of one
    contributing lane per row carrying the arbitrary sums `summed`; the
    scratch must come back all zero."""
    scratch = torch.zeros(summed.shape[0], dtype=torch.int64)
    ctl = summed_control(_NO_LANES, summed)
    gk.global_stage(state, cfg, ctl, scratch)
    gk.global_apply(state, cfg, ctl, scratch, now)
    assert not scratch.any(), "the scratch is not back at zero"


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_global_apply_matches_oracle_on_edge_inputs(case, seed):
    """tests/test_torch_global.py's edge inputs (all five algorithms and
    out-of-range values, int64 wrapped at both ends, expired and
    never-initialized rows, algorithm switches, zero sums) at G = 64:
    global_stage then global_apply equal kernel.global_apply and, where the
    TPU kernel runs one 64-row block, global_apply_pallas."""
    algos, wrap = CASES[case]
    state, cfg, _, summed = global_inputs(np.random.default_rng(200 + seed),
                                          algos, wrap)
    js = jk.BucketState(**{k: jnp.asarray(v) for k, v in state.items()})
    jc = jk.GlobalConfig(**{k: jnp.asarray(v) for k, v in cfg.items()})
    want = jk.global_apply(js, jc, jnp.asarray(summed), T0)
    tpu = global_apply_pallas(js, jc, jnp.asarray(summed), T0, interpret=True)
    got = tk.BucketState(**{k: _t(v) for k, v in state.items()})
    _stage_apply(got, tk.GlobalConfig(**{k: _t(v) for k, v in cfg.items()}),
                 summed, T0)
    for name, g, w, p in zip(jk.BucketState._fields, got, want, tpu):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"{case} {name}")
        np.testing.assert_array_equal(g.numpy(), np.asarray(p),
                                      err_msg=f"{case} {name} (TPU kernel)")


def test_global_apply_checks_its_inputs():
    G = 8
    st = tk.BucketState.zeros(G, "cpu")
    cfg = tk.GlobalConfig.zeros(G, "cpu")
    ctl = summed_control(_NO_LANES, np.zeros(G, np.int64))
    sc = torch.zeros(G, dtype=torch.int64)
    with pytest.raises(ValueError, match="scratch"):
        gk.global_apply(st, cfg, ctl, sc.to(torch.int32), T0)
    with pytest.raises(ValueError, match="gcfg.algo"):
        gk.global_apply(st, cfg._replace(algo=torch.zeros(G, dtype=torch.int64)),
                        ctl, sc, T0)
    with pytest.raises(ValueError, match="gstate.limit"):
        gk.global_stage(st._replace(limit=torch.zeros(G + 1, dtype=torch.int64)),
                        cfg, ctl, sc)


# ---------------------------------------------------------------------------
# window_math / window_step_per_op (window_step_pallas)


@pytest.mark.parametrize("wide", [False, True], ids=["compact", "int64"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_step_per_op_matches_oracle(seed, wide):
    """Eight chained windows of 64 lanes over 32 rows, all five algorithms
    and out-of-range values, a clock that steps backwards; `int64` at full
    int64 range: window_step_per_op equals kernel.window_step window after
    window, and window_math equals kernel.window_math on the same prep at
    every valid lane."""
    rng = np.random.default_rng(400 + seed + 10 * wide)
    C, B = 32, 64
    jst = per_op_state(rng, C, T0, wide)
    tst = _tstate(jst)
    wm.reset_counts()
    for w, now in enumerate(per_op_clock(rng, 8)):
        now = int(now)
        bt = per_op_window(rng, B, C, wide)
        jst, want = _jstep(jst, _jbatch(bt), jnp.int64(now))
        prep = tk.window_prep(tst, _tbatch(bt), torch.tensor(now))
        args = (prep.s_valid, prep.s_hits, prep.s_limit, prep.s_duration,
                prep.s_algo, prep.s_init, prep.s_agg, prep.pos, prep.seg_len,
                prep.seg_start_idx, prep.seg_fold, prep.h0, prep.l0, prep.d0,
                prep.a0, prep.fresh_seg, prep.nz, prep.n_lead, prep.hstar)
        out_s, fin = wm.window_math(now, prep.max_pos, *args, prep.cur)
        w_out, w_fin = tk.window_math(
            torch.tensor(now), prep.max_pos, *args[:5], *args[6:16],
            prep.cur, *args[16:])
        v = prep.s_valid
        for g, x in zip((*out_s, *fin), (*w_out, *w_fin)):
            assert torch.equal(g[v], x[v]), f"window {w} window_math"
        tst, got = wm.window_step_per_op(tst, _tbatch(bt), now)
        _assert_window(tst, got, jst, want, bt, f"window {w}")
    assert wm.plain_calls == {"window_math": 16}
    assert wm.launches == {"window_math": 0}


@pytest.mark.parametrize("seed", [0, 1])
def test_window_step_per_op_in_place_writes_the_shard_view(seed):
    """in_place=True on views of one shard of an [S, C] arena (as the
    engine passes them): the same responses and planes as the copying
    form, the views' own planes returned, the other shard untouched."""
    rng = np.random.default_rng(480 + seed)
    C, B = 32, 64
    st = per_op_state(rng, C, T0, wide=bool(seed))
    arena = tk.BucketState(*[torch.stack([_t(a), _t(a)]) for a in st])
    other = [p[0].clone() for p in arena]
    copy_st = _tstate(st)
    for now in per_op_clock(rng, 4):
        bt = per_op_window(rng, B, C, wide=bool(seed))
        view = tk.BucketState(*[p[1] for p in arena])
        new_st, got = wm.window_step_per_op(view, _tbatch(bt), int(now),
                                            in_place=True)
        before = [p.clone() for p in copy_st]
        old_st, (copy_st, want) = copy_st, wm.window_step_per_op(
            copy_st, _tbatch(bt), int(now))
        assert all(a is b for a, b in zip(new_st, view))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        for p, w in zip(arena, copy_st):
            assert torch.equal(p[1], w)
        for p, w in zip(arena, other):
            assert torch.equal(p[0], w)
        # the copying form leaves its input as it was; the window wrote
        for b, p in zip(before, old_st):
            assert torch.equal(b, p)
        assert any(not torch.equal(b, p) for b, p in zip(before, copy_st))


@pytest.mark.parametrize("seed", [0, 1])
def test_window_step_per_op_matches_compact32_tpu_kernel(seed):
    """tests/test_pallas.py's compact-range traffic (hot duplicates,
    recycling inits, zero reads, expiry crossings, a fifth of the lanes at
    the compact caps) with a monotonic clock: window_step_per_op equals
    window_step_pallas(interpret=True, compact32=True) and the oracle."""
    rng = np.random.default_rng(90 + seed)
    B, C = 64, 32
    jst = jk.BucketState.zeros(C)
    pst = jk.BucketState.zeros(C)
    tst = tk.BucketState.zeros(C, "cpu")
    big_l = int(jk.COMPACT_MAX_LIMIT - 1)
    big_d = int(jk.COMPACT_MAX_DURATION - 1)
    big_h = int(jk.COMPACT_MAX_HITS - 1)
    now = T0
    for w in range(5):
        now += int(rng.integers(1, 400))
        bt = _random_window(rng, B, C)
        capped = rng.random(B) < 0.2
        bt = jk.WindowBatch(
            slot=bt.slot,
            hits=jnp.where(jnp.asarray(rng.random(B) < 0.1),
                           jnp.int64(big_h), bt.hits),
            limit=jnp.where(jnp.asarray(capped), jnp.int64(big_l), bt.limit),
            duration=jnp.where(jnp.asarray(capped), jnp.int64(big_d),
                               bt.duration),
            algo=bt.algo, is_init=bt.is_init)
        jst, want = _jstep(jst, bt, jnp.int64(now))
        pst, tpu = window_step_pallas(pst, bt, now, interpret=True,
                                      compact32=True)
        tst, got = wm.window_step_per_op(tst, _tbatch(bt), now)
        _assert_window(tst, got, jst, want, bt, f"oracle window {w}")
        _assert_window(tst, got, pst, tpu, bt, f"TPU kernel window {w}")


def test_compact32_tpu_kernel_parts_from_oracle_on_a_backwards_clock():
    """A fact of the reference (ROADMAP Queue 3): the rebased-int32 TPU
    kernel is exact only on a monotonic clock (its docstring says so).  A
    token row written at now + d (d near the compact duration cap) and
    read after the clock steps back by more than 2^31 - 16 - d sits
    outside the rebase range; the kernel clips its reset time and answers
    another reset_time than kernel.window_step.  The port's per-op step,
    int64 like the oracle, follows the oracle."""
    C = 4
    d = int(jk.COMPACT_MAX_DURATION - 1)
    jst = jk.BucketState.zeros(C)
    pst = jk.BucketState.zeros(C)
    tst = tk.BucketState.zeros(C, "cpu")
    one = lambda hits: jk.WindowBatch(  # noqa: E731
        slot=jnp.asarray([0], jnp.int32), hits=jnp.asarray([hits], jnp.int64),
        limit=jnp.asarray([5], jnp.int64), duration=jnp.asarray([d], jnp.int64),
        algo=jnp.asarray([0], jnp.int32), is_init=jnp.asarray([False]))
    diverged = False
    for now, hits in ((T0, 1), (T0 - 2**30, 1)):
        jst, want = _jstep(jst, one(hits), jnp.int64(now))
        pst, tpu = window_step_pallas(pst, one(hits), now, interpret=True,
                                      compact32=True)
        tst, got = wm.window_step_per_op(tst, _tbatch(one(hits)), now)
        _assert_window(tst, got, jst, want, one(hits), f"now {now}")
        diverged |= any(int(np.asarray(a)[0]) != int(np.asarray(b)[0])
                        for a, b in zip(want, tpu))
    assert diverged, "the compact32 kernel followed the oracle"


def test_window_math_answers_0_at_invalid_lanes():
    """Pad lanes (and whatever the prep left there) answer 0 in every
    response field and keep their gathered register as fin; valid lanes
    equal kernel.window_math."""
    rng = np.random.default_rng(77)
    C, B = 16, 48
    st = _tstate(per_op_state(rng, C, T0, False))
    p = tk.window_prep(st, _tbatch(per_op_window(rng, B, C, False)),
                       torch.tensor(T0))
    args = [p.s_valid, p.s_hits, p.s_limit, p.s_duration, p.s_algo, p.s_init,
            p.s_agg, p.pos, p.seg_len, p.seg_start_idx, p.seg_fold, p.h0,
            p.l0, p.d0, p.a0, p.fresh_seg, p.nz, p.n_lead, p.hstar]
    out, fin = wm.window_math(T0, p.max_pos, *args, p.cur)
    w_out, w_fin = tk.window_math(torch.tensor(T0), p.max_pos, *args[:5],
                                  *args[6:16], p.cur, *args[16:])
    inv = ~p.s_valid
    assert inv.any() and p.s_valid.any()
    for o, w in zip(out, w_out):
        assert not o[inv].any()
        assert torch.equal(o[p.s_valid], w[p.s_valid])
    for f, w, r in zip(fin, w_fin, p.cur):
        assert torch.equal(f[inv], r[inv])
        assert torch.equal(f[p.s_valid], w[p.s_valid])


def test_window_math_checks_its_inputs():
    st = tk.BucketState.zeros(8, "cpu")
    bt = _tbatch(per_op_window(np.random.default_rng(3), 8, 8, False))
    p = tk.window_prep(st, bt, torch.tensor(T0))
    args = [p.s_valid, p.s_hits, p.s_limit, p.s_duration, p.s_algo, p.s_init,
            p.s_agg, p.pos, p.seg_len, p.seg_start_idx, p.seg_fold, p.h0,
            p.l0, p.d0, p.a0, p.fresh_seg, p.nz, p.n_lead, p.hstar]
    bad = list(args)
    bad[7] = p.pos.to(torch.int64)
    with pytest.raises(ValueError, match="pos"):
        wm.window_math(T0, p.max_pos, *bad, p.cur)
    bad = list(args)
    bad[1] = p.s_hits[:-1]
    with pytest.raises(ValueError, match="s_hits"):
        wm.window_math(T0, p.max_pos, *bad, p.cur)
    with pytest.raises(ValueError, match="reg.algo"):
        wm.window_math(T0, p.max_pos, *args,
                       p.cur._replace(algo=p.cur.algo.to(torch.int64)))
    with pytest.raises(ValueError, match="s_valid"):
        wm.window_math(T0, p.max_pos, *[a[None] for a in args],
                       tk._Reg(*[r[None] for r in p.cur]))
