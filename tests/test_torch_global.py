"""The port's GLOBAL math (gubernator_tpu_torch/ops/kernel.py global_*) and
its kernel wrapper (ops/global_kernel.py global_window) on CPU tensors
against the JAX package's int64 oracle and its GLOBAL TPU kernel.

The same numpy-seeded inputs go through:

  * `gubernator_tpu.ops.kernel.global_read / global_accumulate /
    global_apply / global_combined` - the int64 oracle the port follows,
    on all five algorithms plus out-of-range values, int64 values that
    wrap at both ends, expired and never-initialized rows, algorithm
    switches, is_init lanes, rows whose summed hits are 0, and pad and
    out-of-range slots;
  * `gubernator_tpu.ops.pallas_kernel.global_combined_staged(
    interpret=True)` - the TPU kernel this port's CUDA kernel replaces.  It
    carries only the token and leaky ladders, so it is held against the
    port on token and leaky inputs, and a separate test pins that it
    parts from the oracle on GCRA, sliding-window and concurrency rows,
    where the port follows the oracle.

The wrapper takes a window's packed control rather than per-slot sums: an
arbitrary `summed` travels as one contributing lane per row beside the
read lanes (`summed_control`).  Tolerance: exact equality (every quantity
is an integer).  Pad read lanes answer 0 from the wrapper; the oracle
leaves the transition of row 0 there.
"""

import numpy as np
import pytest
import torch

import gubernator_tpu  # noqa: F401  (enables x64)
import jax.numpy as jnp

from gubernator_tpu.ops import kernel as jk
from gubernator_tpu.ops import pallas_kernel as pk
from gubernator_tpu_torch.ops import global_kernel as gk
from gubernator_tpu_torch.ops import kernel as tk

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000
I64_MAX = 2**63 - 1
I64_MIN = -2**63
G, N = 64, 16

# name -> (algorithms drawn, wrap int64 extremes into every field)
CASES = {
    "all_algorithms": (tuple(range(7)), False),
    "token_leaky": ((0, 1), False),
    "wrapped_i64": (tuple(range(7)), True),
    "wrapped_token_leaky": ((0, 1), True),
}


def global_inputs(rng, algos, wrap, G=G, n=N, now=T0):
    """numpy (state, cfg, batch, summed): a GLOBAL arena with about a tenth
    of its rows never initialized and half expired, configs that mostly
    agree with the rows and sometimes switch algorithm, read lanes with
    pads (< 0), out-of-range slots (>= G), hot slots and is_init, and
    summed hits that are 0 on ~40% of the rows.  `wrap` swaps a quarter of
    every int64 field for values at or near both ends of the range."""
    algos = np.asarray(algos, np.int32)
    pick = lambda size: rng.choice(algos, size).astype(np.int32)  # noqa: E731
    limit = rng.integers(0, 200, G)
    s_algo = pick(G)
    state = dict(
        limit=limit, duration=rng.integers(0, 120_000, G),
        remaining=rng.integers(-3, 1 << 20, G),
        tstamp=now + rng.integers(-120_000, 120_000, G),
        expire=np.where(rng.random(G) < 0.1, 0,
                        now + rng.integers(-120_000, 120_000, G)),
        algo=s_algo)
    keep = rng.random(G) < 0.7
    cfg = dict(limit=np.where(keep, limit, rng.integers(0, 200, G)),
               duration=np.where(keep, state["duration"],
                                 rng.integers(0, 120_000, G)),
               algo=np.where(rng.random(G) < 0.7, s_algo,
                             pick(G)).astype(np.int32))
    slot = rng.integers(-2, G + 3, n)
    hot = rng.random(n) < 0.4
    slot[hot] = rng.integers(0, 3, int(hot.sum()))
    slot[:2] = (-1, G)  # always one pad and one out-of-range lane
    row_algo = s_algo[np.clip(slot, 0, G - 1)]
    batch = dict(
        slot=slot.astype(np.int32),
        hits=rng.choice([0, 0, 1, 2, 5, -1, -3], n).astype(np.int64),
        limit=rng.integers(0, 200, n), duration=rng.integers(0, 120_000, n),
        algo=np.where(rng.random(n) < 0.7, row_algo, pick(n)).astype(np.int32),
        is_init=rng.random(n) < 0.15)
    summed = np.where(rng.random(G) < 0.4, 0, rng.integers(-5, 20, G))
    if wrap:
        ends = np.asarray([I64_MAX, I64_MAX - 1, I64_MIN, I64_MIN + 1,
                           2**62, -2**62, 2**32 + 7], np.int64)
        for d, names in ((state, ("limit", "duration", "remaining", "tstamp",
                                  "expire")),
                         (cfg, ("limit", "duration")),
                         (batch, ("hits", "limit", "duration"))):
            for k in names:
                m = rng.random(d[k].shape[0]) < 0.25
                d[k] = np.where(m, rng.choice(ends, d[k].shape[0]), d[k])
        m = rng.random(G) < 0.25
        summed = np.where(m, rng.choice(ends, G), summed)
    i64 = lambda d: {k: (v if v.dtype in (np.int32, bool)  # noqa: E731
                         else v.astype(np.int64)) for k, v in d.items()}
    return (i64(state), i64(cfg), i64(batch), summed.astype(np.int64))


def _jax(state, cfg, batch):
    return (jk.BucketState(**{k: jnp.asarray(v) for k, v in state.items()}),
            jk.GlobalConfig(**{k: jnp.asarray(v) for k, v in cfg.items()}),
            jk.WindowBatch(**{k: jnp.asarray(v) for k, v in batch.items()}))


def _torch(state, cfg, batch):
    return (tk.BucketState(**{k: torch.from_numpy(v.copy())
                              for k, v in state.items()}),
            tk.GlobalConfig(**{k: torch.from_numpy(v.copy())
                               for k, v in cfg.items()}),
            tk.WindowBatch(**{k: torch.from_numpy(v.copy())
                              for k, v in batch.items()}))


def _eq(got, want, tag):
    for f, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{tag}.{f}")


@pytest.mark.parametrize("case", list(CASES))
def test_global_read_matches_jax_oracle(case):
    algos, wrap = CASES[case]
    state, cfg, batch, _ = global_inputs(np.random.default_rng(1), algos, wrap)
    js, _, jb = _jax(state, cfg, batch)
    ts, _, tb = _torch(state, cfg, batch)
    want = jk.global_read(js, jb, jnp.int64(T0))
    _eq(tk.global_read(ts, tb, T0), want, f"{case} read")


@pytest.mark.parametrize("case", list(CASES))
def test_global_apply_matches_jax_oracle(case):
    algos, wrap = CASES[case]
    state, cfg, batch, summed = global_inputs(np.random.default_rng(2), algos,
                                              wrap)
    js, jc, _ = _jax(state, cfg, batch)
    ts, tc, _ = _torch(state, cfg, batch)
    want = jk.global_apply(js, jc, jnp.asarray(summed), jnp.int64(T0))
    _eq(tk.global_apply(ts, tc, torch.from_numpy(summed), T0), want,
        f"{case} apply")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_global_combined_matches_jax_oracle(case, seed):
    algos, wrap = CASES[case]
    state, cfg, batch, summed = global_inputs(
        np.random.default_rng(100 + seed), algos, wrap)
    js, jc, jb = _jax(state, cfg, batch)
    ts, tc, tb = _torch(state, cfg, batch)
    w_state, w_out = jk.global_combined(js, jc, jb, jnp.asarray(summed),
                                        jnp.int64(T0))
    g_state, g_out = tk.global_combined(ts, tc, tb, torch.from_numpy(summed),
                                        T0)
    _eq(g_state, w_state, f"{case} state")
    _eq(g_out, w_out, f"{case} read")
    # the combined pass is read-then-apply, as two separate calls
    _eq(g_state, tk.global_apply(ts, tc, torch.from_numpy(summed), T0),
        f"{case} vs apply")
    _eq(g_out, tk.global_read(ts, tb, T0), f"{case} vs read")


def test_global_accumulate_drops_pads_and_out_of_range_slots():
    rng = np.random.default_rng(5)
    _, _, batch, _ = global_inputs(rng, (0, 1), False, n=64)
    delta = rng.integers(-4, 4, G)
    want = jk.global_accumulate(jnp.asarray(delta),
                                jk.WindowBatch(**{k: jnp.asarray(v)
                                                  for k, v in batch.items()}))
    got = tk.global_accumulate(
        torch.from_numpy(delta),
        tk.WindowBatch(**{k: torch.from_numpy(v) for k, v in batch.items()}))
    assert ((batch["slot"] < 0) | (batch["slot"] >= G)).any()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def summed_control(batch, summed):
    """A window's packed control (ops/global_kernel.py) that reads `batch`
    and applies the arbitrary per-slot sums `summed`: the n read lanes
    contribute nothing, then one contributing lane per row j with gacc =
    summed[j]; no config writes (one pad lane each)."""
    G = summed.shape[0]
    rows = dict(slot=np.arange(G, dtype=np.int32), hits=np.zeros(G, np.int64),
                limit=np.zeros(G, np.int64), duration=np.zeros(G, np.int64),
                algo=np.zeros(G, np.int32), is_init=np.zeros(G, bool))
    lanes = tk.WindowBatch(*[np.concatenate([batch[f], rows[f]])
                             for f in tk.WindowBatch._fields])
    gacc = np.concatenate([np.zeros(batch["slot"].shape[0], np.int64),
                           summed])
    upd = (np.full(1, G, np.int32), np.zeros(1, np.int64),
           np.zeros(1, np.int64), np.zeros(1, np.int32),
           np.full(1, G, np.int32))
    return gk.make_control(lanes, gacc, upd, "cpu")


@pytest.mark.parametrize("case", ["all_algorithms", "wrapped_i64"])
def test_wrapper_runs_plain_on_cpu_and_zeroes_pads(case):
    """global_kernel.global_window on CPU tensors: the plain version
    (counted, no launch), the arena updated in place to the oracle's, the
    read block [n, 4] = (status, limit, remaining, reset) equal to the
    oracle's on valid lanes and 0 on pads, and the scratch left zero."""
    algos, wrap = CASES[case]
    state, cfg, batch, summed = global_inputs(np.random.default_rng(7),
                                              algos, wrap)
    js, jc, jb = _jax(state, cfg, batch)
    ts, tc, tb = _torch(state, cfg, batch)
    w_state, w_out = jk.global_combined(js, jc, jb, jnp.asarray(summed),
                                        jnp.int64(T0))
    scratch = torch.zeros(G, dtype=torch.int64)
    gk.reset_counts()
    read = gk.global_window(ts, tc, summed_control(batch, summed), scratch,
                            T0)
    assert gk.launches == {"global_window": 0, "global_stage": 0,
                           "global_apply": 0,
        "global_stage_read": 0, "global_apply_rows": 0}
    assert gk.plain_calls == {"global_window": 1, "global_stage": 0,
                              "global_apply": 0,
        "global_stage_read": 0, "global_apply_rows": 0}
    _eq(ts, w_state, f"{case} state")  # in place
    _eq(tc, jc, f"{case} cfg")
    assert not scratch.any()
    n = batch["slot"].shape[0]
    read = read.numpy()[:n]
    valid = batch["slot"] >= 0
    want = np.stack([np.asarray(w_out.status).astype(np.int64),
                     np.asarray(w_out.limit), np.asarray(w_out.remaining),
                     np.asarray(w_out.reset_time)], axis=-1)
    np.testing.assert_array_equal(read[valid], want[valid])
    assert not read[~valid].any()


def test_wrapper_rejects_malformed_inputs():
    state, cfg, batch, summed = global_inputs(np.random.default_rng(8),
                                              (0, 1), False)
    ts, tc, _ = _torch(state, cfg, batch)
    ctl = summed_control(batch, summed)
    sc = torch.zeros(G, dtype=torch.int64)
    with pytest.raises(ValueError, match="scratch"):
        gk.global_window(ts, tc, ctl, sc.to(torch.int32), T0)
    with pytest.raises(ValueError, match="gstate.algo"):
        gk.global_window(ts._replace(algo=ts.limit), tc, ctl, sc, T0)
    with pytest.raises(ValueError, match="gcfg.limit"):
        gk.global_window(ts, tc._replace(limit=tc.limit[:-1]), ctl, sc, T0)
    with pytest.raises(ValueError, match="control.block"):
        gk.global_window(ts, tc, ctl._replace(kg=ctl.kg + 1), sc, T0)
    with pytest.raises(ValueError, match="scratch"):
        gk.global_window(ts, tc, ctl, sc[None], T0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gk.global_window(*[type(x)(*[t.to("meta") for t in x])
                           for x in (ts, tc)],
                         ctl._replace(block=ctl.block.to("meta")),
                         sc.to("meta"), T0)


def _staged(state, cfg, batch, summed):
    js, jc, jb = _jax(state, cfg, batch)
    return pk.global_combined_staged(js, jc, jb, jnp.asarray(summed),
                                     jnp.int64(T0), interpret=True)


@pytest.mark.parametrize("case", ["token_leaky", "wrapped_token_leaky"])
def test_staged_tpu_kernel_matches_port_on_token_leaky(case):
    """The TPU kernel global_combined_staged in interpret mode against the
    port on token and leaky rows and lanes: every plane, every valid
    lane."""
    algos, wrap = CASES[case]
    state, cfg, batch, summed = global_inputs(np.random.default_rng(11),
                                              algos, wrap)
    s_state, s_out = _staged(state, cfg, batch, summed)
    new, tc, _ = _torch(state, cfg, batch)
    read = gk.global_window(new, tc, summed_control(batch, summed),
                            torch.zeros(G, dtype=torch.int64), T0)
    _eq(new, s_state, f"{case} state")
    read = read[:batch["slot"].shape[0]]
    valid = batch["slot"] >= 0
    for i, f in enumerate(s_out._fields):
        np.testing.assert_array_equal(
            read.numpy()[valid, i], np.asarray(s_out[i]).astype(np.int64)[valid],
            err_msg=f"{case} read.{f}")


@pytest.mark.parametrize("algo", [2, 3, 4])
def test_staged_tpu_kernel_parts_from_oracle_off_token_leaky(algo):
    """A fact of the reference, pinned: on GCRA (2), sliding-window (3) and
    concurrency (4) rows the TPU kernel global_combined_staged does not
    compute kernel.global_combined (it carries only the token and leaky
    ladders; the JAX service refuses GLOBAL on those algorithms).  The
    port follows the oracle there."""
    state, cfg, batch, summed = global_inputs(np.random.default_rng(12),
                                              (algo,), False)
    js, jc, jb = _jax(state, cfg, batch)
    w_state, w_out = jk.global_combined(js, jc, jb, jnp.asarray(summed),
                                        jnp.int64(T0))
    s_state, s_out = _staged(state, cfg, batch, summed)
    valid = batch["slot"] >= 0
    same = (all(np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(s_state, w_state))
            and all(np.array_equal(np.asarray(a)[valid], np.asarray(b)[valid])
                    for a, b in zip(s_out, w_out)))
    assert not same, f"algorithm {algo}: the staged kernel now matches"
    g_state, g_out = tk.global_combined(*_torch(state, cfg, batch),
                                        torch.from_numpy(summed), T0)
    _eq(g_state, w_state, f"algo {algo} state")
    _eq(g_out, w_out, f"algo {algo} read")
