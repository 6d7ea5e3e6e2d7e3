"""The port's window math (gubernator_tpu_torch/ops/kernel.py) against the
JAX package's int64 oracle (gubernator_tpu/ops/kernel.py), bit for bit.

The same numpy-seeded inputs go through both: the adversarial segment
windows of tests/test_fold_fuzz.py (hot runs, hstar violations, config and
algorithm flips, AGG lanes inside runs, recycle inits, leaky-invariant
violations), the per-algorithm streams of tests/test_algorithms.py, int64
values far outside the compact caps, and the compact wire at its caps.
Every quantity is an integer, so the tolerance is exact equality: every
valid lane of every response field and every plane of the arena.
"""

import numpy as np
import pytest
import torch

import gubernator_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from gubernator_tpu.ops import kernel as jk
from gubernator_tpu_torch.ops import kernel as tk

from .test_algorithms import _stream
from .test_fold_fuzz import T0, _adversarial_batch, _adversarial_state
from .test_fused_megakernel import _random_packed

pytestmark = pytest.mark.torch_port

_jstep = jax.jit(jk.window_step)


def _t(nt, cls):
    return cls(*[torch.from_numpy(np.array(a)) for a in nt])


def _run_both(st0, windows, tag):
    """Chain (batch, now) windows through both oracles from one arena and
    assert every valid response lane and every arena plane agree."""
    jst = jk.BucketState(*[jnp.asarray(np.asarray(a)) for a in st0])
    tst = _t(st0, tk.BucketState)
    for w, (batch, now) in enumerate(windows):
        jst, jout = _jstep(jst, batch, jnp.int64(now))
        tst, tout = tk.window_step(tst, _t(batch, tk.WindowBatch), now)
        valid = np.asarray(batch.slot) >= 0
        for f in jk.WindowOutput._fields:
            np.testing.assert_array_equal(
                getattr(tout, f).numpy()[valid],
                np.asarray(getattr(jout, f))[valid],
                err_msg=f"{tag} window {w} out.{f}")
        for f, a, b in zip(jk.BucketState._fields, tst, jst):
            np.testing.assert_array_equal(
                a.numpy(), np.asarray(b), err_msg=f"{tag} window {w} state.{f}")


@pytest.mark.parametrize("seed", list(range(12)))
def test_window_step_fold_fuzz_matches_jax(seed):
    B, C = 32, 24
    rng = np.random.default_rng(7000 + seed)
    now = T0
    st0 = _adversarial_state(rng, C, now)
    windows = []
    for _ in range(4):
        now += int(rng.integers(1, 300_000))
        windows.append((_adversarial_batch(rng, B, C), now))
    _run_both(st0, windows, f"seed {seed}")


@pytest.mark.parametrize("seed", list(range(8)))
def test_window_step_all_algorithms_matches_jax(seed):
    B, C = 32, 24
    rng = np.random.default_rng(11_000 + seed)
    now = T0
    st0 = _adversarial_state(rng, C, now, algo_hi=5)
    windows = []
    for _ in range(4):
        now += int(rng.integers(1, 300_000))
        windows.append((_adversarial_batch(rng, B, C, algo_hi=5), now))
    _run_both(st0, windows, f"algos seed {seed}")


@pytest.mark.parametrize("algo", [0, 1, 2, 3, 4, 9])
def test_window_step_per_algorithm_streams_match_jax(algo):
    """test_algorithms.py's per-algorithm streams (reads, partial, drain,
    over-ask, releases; dts in-window and past expiry); algo 9 is outside
    the wire alphabet and must serve as token bucket in both."""
    for seed in range(3):
        windows = _stream(0 if algo == 9 else algo, 1000 * algo + seed)
        if algo == 9:
            windows = [(b._replace(algo=np.full_like(b.algo, 9)), now)
                       for b, now in windows]
        C = windows[0][0].slot.shape[0]
        _run_both(jk.BucketState.zeros(C), windows, f"algo {algo} s{seed}")


def test_window_step_int64_beyond_compact_caps_matches_jax():
    """Full-width int64 configs the compact wire cannot carry: limits and
    durations past 2^31, hits past 2^28, negative hits off concurrency."""
    rng = np.random.default_rng(77)
    B, C = 32, 16
    now = T0
    st0 = _adversarial_state(rng, C, now, algo_hi=5)
    windows = []
    for _ in range(4):
        now += int(rng.integers(1, 10**9))
        b = _adversarial_batch(rng, B, C, algo_hi=5)
        big = rng.random(B) < 0.4
        limit = np.where(big, rng.integers(2**31, 2**45, B), b.limit)
        duration = np.where(big, rng.integers(2**31, 2**40, B), b.duration)
        hits = np.where(rng.random(B) < 0.2, rng.integers(-5, 2**33, B),
                        b.hits)
        windows.append((b._replace(limit=limit.astype(np.int64),
                                   duration=duration.astype(np.int64),
                                   hits=hits.astype(np.int64)), now))
    _run_both(st0, windows, "int64 caps")


@pytest.mark.parametrize("seed", list(range(4)))
def test_compact_wire_matches_jax(seed):
    """decode_batch -> window_step -> encode_output_word on compact windows
    with cap-edge configs (hits 2^28-1, limit 2^31-1, duration 2^31-17),
    AGG lanes, recycle inits and pads; plus the host encode/decode."""
    rng = np.random.default_rng(300 + seed)
    B, C = 64, 128
    jst = jk.BucketState.zeros(C)
    tst = tk.BucketState.zeros(C, device="cpu")
    now = T0
    for w in range(4):
        now += int(rng.integers(1, 400_000))
        packed = np.array(_random_packed(rng, B, C, cap_edges=(w % 2 == 1)))
        jb = jk.decode_batch(jnp.asarray(packed))
        tb = tk.decode_batch(torch.from_numpy(packed))
        for f, a, b in zip(jk.WindowBatch._fields, tb, jb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"w{w} decode {f}")
        np.testing.assert_array_equal(
            tk.encode_batch_host(*[a.numpy() for a in tb]),
            np.asarray(jk.encode_batch_host(*[np.asarray(a) for a in jb])))
        jst, jout = _jstep(jst, jb, jnp.int64(now))
        tst, tout = tk.window_step(tst, tb, now)
        jwire = np.asarray(jk.encode_output_compact(jout, jnp.int64(now)))
        twire = tk.encode_output_compact(tout, now).numpy()
        valid = np.asarray(jb.slot) >= 0
        np.testing.assert_array_equal(twire[valid], jwire[valid],
                                      err_msg=f"w{w} response wire")
        for f, a, b in zip(jk.WindowOutput._fields,
                           tk.decode_output_host(twire, now),
                           jk.decode_output_host(jwire, now)):
            np.testing.assert_array_equal(a[valid], b[valid],
                                          err_msg=f"w{w} decode_output {f}")
        for f, a, b in zip(jk.BucketState._fields, tst, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"w{w} state.{f}")


def test_transition_precompute_matches_jax():
    rng = np.random.default_rng(5)
    dur = rng.integers(0, 2**40, 64)
    ts = T0 + rng.integers(-2**35, 2**35, 64)
    lim = rng.integers(-3, 2**33, 64)
    for a, b in zip(
            tk.transition_precompute(*[torch.from_numpy(x)
                                       for x in (dur, ts, lim)],
                                     torch.tensor(T0)),
            jk.transition_precompute(*[jnp.asarray(x) for x in (dur, ts, lim)],
                                     jnp.int64(T0))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
