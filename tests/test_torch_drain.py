"""The window-drain wrappers (gubernator_tpu_torch/ops/drain_kernel.py) on
CPU tensors against the JAX package's TPU kernels and its int64 oracle.

The wrappers take an arena of S shards ([S, C] planes) and windows of
[K, S, B] lanes; the JAX kernels drain one shard.  Single-shard cases run
at S = 1; the S > 1 cases hold each shard of one drain against that
shard's own reference drain.

On the CPU the wrappers run the kernel's plain version; the CUDA kernel
itself is held against that same plain version on the card by
chip_smoke.py.  References, on the same numpy-seeded inputs:

  * `window_drain_fused_planes(..., interpret=True)` - the K-window drain
    kernel (K=4), and `window_step_fused(..., interpret=True)` - its K=1
    form, run the way tests/test_fused_megakernel.py runs them;
  * decode_batch -> kernel.window_step -> encode_output_word, the host
    oracle those kernels are pinned to, for more seeds at low cost;
  * kernel.window_step on decoded int64 columns for `window_full`.

Compared exactly: every valid lane's word and limit, the mismatch flags,
every arena plane.  Pad lanes must come back 0 from the port (the JAX
kernels leave a gather of row C-1 there, which the engine never reads).
"""

import numpy as np
import pytest
import torch

import gubernator_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from gubernator_tpu.ops import kernel as jk
from gubernator_tpu.ops import pallas_kernel as pk
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.ops import drain_kernel as dk
from gubernator_tpu_torch.ops import kernel as tk

from .test_fold_fuzz import T0, _adversarial_batch, _adversarial_state
from .test_fused_megakernel import _random_packed, _random_state

pytestmark = pytest.mark.torch_port

_jstep = jax.jit(jk.window_step)


def _arena(*states):
    """The port's [S, C] arena from S per-shard states."""
    return tk.BucketState(*[torch.from_numpy(np.stack([np.array(a) for a in p]))
                            for p in zip(*states)])


def _drain1(arena, packed, nows):
    """drain_compact at S = 1: [K, B, 2] in, [K, B] / [K] out."""
    words, limits, mism = dk.drain_compact(
        arena, torch.from_numpy(np.ascontiguousarray(packed[:, None])),
        torch.from_numpy(np.asarray(nows)))
    return words[:, 0], limits[:, 0], mism[:, 0]


def _adversarial_drain(rng, K, B, C, algo_hi):
    st0 = _adversarial_state(rng, C, T0, algo_hi)
    now, nows, packs = T0, [], []
    for _ in range(K):
        now += int(rng.integers(1, 300_000))
        bt = _adversarial_batch(rng, B, C, algo_hi)
        nows.append(now)
        packs.append(np.asarray(jk.encode_batch_host(
            *[np.asarray(a) for a in bt])))
    return st0, np.stack(packs), np.asarray(nows, np.int64)


def _host_oracle(st0, packed, nows):
    """decode -> int64 oracle -> encode per window (JAX package)."""
    st = jk.BucketState(*[jnp.asarray(np.asarray(a)) for a in st0])
    words, limits, mism = [], [], []
    for k in range(packed.shape[0]):
        nj = jnp.int64(nows[k])
        bt = jk.decode_batch(jnp.asarray(packed[k]))
        st, out = _jstep(st, bt, nj)
        valid = np.asarray(bt.slot) >= 0
        words.append(np.asarray(jk.encode_output_word(out, nj)))
        limits.append(np.asarray(out.limit))
        mism.append(bool(np.any((np.asarray(out.limit)
                                 != np.asarray(bt.limit)) & valid)))
    return st, np.stack(words), np.stack(limits), np.asarray(mism)


def _assert_drain(arena, got, want_st, want_words, want_limits, want_mism,
                  packed, tag, shard=0):
    words, limits, mism = [t.numpy() for t in got]
    valid = (packed[..., 0] & 0xFFFFFFFF) != 0
    np.testing.assert_array_equal(words[valid], np.asarray(want_words)[valid],
                                  err_msg=f"{tag} words")
    np.testing.assert_array_equal(limits[valid],
                                  np.asarray(want_limits)[valid],
                                  err_msg=f"{tag} limits")
    assert not words[~valid].any() and not limits[~valid].any(), \
        f"{tag} pad lanes must answer 0"
    np.testing.assert_array_equal(mism, np.asarray(want_mism),
                                  err_msg=f"{tag} mism")
    for f, a, b in zip(jk.BucketState._fields, arena, want_st):
        np.testing.assert_array_equal(a.numpy()[shard], np.asarray(b),
                                      err_msg=f"{tag} state.{f}")


@pytest.mark.parametrize("seed", [0, 1])
def test_drain_compact_matches_jax_drain_kernel(seed):
    """K=4 drain vs the JAX K-grid drain kernel in interpret mode, on the
    fold fuzz's adversarial windows over all five algorithms."""
    K, B, C = 4, 32, 24
    st0, packed, nows = _adversarial_drain(
        np.random.default_rng(10_000 + seed), K, B, C, algo_hi=5)
    new32, jwords, jlimits, jmism, _ = pk.window_drain_fused_planes(
        pk.fused_state_to_planes(st0), jnp.asarray(packed),
        jnp.asarray(nows), interpret=True)
    arena = _arena(st0)
    got = _drain1(arena, packed, nows)
    _assert_drain(arena, got, pk.fused_state_from_planes(new32), jwords,
                  jlimits, jmism, packed, f"seed {seed}")


def test_drain_compact_k1_matches_jax_window_kernel():
    """K=1 drains chained over two windows vs window_step_fused (the
    single-window TPU kernel) in interpret mode."""
    rng = np.random.default_rng(300)
    B, C = 32, 64
    st = _random_state(rng, C, T0)
    arena = _arena(st)
    now = T0
    for w in range(2):
        now += int(rng.integers(1, 400_000))
        packed = np.array(_random_packed(rng, B, C, cap_edges=(w == 1)))
        st, jwords, jlimits, jmism = pk.window_step_fused(
            st, jnp.asarray(packed), jnp.int64(now), interpret=True)
        got = _drain1(arena, packed[None], np.asarray([now]))
        _assert_drain(arena, got, st, np.asarray(jwords)[None],
                      np.asarray(jlimits)[None],
                      np.asarray([bool(jmism)]), packed[None], f"w{w}")


def _shaped_windows():
    """The shapes of tests/test_fused_megakernel.py: recycle inside a run,
    AGG folds (alone and inside a run), all-init Zipf."""
    B = 16
    slot = np.full(B, jk.PAD_SLOT, np.int32)
    hits = np.zeros(B, np.int64)
    limit = np.full(B, 10, np.int64)
    duration = np.full(B, 60_000, np.int64)
    algo = np.zeros(B, np.int32)
    is_init = np.zeros(B, bool)
    recycle_slot, recycle_hits, recycle_init = slot.copy(), hits.copy(), \
        is_init.copy()
    recycle_slot[0:6], recycle_hits[0:6], recycle_init[3] = 3, 1, True
    recycle_limit = limit.copy()
    recycle_limit[3:6] = 7
    fold_slot, fold_hits = slot.copy(), hits.copy()
    fold_slot[0], fold_hits[0] = 2 | jk.AGG_SLOT_BIT, 37
    fold_slot[1:4], fold_hits[1:4] = (5, 5 | jk.AGG_SLOT_BIT, 5), (1, 12, 1)
    rng = np.random.default_rng(7)
    zipf = np.minimum(rng.zipf(1.5, B) - 1, 7).astype(np.int32)
    enc = jk.encode_batch_host
    return np.stack([
        np.asarray(enc(recycle_slot, recycle_hits, recycle_limit, duration,
                       algo, recycle_init)),
        np.asarray(enc(fold_slot, fold_hits, np.full(B, 100, np.int64),
                       duration, algo, is_init)),
        np.asarray(enc(zipf, np.ones(B, np.int64), np.full(B, 50, np.int64),
                       np.full(B, 30_000, np.int64),
                       rng.integers(0, 2, B).astype(np.int32),
                       np.ones(B, bool))),
    ])


@pytest.mark.parametrize("case", ["fuzz_token_leaky", "fuzz_all_algorithms",
                                  "shapes"])
def test_drain_compact_matches_host_oracle(case):
    """More windows against the host path the TPU kernels are pinned to."""
    if case == "shapes":
        packed = _shaped_windows()
        st0 = _random_state(np.random.default_rng(6), 8, T0)
        nows = np.asarray([T0 + 50, T0 + 59, T0 + 182], np.int64)
    else:
        algo_hi = 2 if case == "fuzz_token_leaky" else 5
        st0, packed, nows = _adversarial_drain(
            np.random.default_rng(9000 + algo_hi), 4, 32, 24, algo_hi)
    want = _host_oracle(st0, packed, nows)
    arena = _arena(st0)
    got = _drain1(arena, packed, nows)
    _assert_drain(arena, got, *want, packed, case)


@pytest.mark.parametrize("S", [3, 8])
def test_drain_compact_s_shards_match_per_shard_oracle(S):
    """One drain over S shards, each with its own arena and adversarial
    windows (shard 1 all padding): every shard's words, limits, mismatch
    flags and arena row equal that shard's own host-oracle drain."""
    rng = np.random.default_rng(800 + S)
    K, B, C = 3, 16, 12
    drains = [_adversarial_drain(rng, K, B, C, algo_hi=5) for _ in range(S)]
    nows = drains[0][2]
    packed = np.stack([d[1] for d in drains], axis=1)  # [K, S, B, 2]
    packed[:, 1] = 0
    arena = _arena(*[d[0] for d in drains])
    words, limits, mism = dk.drain_compact(
        arena, torch.from_numpy(packed), torch.from_numpy(nows))
    assert tuple(words.shape) == (K, S, B) and tuple(mism.shape) == (K, S)
    for s, (st0, _, _) in enumerate(drains):
        want = _host_oracle(st0, packed[:, s], nows)
        _assert_drain(arena, (words[:, s], limits[:, s], mism[:, s]), *want,
                      packed[:, s], f"S={S} shard {s}", shard=s)


def test_window_full_matches_jax_oracle():
    """The full-format entry point on int64 columns outside the compact
    caps, chained over windows; pad lanes answer 0 in every field."""
    _window_full_vs_oracle(np.random.default_rng(41), S=1)


def test_window_full_s_shards_match_per_shard_oracle():
    """window_full over S = 4 shards: each shard's responses and arena row
    equal that shard's own kernel.window_step chain."""
    _window_full_vs_oracle(np.random.default_rng(42), S=4)


def _window_full_vs_oracle(rng, S):
    B, C = 32, 16
    sts = [_adversarial_state(rng, C, T0, algo_hi=5) for _ in range(S)]
    arena = _arena(*sts)
    now = T0
    for w in range(3):
        now += int(rng.integers(1, 10**9))
        bs = []
        for _ in range(S):
            b = _adversarial_batch(rng, B, C, algo_hi=5)
            big = rng.random(B) < 0.5
            bs.append(b._replace(
                limit=np.where(big, rng.integers(2**31, 2**45, B),
                               b.limit).astype(np.int64),
                duration=np.where(big, rng.integers(2**31, 2**40, B),
                                  b.duration).astype(np.int64)))
        tout = dk.window_full(arena, tk.WindowBatch(*[
            torch.from_numpy(np.stack([np.array(a) for a in col]))
            for col in zip(*bs)]), now)
        for s, b in enumerate(bs):
            sts[s], jout = _jstep(sts[s], b, jnp.int64(now))
            valid = np.asarray(b.slot) >= 0
            for f, a, j in zip(jk.WindowOutput._fields, tout, jout):
                a = a.numpy()[s]
                np.testing.assert_array_equal(a[valid], np.asarray(j)[valid],
                                              err_msg=f"w{w} s{s} out.{f}")
                assert not a[~valid].any(), f"w{w} s{s} pad lanes of {f}"
            for f, a, j in zip(jk.BucketState._fields, arena, sts[s]):
                np.testing.assert_array_equal(a.numpy()[s], np.asarray(j),
                                              err_msg=f"w{w} s{s} state.{f}")


def test_cpu_calls_run_plain_and_never_count_launches():
    dk.reset_counts()
    C, B = 8, 4
    arena = _arena(tk.BucketState.zeros(C, device="cpu"))
    packed = torch.from_numpy(np.asarray(jk.encode_batch_host(
        np.arange(B, dtype=np.int32), np.ones(B, np.int64),
        np.full(B, 5, np.int64), np.full(B, 1000, np.int64),
        np.zeros(B, np.int32), np.ones(B, bool))))[None, None]
    dk.drain_compact(arena, packed, torch.tensor([T0]))
    again = tk.decode_batch(packed[0])
    dk.window_full(arena, again._replace(
        is_init=torch.zeros_like(again.is_init)), T0 + 1)
    assert dk.launches == {"drain_compact": 0, "drain_compact_stats": 0,
                           "window_full": 0}
    assert dk.plain_calls == {"drain_compact": 1, "drain_compact_stats": 0,
                              "window_full": 1}
    assert arena.remaining[0, :B].tolist() == [3, 3, 3, 3]


def test_wrappers_reject_malformed_inputs():
    C, B = 8, 4
    arena = _arena(tk.BucketState.zeros(C, device="cpu"))
    packed = torch.zeros((1, 1, B, 2), dtype=torch.int64)
    nows = torch.tensor([T0])
    with pytest.raises(ValueError, match="packed"):
        dk.drain_compact(arena, packed.to(torch.int32), nows)
    with pytest.raises(ValueError, match="packed"):
        dk.drain_compact(arena, packed[0], nows)
    with pytest.raises(ValueError, match="nows"):
        dk.drain_compact(arena, packed, torch.tensor([T0, T0]))
    with pytest.raises(ValueError, match="contiguous"):
        dk.drain_compact(arena, torch.zeros((1, 1, 2, B), dtype=torch.int64)
                         .transpose(2, 3), nows)
    with pytest.raises(ValueError, match="arena.algo"):
        dk.drain_compact(arena._replace(algo=arena.limit), packed, nows)
    with pytest.raises(ValueError, match="arena.limit"):
        dk.drain_compact(tk.BucketState.zeros(C, device="cpu"), packed, nows)
    with pytest.raises(ValueError, match="shards"):
        dk.drain_compact(arena, torch.zeros((1, 2, B, 2), dtype=torch.int64),
                         nows)
    with pytest.raises(ValueError, match="lanes"):
        dk.drain_compact(arena, torch.zeros((1, 1, dk.MAX_LANES + 1, 2),
                                            dtype=torch.int64), nows)
    with pytest.raises(ValueError, match="zero windows"):
        dk.drain_compact(arena, packed[:0], nows[:0])
    with pytest.raises(ValueError, match="cuda or cpu"):
        dk.drain_compact(tk.BucketState(*[t.to("meta") for t in arena]),
                         packed.to("meta"), nows.to("meta"))


def test_cuda_engine_request_needs_cuda():
    kw = dict(capacity_per_shard=8, batch_per_shard=8, device="cuda")
    if torch.cuda.is_available():
        assert RateLimitEngine(**kw).state.limit.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RateLimitEngine(**kw)
