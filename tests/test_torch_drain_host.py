"""The port's CUDA kernel sources, built for the host, against the JAX
package's int64 oracle.

ops/csrc/window_drain.cu, global_window.cu, stats_finish.cu,
window_math.cu and global_apply.cu run only on the card, where
chip_smoke.py holds them against their plain versions.  Their device code
(and the ladder.cuh and fold.cuh they include) is plain C++
over integers, so these tests compile the same sources with the host C++
compiler behind a small shim (one thread per CTA, the grid's CTAs run in
turn, shared memory as a static buffer, atomics as plain read-modify-
writes, a warp's shuffles and reductions over its one thread, the C entry
points that launch on a stream left out) and run them on the CPU, on
numpy-seeded inputs that also go through the JAX oracle.  With one thread
the bitonic sort and every slot's walk run in turn, so what is checked is
the kernels' arithmetic, the drain's segment classification and commits,
the S-shard indexing, the analytics' sums, ranking and clears and the
per-op kernels' two passes, not their thread layout.

Compared exactly: for the drain (decode_batch -> window_step ->
encode_output_word, as in tests/test_torch_drain.py), every valid lane's
word and limit, zero pad lanes, the mismatch flags and every arena plane,
over one shard and over several, and a lane past the arena beside a
same-window commit of row C - 1 (it reads the row as the window found it);
`window_full` on int64 columns outside the compact caps against
kernel.window_step; for the per-op window math, every valid lane's
responses and final register against kernel.window_math on the port's
prep, and the committed window against kernel.window_step, over chained
windows at full int64 range; for the per-op GLOBAL apply, the new arena
against kernel.global_apply, in place and out of place; for the GLOBAL kernel, the new
arena and every valid read lane against kernel.global_combined on the
inputs of tests/test_torch_global.py, zero pad lanes; for the stats drain
and the finisher, the sketch and every stats vector against
analytics.oracle_stats over the drain's own words, on every wire edge
(CONCURRENCY releases, AGG lanes, slots past the arena, tenant ids past
both ends, hits near 2^28 - 1), and the accumulator left empty.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import gubernator_tpu  # noqa: F401  (enables x64)
import jax
import jax.numpy as jnp

from gubernator_tpu.ops import analytics as ja
from gubernator_tpu.ops import kernel as jk
from gubernator_tpu_torch.ops import kernel as tk

from .test_fold_fuzz import T0
from .test_torch_drain import _adversarial_drain, _host_oracle, _jstep
from .test_torch_global import CASES, G, global_inputs
from .test_torch_per_op import per_op_clock, per_op_state, per_op_window

pytestmark = pytest.mark.torch_port

_CSRC = (Path(__file__).resolve().parent.parent / "gubernator_tpu_torch"
         / "ops" / "csrc")

# what nvcc provides and a host compiler does not: one thread per CTA, the
# grid's CTAs run one after another (the entries below set blockIdx), and
# the dynamic shared-memory key buffer as a static array of MAX_LANES keys
_SHIM = r"""
#include <cstddef>
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __shared__ static
#define __constant__
struct HostDim3 { unsigned x, y; };
static const HostDim3 threadIdx{0, 0}, blockDim{1, 1};
static HostDim3 blockIdx{0, 0}, gridDim{1, 1};
inline void __syncthreads() {}
inline void __threadfence() {}
template <class T> inline T atomicAdd(T* p, T v) { T o = *p; *p += v; return o; }
template <class T> inline T atomicExch(T* p, T v) { T o = *p; *p = v; return o; }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline unsigned __reduce_add_sync(unsigned, unsigned v) { return v; }
// the sort keys, then the stats drain's tenant sums (up to 4096 tenants)
static uint64_t host_keys[16384 + 3 * 4096];
"""

_DRAIN_ENTRY = r"""
extern "C" void host_drain_compact(
    const int64_t* packed, const int64_t* nows, int K, int S, int B, int64_t* limit,
    int64_t* duration, int64_t* remaining, int64_t* tstamp, int64_t* expire,
    int32_t* algo, long long C, int64_t* words, int64_t* limits, uint8_t* mism) {
  const Geometry g = geometry(B);
  gridDim.x = S;
  for (int s = 0; s < S; ++s) {
    blockIdx.x = s;
    drain_compact_kernel(packed, nows, K, B, g.Bp, g.lane_bits,
                         make_arena(limit, duration, remaining, tstamp, expire, algo, C),
                         words, limits, mism);
  }
}
extern "C" void host_window_full(
    const int32_t* slot, const int64_t* hits, const int64_t* limit_in,
    const int64_t* duration_in, const int32_t* algo_in, const uint8_t* init,
    long long now, int S, int B, int64_t* limit, int64_t* duration, int64_t* remaining,
    int64_t* tstamp, int64_t* expire, int32_t* algo, long long C,
    int32_t* status_out, int64_t* limit_out, int64_t* remaining_out,
    int64_t* reset_out) {
  const Geometry g = geometry(B);
  gridDim.x = S;
  for (int s = 0; s < S; ++s) {
    blockIdx.x = s;
    window_full_kernel(FullSrc{slot, hits, limit_in, duration_in, algo_in, init}, now, B,
                       g.Bp, g.lane_bits,
                       make_arena(limit, duration, remaining, tstamp, expire, algo, C),
                       FullDst{status_out, limit_out, remaining_out, reset_out});
  }
}
"""

_DRAIN_STATS_ENTRY = r"""
extern "C" void host_drain_compact_stats(
    const int64_t* packed, const int64_t* nows, int K, int S, int B, int64_t* limit,
    int64_t* duration, int64_t* remaining, int64_t* tstamp, int64_t* expire,
    int32_t* algo, long long C, int64_t* words, int64_t* limits, uint8_t* mism,
    const int32_t* tenants, int T, int32_t* index, int64_t* entries, int32_t* count,
    int64_t* tenant, int64_t* header, long long N) {
  const Geometry g = geometry(B);
  const StatsAcc acc{tenants, T, index, entries, count, tenant, header, N};
  gridDim.x = S;
  for (int s = 0; s < S; ++s) {
    blockIdx.x = s;
    drain_compact_stats_kernel(packed, nows, K, B, g.Bp, g.lane_bits,
                               make_arena(limit, duration, remaining, tstamp, expire, algo, C),
                               words, limits, mism, acc);
  }
}
"""

_FINISH_ENTRY = r"""
extern "C" void host_stats_finish(
    int64_t* sketch, int D, long long W, int32_t* index, const int64_t* entries,
    int32_t* count, int64_t* tenant, int64_t* header, int64_t* est, long long N, int T,
    const int64_t* expire, long long C, int S, long long now, int decay,
    long long over_weight, int topk, unsigned long long* ecount, unsigned* edone,
    int64_t* stats, int X) {
  const Args a{sketch, D, W, index, entries, count, tenant, header, est, N, T, expire, C,
               now, decay, over_weight, topk, ecount, edone, stats, 8 + 3 * T + 4 * topk};
  gridDim.x = 1 + X;
  gridDim.y = S;
  for (int s = 0; s < S; ++s) {
    blockIdx.y = s;
    // the expiry slices first, then the finisher: the two write disjoint
    // fields, so any order must give the same vector
    for (int x = 1; x <= X; ++x) {
      blockIdx.x = x;
      stats_finish_kernel(a);
    }
    blockIdx.x = 0;
    stats_finish_kernel(a);
  }
}
"""

_MATH_ENTRY = r"""
extern "C" void host_window_math(
    long long now, long long max_pos, int B, const uint8_t* s_valid,
    const int64_t* s_hits, const int64_t* s_limit, const int64_t* s_duration,
    const int32_t* s_algo, const uint8_t* s_init, const uint8_t* s_agg,
    const int32_t* pos, const int32_t* seg_len, const int32_t* seg_start_idx,
    const uint8_t* seg_fold, const int64_t* h0, const int64_t* l0, const int64_t* d0,
    const int32_t* a0, const uint8_t* fresh_seg, const int32_t* nz, const int32_t* n_lead,
    const int64_t* hstar, const int64_t* r_limit, const int64_t* r_duration,
    const int64_t* r_remaining, const int64_t* r_tstamp, const int64_t* r_expire,
    const int32_t* r_algo, int32_t* status, int64_t* limit, int64_t* remaining,
    int64_t* reset, int64_t* f_limit, int64_t* f_duration, int64_t* f_remaining,
    int64_t* f_tstamp, int64_t* f_expire, int32_t* f_algo) {
  const Lanes lanes{s_valid, s_hits, s_limit, s_duration, s_algo, s_init, s_agg, pos,
                    seg_len, seg_start_idx, seg_fold, h0, l0, d0, a0, fresh_seg, nz,
                    n_lead, hstar, r_limit, r_duration, r_remaining, r_tstamp, r_expire,
                    r_algo};
  const MathOut outs{status, limit, remaining, reset, f_limit, f_duration, f_remaining,
                     f_tstamp, f_expire, f_algo};
  window_math_kernel(lanes, outs, B, now, max_pos);
}
"""

_APPLY_ENTRY = r"""
extern "C" void host_global_apply(
    const int64_t* limit, const int64_t* duration, const int64_t* remaining,
    const int64_t* tstamp, const int64_t* expire, const int32_t* algo,
    const int64_t* cfg_limit, const int64_t* cfg_duration, const int32_t* cfg_algo,
    const int64_t* summed, long long G, long long now, int64_t* out_limit,
    int64_t* out_duration, int64_t* out_remaining, int64_t* out_tstamp,
    int64_t* out_expire, int32_t* out_algo) {
  // one thread a row: the shim's one-thread CTAs, one per row
  gridDim.x = static_cast<unsigned>(G);
  for (long long j = 0; j < G; ++j) {
    blockIdx.x = static_cast<unsigned>(j);
    global_apply_kernel(
        Planes<const int64_t, const int32_t>{limit, duration, remaining, tstamp, expire,
                                             algo},
        cfg_limit, cfg_duration, cfg_algo, summed, G, now,
        Planes<int64_t, int32_t>{out_limit, out_duration, out_remaining, out_tstamp,
                                 out_expire, out_algo});
  }
}
"""

_GLOBAL_ENTRY = r"""
extern "C" void host_global_combined(
    const int64_t* limit, const int64_t* duration, const int64_t* remaining,
    const int64_t* tstamp, const int64_t* expire, const int32_t* algo,
    const int64_t* cfg_limit, const int64_t* cfg_duration, const int32_t* cfg_algo,
    long long G, const int32_t* slot, const int64_t* hits, const int64_t* limit_in,
    const int64_t* duration_in, const int32_t* algo_in, const uint8_t* init,
    long long n, const int64_t* summed, long long now, int64_t* out_limit,
    int64_t* out_duration, int64_t* out_remaining, int64_t* out_tstamp,
    int64_t* out_expire, int32_t* out_algo, int64_t* read) {
  gridDim.x = static_cast<unsigned>(n + G);
  for (long long i = 0; i < n + G; ++i) {
    blockIdx.x = static_cast<unsigned>(i);
    global_combined_kernel(
        GArena{limit, duration, remaining, tstamp, expire, algo},
        GConfig{cfg_limit, cfg_duration, cfg_algo}, G,
        GLanes{slot, hits, limit_in, duration_in, algo_in, init}, n, summed, now,
        GArenaOut{out_limit, out_duration, out_remaining, out_tstamp, out_expire,
                  out_algo},
        read);
  }
}
"""


def _host_build(tmp_path_factory, name, entry):
    """csrc/<name>.cu's device code behind the shim, with `entry`, as a
    host shared library."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source with")
    src = (_CSRC / f"{name}.cu").read_text()
    device_code = src[:src.index('extern "C" {')]
    device_code = device_code.replace("#include <cuda_runtime.h>", "")
    device_code = device_code.replace("extern __shared__ uint64_t key[];",
                                      "uint64_t* key = host_keys;")
    out = tmp_path_factory.mktemp(f"host_{name}")
    cpp = out / f"{name}_host.cpp"
    cpp.write_text(_SHIM + device_code + entry)
    so = out / f"lib{name}_host.so"
    res = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                          "-I", str(_CSRC), "-o", str(so), str(cpp)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    return _host_build(tmp_path_factory, "window_drain", _DRAIN_ENTRY)


@pytest.fixture(scope="module")
def host_global(tmp_path_factory):
    return _host_build(tmp_path_factory, "global_window", _GLOBAL_ENTRY)


@pytest.fixture(scope="module")
def host_math(tmp_path_factory):
    return _host_build(tmp_path_factory, "window_math", _MATH_ENTRY)


@pytest.fixture(scope="module")
def host_apply(tmp_path_factory):
    return _host_build(tmp_path_factory, "global_apply", _APPLY_ENTRY)


@pytest.fixture(scope="module")
def host_stats(tmp_path_factory):
    """(stats drain, finisher) host builds."""
    return (_host_build(tmp_path_factory, "window_drain",
                        _DRAIN_ENTRY + _DRAIN_STATS_ENTRY),
            _host_build(tmp_path_factory, "stats_finish", _FINISH_ENTRY))


def _ptr(a):
    return ctypes.c_void_p(a.ctypes.data)


def _planes(st):
    return [np.ascontiguousarray(np.asarray(a)).copy() for a in st]


def _host_drain(lib, st0, packed, nows):
    """One shard: st0 [C] planes, packed [K, B, 2]."""
    arena, words, limits, mism = _host_drain_s(
        lib, [_planes(st0)], packed[:, None], nows)
    return ([a[0] for a in arena], words[:, 0], limits[:, 0], mism[:, 0])


def _host_drain_s(lib, states, packed, nows):
    """S shards: states S lists of [C] planes, packed [K, S, B, 2]."""
    arena = [np.ascontiguousarray(np.stack(p)) for p in zip(*states)]
    K, S, B = packed.shape[:3]
    words = np.zeros((K, S, B), np.int64)
    limits = np.zeros((K, S, B), np.int64)
    mism = np.zeros((K, S), np.uint8)
    packed = np.ascontiguousarray(packed, np.int64)
    nows = np.ascontiguousarray(nows, np.int64)
    lib.host_drain_compact(_ptr(packed), _ptr(nows), K, S, B,
                           *[_ptr(a) for a in arena],
                           ctypes.c_longlong(arena[0].shape[1]), _ptr(words),
                           _ptr(limits), _ptr(mism))
    return arena, words, limits, mism.astype(bool)


def _assert_host_drain(lib, st0, packed, nows, tag):
    arena, words, limits, mism = _host_drain(lib, st0, packed, nows)
    want_st, want_words, want_limits, want_mism = _host_oracle(
        st0, packed, nows)
    valid = (packed[..., 0] & 0xFFFFFFFF) != 0
    np.testing.assert_array_equal(words[valid], want_words[valid],
                                  err_msg=f"{tag} words")
    np.testing.assert_array_equal(limits[valid], want_limits[valid],
                                  err_msg=f"{tag} limits")
    assert not words[~valid].any() and not limits[~valid].any(), \
        f"{tag} pad lanes must answer 0"
    np.testing.assert_array_equal(mism, want_mism, err_msg=f"{tag} mism")
    for f, a, b in zip(jk.BucketState._fields, arena, want_st):
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=f"{tag} state.{f}")


def _slot_config(slot):
    """A key's (algo, limit, duration): it follows the slot."""
    return ((slot % 5).astype(np.int32), (slot * 7 % 40 + 1).astype(np.int64),
            (slot * 131 % 3000 + 10).astype(np.int64))


def _uniform_drain(rng, K, B, C):
    """Windows whose keys each send one config, hot runs with a single
    nonzero hit per key and reads mixed in, over an arena whose rows hold
    their key's config and whose clock is often ahead of the window's: the
    runs fold, and leaky keys see negative leaks."""
    algo, limit, duration = _slot_config(np.arange(C))
    st0 = jk.BucketState(
        limit=jnp.asarray(limit), duration=jnp.asarray(duration),
        remaining=jnp.asarray(rng.integers(0, 4, C).astype(np.int64)),
        tstamp=jnp.asarray(T0 + rng.integers(-3_000, 3_000, C)),
        expire=jnp.asarray(T0 + rng.integers(-500, 3_000, C)),
        algo=jnp.asarray(algo))
    packs, nows = [], []
    for k in range(K):
        slot = rng.integers(0, C, B).astype(np.int32)
        hot = rng.random(B) < 0.7
        slot[hot] = rng.integers(0, 4, int(hot.sum()))
        a, lim, dur = _slot_config(slot)
        hstar = np.where(a == jk.CONCURRENCY, 1 - slot % 3, slot % 3 + 1)
        hits = np.where(rng.random(B) < 0.3, 0, hstar).astype(np.int64)
        is_init = rng.random(B) < 0.05
        agg = (rng.random(B) < 0.05) & (a <= 1) & (hits > 0)
        eslot = np.where(agg, slot | jk.AGG_SLOT_BIT, slot).astype(np.int32)
        eslot[rng.random(B) < 0.1] = jk.PAD_SLOT
        packs.append(np.asarray(jk.encode_batch_host(
            eslot, hits, lim, dur, a, is_init)))
        nows.append(T0 + 5 * k)
    return st0, np.stack(packs), np.asarray(nows, np.int64)


@pytest.mark.parametrize("seed", range(4))
def test_host_kernel_folds_uniform_runs_like_the_oracle(host_kernel, seed):
    """Uniform runs over an arena whose clock runs ahead: the kernel must
    take the oracle's closed-form fold, not a lane-by-lane replay, where
    the two part (a negative leak with no leading reads)."""
    rng = np.random.default_rng(500 + seed)
    for rep in range(6):
        st0, packed, nows = _uniform_drain(rng, 4, 48, 16)
        _assert_host_drain(host_kernel, st0, packed, nows, f"s{seed} r{rep}")


@pytest.mark.parametrize("algo_hi", [2, 5])
def test_host_kernel_drain_matches_oracle_on_adversarial_windows(host_kernel,
                                                                 algo_hi):
    """The fold fuzz's adversarial windows (recycles, AGG runs, algorithm
    switches, mixed configs) in K=4 drains."""
    rng = np.random.default_rng(600 + algo_hi)
    for rep in range(4):
        st0, packed, nows = _adversarial_drain(rng, 4, 64, 24, algo_hi)
        _assert_host_drain(host_kernel, st0, packed, nows, f"rep {rep}")


def test_host_kernel_window_full_matches_oracle(host_kernel):
    """window_full on int64 columns outside the compact caps, non-power-of
    two widths and algorithm values past 4, chained over windows."""
    rng = np.random.default_rng(700)
    step = jax.jit(jk.window_step)
    C = 32
    st = jk.BucketState(
        limit=jnp.asarray(rng.integers(1, 2**40, C)),
        duration=jnp.asarray(rng.integers(1, 2**36, C)),
        remaining=jnp.asarray(rng.integers(0, 2**33, C)),
        tstamp=jnp.asarray(T0 + rng.integers(-2**33, 2**33, C)),
        expire=jnp.asarray(T0 + rng.integers(-2**33, 2**33, C)),
        algo=jnp.asarray(rng.integers(0, 5, C).astype(np.int32)))
    arena = _planes(st)
    for w, B in enumerate((37, 64, 5)):
        now = T0 + w * 10**9
        slot = rng.integers(0, C, B).astype(np.int32)
        slot[rng.random(B) < 0.5] = rng.integers(0, 3)
        slot[rng.random(B) < 0.1] = jk.PAD_SLOT
        algo = rng.integers(0, 7, B).astype(np.int32)
        hits = rng.integers(-5, 2**33, B)
        hits[rng.random(B) < 0.5] = rng.integers(0, 3)
        cols = [slot, hits.astype(np.int64),
                rng.integers(0, 2**45, B).astype(np.int64),
                rng.integers(0, 2**40, B).astype(np.int64), algo,
                (rng.random(B) < 0.1).astype(np.uint8)]
        status = np.zeros(B, np.int32)
        outs = [np.zeros(B, np.int64) for _ in range(3)]
        host_kernel.host_window_full(
            *[_ptr(c) for c in cols], ctypes.c_longlong(now), 1, B,
            *[_ptr(a) for a in arena], ctypes.c_longlong(C), _ptr(status),
            *[_ptr(o) for o in outs])
        st, want = step(st, jk.WindowBatch(
            *[jnp.asarray(c) for c in cols[:5]],
            jnp.asarray(cols[5].astype(bool))), jnp.int64(now))
        valid = slot >= 0
        for name, got, exp in zip(jk.WindowOutput._fields,
                                  [status] + outs, want):
            np.testing.assert_array_equal(got[valid], np.asarray(exp)[valid],
                                          err_msg=f"w{w} {name}")
            assert not got[~valid].any(), f"w{w} {name} pad lanes"
        for f, a, b in zip(jk.BucketState._fields, arena, st):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"w{w} state.{f}")


def test_host_kernel_drain_s_shards_match_per_shard_oracle(host_kernel):
    """One host drain over S = 5 shards (one CTA each, run in turn), shard
    2 all padding: each shard's outputs and arena row equal its own oracle
    drain, so no CTA reads or writes another shard's row or lanes."""
    rng = np.random.default_rng(650)
    drains = [_adversarial_drain(rng, 3, 24, 16, 5) for _ in range(5)]
    nows = drains[0][2]
    packed = np.stack([d[1] for d in drains], axis=1)
    packed[:, 2] = 0
    arena, words, limits, mism = _host_drain_s(
        host_kernel, [_planes(d[0]) for d in drains], packed, nows)
    for s, (st0, _, _) in enumerate(drains):
        want_st, want_words, want_limits, want_mism = _host_oracle(
            st0, packed[:, s], nows)
        valid = (packed[:, s, :, 0] & 0xFFFFFFFF) != 0
        np.testing.assert_array_equal(words[:, s][valid], want_words[valid],
                                      err_msg=f"shard {s} words")
        np.testing.assert_array_equal(limits[:, s][valid],
                                      want_limits[valid],
                                      err_msg=f"shard {s} limits")
        assert not words[:, s][~valid].any(), f"shard {s} pads"
        np.testing.assert_array_equal(mism[:, s], want_mism,
                                      err_msg=f"shard {s} mism")
        for f, a, b in zip(jk.BucketState._fields, arena, want_st):
            np.testing.assert_array_equal(a[s], np.asarray(b),
                                          err_msg=f"shard {s} state.{f}")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_host_global_kernel_matches_oracle(host_global, case, seed):
    """global_window.cu's device code on the inputs of
    tests/test_torch_global.py (all five algorithms and out-of-range
    values, int64 values wrapped at both ends, expired rows, algorithm
    switches, is_init, zero sums, pad and out-of-range slots): the new
    arena and every valid read lane equal kernel.global_combined, pads
    answer 0, and the input arena is not written."""
    algos, wrap = CASES[case]
    state, cfg, batch, summed = global_inputs(
        np.random.default_rng(100 + seed), algos, wrap)
    names = jk.BucketState._fields
    planes = [np.ascontiguousarray(state[f]) for f in names]
    before = [p.copy() for p in planes]
    cfgs = [np.ascontiguousarray(cfg[f]) for f in jk.GlobalConfig._fields]
    lanes = [np.ascontiguousarray(batch[f]) for f in jk.WindowBatch._fields]
    lanes[-1] = lanes[-1].astype(np.uint8)
    n = lanes[0].shape[0]
    # outputs start as garbage, as torch.empty leaves them on the card
    new = [np.full_like(p, -7) for p in planes]
    read = np.full((n, 4), -7, np.int64)
    host_global.host_global_combined(
        *[_ptr(p) for p in planes], *[_ptr(c) for c in cfgs],
        ctypes.c_longlong(G), *[_ptr(x) for x in lanes], ctypes.c_longlong(n),
        _ptr(summed), ctypes.c_longlong(T0), *[_ptr(p) for p in new],
        _ptr(read))
    js = jk.BucketState(**{k: jnp.asarray(v) for k, v in state.items()})
    jc = jk.GlobalConfig(**{k: jnp.asarray(v) for k, v in cfg.items()})
    jb = jk.WindowBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    w_state, w_out = jk.global_combined(js, jc, jb, jnp.asarray(summed),
                                        jnp.int64(T0))
    for f, a, b in zip(names, new, w_state):
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=f"{case} state.{f}")
    for a, b in zip(planes, before):
        np.testing.assert_array_equal(a, b)
    valid = batch["slot"] >= 0
    for i, f in enumerate(jk.WindowOutput._fields):
        np.testing.assert_array_equal(
            read[valid, i], np.asarray(w_out[i]).astype(np.int64)[valid],
            err_msg=f"{case} read.{f}")
    assert not read[~valid].any()


@pytest.mark.parametrize("entry", ["drain_compact", "window_full"])
def test_host_drain_past_the_arena_reads_row_c_minus_1_before_the_window(
        host_kernel, entry):
    """The smallest window that showed the drain's row C - 1 race: a lane on
    slot C - 1 (one hit) and a lane on slot C + 4.  The second lane reads
    row C - 1 and commits nothing; the oracle gathers the row before the
    window, so it must answer from the row as the window found it, not
    after the first lane's commit (the host build walks the runs in slot
    order, so the commit always comes first here)."""
    C = 8
    st0 = jk.BucketState(
        limit=jnp.full(C, 5, jnp.int64), duration=jnp.full(C, 60_000, jnp.int64),
        remaining=jnp.full(C, 5, jnp.int64), tstamp=jnp.full(C, T0 + 60_000,
                                                            jnp.int64),
        expire=jnp.full(C, T0 + 60_000, jnp.int64),
        algo=jnp.zeros(C, jnp.int32))
    cols = [np.asarray([C - 1, C + 4], np.int32), np.asarray([1, 1]),
            np.asarray([5, 5]), np.asarray([60_000, 60_000]),
            np.zeros(2, np.int32), np.zeros(2, np.uint8)]
    want_st, want = _jstep(st0, jk.WindowBatch(
        *[jnp.asarray(c) for c in cols[:5]], jnp.asarray(cols[5] != 0)),
        jnp.int64(T0))
    assert [int(x) for x in want.remaining] == [4, 4]
    arena = _planes(st0)
    if entry == "drain_compact":
        packed = np.asarray(jk.encode_batch_host(*cols[:5], cols[5] != 0))
        got_st, words, limits, _ = _host_drain(host_kernel, st0, packed[None],
                                               np.asarray([T0]))
        want_words = np.asarray(jk.encode_output_word(want, jnp.int64(T0)))
        np.testing.assert_array_equal(words[0], want_words)
        np.testing.assert_array_equal(limits[0], np.asarray(want.limit))
    else:
        status = np.zeros(2, np.int32)
        outs = [np.zeros(2, np.int64) for _ in range(3)]
        host_kernel.host_window_full(
            *[_ptr(np.ascontiguousarray(c)) for c in cols],
            ctypes.c_longlong(T0), 1, 2, *[_ptr(a) for a in arena],
            ctypes.c_longlong(C), _ptr(status), *[_ptr(o) for o in outs])
        for name, got, exp in zip(jk.WindowOutput._fields, [status] + outs,
                                  want):
            np.testing.assert_array_equal(got, np.asarray(exp), err_msg=name)
        got_st = arena
    for f, a, b in zip(jk.BucketState._fields, got_st, want_st):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"state.{f}")


_PREP_LANES = ("s_valid", "s_hits", "s_limit", "s_duration", "s_algo",
               "s_init", "s_agg", "pos", "seg_len", "seg_start_idx",
               "seg_fold", "h0", "l0", "d0", "a0", "fresh_seg", "nz",
               "n_lead", "hstar")


def _tt(a):
    return torch.from_numpy(np.array(a))


def _host_window_math(lib, prep, now):
    """window_math.cu's kernel on one window's port prep ([B] lanes)."""
    lanes = [np.ascontiguousarray(getattr(prep, f).numpy()) for f in
             _PREP_LANES]
    lanes = [a.astype(np.uint8) if a.dtype == bool else a for a in lanes]
    reg = [np.ascontiguousarray(r.numpy()) for r in prep.cur]
    B = lanes[0].shape[0]
    # outputs start as garbage, as torch.empty leaves them on the card
    out = [np.full(B, -7, np.int32)] + [np.full(B, -7, np.int64)
                                        for _ in range(3)]
    fin = [np.full(B, -7, np.int64) for _ in range(5)] + [
        np.full(B, -7, np.int32)]
    lib.host_window_math(ctypes.c_longlong(now),
                         ctypes.c_longlong(prep.max_pos), B,
                         *[_ptr(a) for a in lanes + reg + out + fin])
    return out, fin


@pytest.mark.parametrize("wide", [False, True], ids=["compact", "int64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_window_math_matches_oracle(host_math, seed, wide):
    """window_math.cu's device code over eight chained windows of 64 lanes
    (all five algorithms and out-of-range values, hot runs that fold and
    runs that replay, AGG lanes, inits, pads, slots past the arena beside
    row C - 1, a clock that steps backwards; `int64` at full int64 range):
    its responses and final registers equal kernel.window_math on the same
    prep at every valid lane (pads 0, fin their register), and committed
    with kernel.window_commit the window equals kernel.window_step."""
    rng = np.random.default_rng(450 + seed + 10 * wide)
    C, B = 32, 64
    jst = per_op_state(rng, C, T0, wide)
    tst = tk.BucketState(*[_tt(a) for a in jst])
    for w, now in enumerate(per_op_clock(rng, 8)):
        now = int(now)
        bt = per_op_window(rng, B, C, wide)
        tbt = tk.WindowBatch(*[_tt(a) for a in bt])
        prep = tk.window_prep(tst, tbt, _tt(np.int64(now)))
        out, fin = _host_window_math(host_math, prep, now)
        want_out, want_fin = tk.window_math(
            _tt(np.int64(now)), prep.max_pos, prep.s_valid, prep.s_hits,
            prep.s_limit, prep.s_duration, prep.s_algo, prep.s_agg, prep.pos,
            prep.seg_len, prep.seg_start_idx, prep.seg_fold, prep.h0,
            prep.l0, prep.d0, prep.a0, prep.fresh_seg, prep.cur, prep.nz,
            prep.n_lead, prep.hstar)
        v = prep.s_valid.numpy()
        for name, g, x in zip(jk.WindowOutput._fields, out, want_out):
            np.testing.assert_array_equal(g[v], x.numpy()[v],
                                          err_msg=f"w{w} out.{name}")
            assert not g[~v].any(), f"w{w} out.{name} pad lanes"
        for name, g, x, r in zip(jk.BucketState._fields, fin, want_fin,
                                 prep.cur):
            np.testing.assert_array_equal(g[v], x.numpy()[v],
                                          err_msg=f"w{w} fin.{name}")
            np.testing.assert_array_equal(g[~v], r.numpy()[~v])
        tst, got = tk.window_commit(
            tst, prep, tk._Reg(*[_tt(a) for a in fin]),
            tk.WindowOutput(*[_tt(a) for a in out]))
        jst, want = _jstep(jst, jk.WindowBatch(*[jnp.asarray(a) for a in bt]),
                           jnp.int64(now))
        valid = np.asarray(bt.slot) >= 0
        for name, g, x in zip(jk.WindowOutput._fields, got, want):
            np.testing.assert_array_equal(g.numpy()[valid],
                                          np.asarray(x)[valid],
                                          err_msg=f"w{w} step out.{name}")
        for name, g, x in zip(jk.BucketState._fields, tst, jst):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x),
                                          err_msg=f"w{w} state.{name}")


@pytest.mark.parametrize("in_place", [False, True], ids=["out", "in_place"])
@pytest.mark.parametrize("case", list(CASES))
def test_host_global_apply_matches_oracle(host_apply, case, in_place):
    """global_apply.cu's device code on tests/test_torch_global.py's edge
    inputs (all five algorithms and out-of-range values, int64 wrapped at
    both ends, expired rows, switches, zero sums) at G = 64 and at 37 rows
    (no block shape to fill): the new arena equals kernel.global_apply,
    written out of place (the input untouched) or in place."""
    algos, wrap = CASES[case]
    for g in (G, 37):
        state, cfg, _, summed = global_inputs(
            np.random.default_rng(300 + g), algos, wrap, G=g)
        names = jk.BucketState._fields
        planes = [np.ascontiguousarray(state[f]) for f in names]
        before = [p.copy() for p in planes]
        cfgs = [np.ascontiguousarray(cfg[f]) for f in jk.GlobalConfig._fields]
        new = planes if in_place else [np.full_like(p, -7) for p in planes]
        host_apply.host_global_apply(
            *[_ptr(p) for p in planes], *[_ptr(c) for c in cfgs],
            _ptr(summed), ctypes.c_longlong(g), ctypes.c_longlong(T0),
            *[_ptr(p) for p in new])
        want = jk.global_apply(
            jk.BucketState(*[jnp.asarray(p) for p in before]),
            jk.GlobalConfig(*[jnp.asarray(c) for c in cfgs]),
            jnp.asarray(summed), jnp.int64(T0))
        for f, a, b in zip(names, new, want):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{case} G={g} {f}")
        if not in_place:
            for a, b in zip(planes, before):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# analytics: the stats drain (window_drain.cu) and the finisher
# (stats_finish.cu)


def _release_drain(rng, K, B, C, T):
    """An adversarial K-window drain (tests/test_torch_drain.py) with
    CONCURRENCY release lanes, hits near 2^28 - 1, a slot past the arena,
    a wire word with slot bit 31 set (the drain pads it, the oracle clips
    it to row C - 1), and tenant ids past both ends."""
    st0, packed, nows = _adversarial_drain(rng, K, B, C, 5)
    packed = packed.copy()
    w0 = packed[..., 0]
    big = (rng.random(w0.shape) < 0.1) & (w0 != 0)
    w0[big] = (w0[big] & ~(((1 << 28) - 1) << 34)) | (((1 << 28) - 2) << 34)
    w0[0, 0] = (w0[0, 0] & ~0xFFFFFFFF) | (C + 4)
    w0[0, 1] = (w0[0, 1] & ~0xFFFFFFFF) | (1 << 31) | 5
    tenants = rng.integers(-2, T + 2, (K, B)).astype(np.int32)
    return st0, packed, nows, tenants


def _host_stats_drain(lib, arena, packed, nows, tenants, acc):
    """One host stats drain over S shards: arena [S, C] numpy planes,
    packed [K, S, B, 2], tenants [K, S, B]; acc a dict of the
    accumulator's numpy arrays, added to in place."""
    K, S, B = packed.shape[:3]
    words = np.zeros((K, S, B), np.int64)
    limits = np.zeros((K, S, B), np.int64)
    mism = np.zeros((K, S), np.uint8)
    packed = np.ascontiguousarray(packed, np.int64)
    lib.host_drain_compact_stats(
        _ptr(packed), _ptr(np.ascontiguousarray(nows, np.int64)), K, S, B,
        *[_ptr(a) for a in arena], ctypes.c_longlong(arena[0].shape[1]),
        _ptr(words), _ptr(limits), _ptr(mism),
        _ptr(np.ascontiguousarray(tenants, np.int32)),
        acc["tenant"].shape[1], _ptr(acc["index"]), _ptr(acc["entries"]),
        _ptr(acc["count"]), _ptr(acc["tenant"]), _ptr(acc["header"]),
        ctypes.c_longlong(acc["entries"].shape[1]))
    return words


def _host_finish(lib, sketch, acc, expire, now, decay, topk, ow, X):
    S, D, W = sketch.shape
    T = acc["tenant"].shape[1]
    stats = np.full((S, ja.stats_len(T, topk)), -7, np.int64)
    lib.host_stats_finish(
        _ptr(sketch), D, ctypes.c_longlong(W), _ptr(acc["index"]),
        _ptr(acc["entries"]), _ptr(acc["count"]), _ptr(acc["tenant"]),
        _ptr(acc["header"]), _ptr(acc["est"]),
        ctypes.c_longlong(acc["entries"].shape[1]), T, _ptr(expire),
        ctypes.c_longlong(expire.shape[1]), S, ctypes.c_longlong(now), decay,
        ctypes.c_longlong(ow), topk, _ptr(acc["ecount"]), _ptr(acc["edone"]),
        _ptr(stats), X)
    return stats


def _acc(S, C, T, N):
    return dict(index=np.zeros((S, C), np.int32),
                entries=np.full((S, N, 4), -7, np.int64),
                count=np.zeros(S, np.int32),
                tenant=np.zeros((S, T, 3), np.int64),
                header=np.zeros((S, 4), np.int64),
                est=np.zeros((S, N), np.int64),
                ecount=np.zeros((S, 2), np.uint64),
                edone=np.zeros(S, np.uint32))


@pytest.mark.parametrize("X", [1, 3])
def test_host_stats_kernels_match_oracle(host_stats, X):
    """Three carried drains over S = 3 shards (shard 1 all padding on the
    second), a decay drain, a non-zero starting sketch, X expiry slices per
    shard: the host stats drain's words, limits, flags and arena equal the
    plain drain's oracle, and the host finisher's sketch and stats equal
    oracle_stats over those words, shard by shard; every accumulator array
    is zero again after each finish."""
    drain_lib, finish_lib = host_stats
    rng = np.random.default_rng(880 + X)
    S, K, B, C, T, topk, D, W = 3, 3, 32, 24, 5, 6, 4, 16
    kw = dict(tenant_slots=T, topk=topk, over_weight=4)
    shards = [_release_drain(rng, K, B, C, T) for _ in range(S)]
    arena = [np.ascontiguousarray(np.stack(p))
             for p in zip(*[_planes(d[0]) for d in shards])]
    states = [d[0] for d in shards]
    acc = _acc(S, C, T, K * B)
    sketch = rng.integers(0, 100, (S, D, W)).astype(np.int64)
    want_sk = sketch.copy()
    for d, decay in enumerate((0, 1, 0)):
        drains = [_release_drain(rng, K, B, C, T) for _ in range(S)]
        packed = np.stack([x[1] for x in drains], axis=1)
        tenants = np.stack([x[3] for x in drains], axis=1)
        if d == 1:
            packed[:, 1] = 0
        nows = drains[0][2] + 10**9 * d
        words = _host_stats_drain(drain_lib, arena, packed, nows, tenants,
                                  acc)
        stats = _host_finish(finish_lib, sketch, acc, arena[4], int(nows[0]),
                             decay, topk, 4, X)
        for s in range(S):
            st, want_words, _, _ = _host_oracle(states[s], packed[:, s],
                                                nows)
            states[s] = st
            # a lane is served when its slot field decodes to >= 0; a
            # lane past the arena reads row C - 1 as the window found it
            low = packed[:, s, :, 0] & 0xFFFFFFFF
            served = (low != 0) & (low < 1 << 31)
            np.testing.assert_array_equal(words[:, s][served],
                                          want_words[served])
            assert not words[:, s][~served].any()
            for f, a, b in zip(jk.BucketState._fields, arena, st):
                np.testing.assert_array_equal(a[s], np.asarray(b),
                                              err_msg=f"d{d} s{s} {f}")
            want_sk[s], want = ja.oracle_stats(
                want_sk[s], packed[:, s], words[:, s], tenants[:, s],
                arena[4][s], int(nows[0]), decay, **kw)
            np.testing.assert_array_equal(sketch[s], want_sk[s],
                                          err_msg=f"d{d} s{s} sketch")
            np.testing.assert_array_equal(stats[s], want,
                                          err_msg=f"d{d} s{s} stats")
        for name in ("index", "count", "tenant", "header", "ecount",
                     "edone"):
            assert not acc[name].any(), f"d{d} {name} left set"
