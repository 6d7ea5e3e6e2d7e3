"""The port's CUDA kernel sources, built for the host, against the JAX
package's int64 oracle.

ops/csrc/window_drain.cu, global_window.cu, stats_finish.cu,
window_math.cu and global_apply.cu run only on the card, where
chip_smoke.py holds them against their plain versions.  Their device code
(and the ladder.cuh and fold.cuh they include) is plain C++
over integers, so these tests compile the same sources with the host C++
compiler behind a small shim (one thread per CTA, the grid's CTAs run in
turn, shared memory as a static buffer, atomics as plain read-modify-
writes, a warp's shuffles and reductions over its one thread,
the drain's async staging copies as plain copies, the C entry points that
launch on a stream left out) and run them on the CPU, on numpy-seeded
inputs that also go through the JAX oracle.  With one thread the block
scans, the bitonic sort (all of it through its shared-memory stages) and
every segment run in turn, so what is checked is the kernels'
arithmetic, the drain's routing of rows to partitions, its segment
structure, classification and commits, the P x S grid's indexing, the
analytics' sums, ranking and clears and the per-op kernels' two passes,
not their thread layout (chip_smoke.py holds that on the card).

Compared exactly: for the drain (decode_batch -> window_step ->
encode_output_word, as in tests/test_torch_drain.py), every valid lane's
word and limit, zero pad lanes, the mismatch flags and every arena plane,
over one shard and over several, and a lane past the arena beside a
same-window commit of row C - 1 (it reads the row as the window found it);
over P partitions (P = 1, a few, more than the distinct rows): a run cut
into many virtual segments, a 64-lane folded hot run, row C - 1 beside
slots past the arena, and the stats drain's accumulator filled by several
CTAs, compared whatever the order of its entries;
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
from gubernator_tpu_torch.ops import global_kernel as gk
from gubernator_tpu_torch.ops import kernel as tk

from .test_fold_fuzz import T0
from .test_torch_drain import _adversarial_drain, _host_oracle, _jstep
from .test_torch_global import CASES, G, global_inputs, summed_control
from .test_torch_global_window import (
    arena,
    assert_window,
    jax_window,
    jax_window_ups,
    random_control,
    random_upserts,
)
from .test_torch_per_op import per_op_clock, per_op_state, per_op_window

pytestmark = pytest.mark.torch_port

_CSRC = (Path(__file__).resolve().parent.parent / "gubernator_tpu_torch"
         / "ops" / "csrc")

# what nvcc provides and a host compiler does not: one thread per CTA, the
# grid's CTAs run one after another (the entries below set blockIdx), and
# the dynamic shared-memory key buffer as a static array of MAX_LANES keys
_SHIM = r"""
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>
using std::min;
#define GUBER_HOST_SHIM
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __shared__ static
#define __constant__
#define __align__(x)
struct HostDim3 { unsigned x, y; };
static const HostDim3 threadIdx{0, 0}, blockDim{1, 1};
static HostDim3 blockIdx{0, 0}, gridDim{1, 1};
inline void __syncthreads() {}
inline int __syncthreads_or(int p) { return p; }
inline void __syncwarp() {}
inline void __threadfence() {}
template <class T> inline T atomicAdd(T* p, T v) { T o = *p; *p += v; return o; }
template <class T> inline T atomicCAS(T* p, T cmp, T v) { T o = *p; if (o == cmp) *p = v; return o; }
template <class T> inline T atomicExch(T* p, T v) { T o = *p; *p = v; return o; }
template <class T> inline T atomicOr(T* p, T v) { T o = *p; *p |= v; return o; }
template <class T> inline T atomicMax(T* p, T v) { T o = *p; if (v > o) *p = v; return o; }
template <class T> inline T atomicMin(T* p, T v) { T o = *p; if (v < o) *p = v; return o; }
struct longlong2 { long long x, y; };
// the card's clock for debug stamps: none here
inline unsigned long long global_ns() { return 0; }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int) { return v; }
template <class T> inline T __shfl_up_sync(unsigned, T v, int) { return v; }
template <class T> inline T __shfl_sync(unsigned, T v, int) { return v; }
inline unsigned __reduce_add_sync(unsigned, unsigned v) { return v; }
// a warp's votes over its one thread: lane 0 alone
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
static const int warpSize = 1;
inline unsigned __match_any_sync(unsigned, unsigned) { return 1u; }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// the async staging copies as plain copies, done when issued
inline void stage_copy16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void stage_commit() {}
inline void stage_wait_prior() {}
// the dynamic shared memory of the CTA that runs: the drain entries point
// it at a buffer of the launch's size
static unsigned char* host_smem = nullptr;
"""

_DRAIN_ENTRY = r"""
// the drain's P x S grid, CTA (p, s) at blockIdx (p, s), run in turn over
// one shared-memory buffer, and the workspace slices when the launch needs
// them
template <class Run>
static void host_grid(int kind, int B, int S, int T, int P, Run run) {
  const Layout g = kind_layout(kind, B, T);
  std::vector<unsigned char> smem(g.smem + 16);
  std::vector<unsigned char> ws(g.global ? g.array_bytes * P * S : 16);
  host_smem = smem.data();
  gridDim.x = P;
  gridDim.y = S;
  for (int s = 0; s < S; ++s) {
    for (int p = 0; p < P; ++p) {
      blockIdx.x = p;
      blockIdx.y = s;
      run(g, ws.data());
    }
  }
}
extern "C" void host_drain_compact(
    const int64_t* packed, const int64_t* nows, int K, int S, int B, int64_t* limit,
    int64_t* duration, int64_t* remaining, int64_t* tstamp, int64_t* expire,
    int32_t* algo, long long C, int64_t* words, int64_t* limits, uint8_t* mism, int P) {
  std::memset(mism, 0, static_cast<size_t>(K) * S);
  host_grid(kDrain, B, S, 0, P, [&](const Layout& g, unsigned char* ws) {
    drain_compact_kernel(packed, nows, K, B, g,
                         make_arena(limit, duration, remaining, tstamp, expire, algo, C),
                         words, limits, mism, ws);
  });
}
extern "C" void host_window_full(
    const int32_t* slot, const int64_t* hits, const int64_t* limit_in,
    const int64_t* duration_in, const int32_t* algo_in, const uint8_t* init,
    long long now, int S, int B, int64_t* limit, int64_t* duration, int64_t* remaining,
    int64_t* tstamp, int64_t* expire, int32_t* algo, long long C,
    int32_t* status_out, int64_t* limit_out, int64_t* remaining_out,
    int64_t* reset_out, int P) {
  host_grid(kFull, B, S, 0, P, [&](const Layout& g, unsigned char* ws) {
    window_full_kernel(FullSrc{slot, hits, limit_in, duration_in, algo_in, init}, now, B, g,
                       make_arena(limit, duration, remaining, tstamp, expire, algo, C),
                       FullDst{status_out, limit_out, remaining_out, reset_out}, ws);
  });
}
"""

_DRAIN_STATS_ENTRY = r"""
extern "C" void host_drain_compact_stats(
    const int64_t* packed, const int64_t* nows, int K, int S, int B, int64_t* limit,
    int64_t* duration, int64_t* remaining, int64_t* tstamp, int64_t* expire,
    int32_t* algo, long long C, int64_t* words, int64_t* limits, uint8_t* mism,
    const int32_t* tenants, int T, int32_t* index, int64_t* entries, int32_t* count,
    int64_t* tenant, int64_t* header, long long N, int P) {
  const StatsAcc acc{tenants, T, index, entries, count, tenant, header, N};
  std::memset(mism, 0, static_cast<size_t>(K) * S);
  host_grid(kDrainStats, B, S, T, P, [&](const Layout& g, unsigned char* ws) {
    drain_compact_stats_kernel(packed, nows, K, B, g,
                               make_arena(limit, duration, remaining, tstamp, expire, algo, C),
                               words, limits, mism, acc, ws);
  });
}
"""

_FINISH_ENTRY = r"""
extern "C" void host_stats_finish(
    int64_t* sketch, int D, long long W, int32_t* index, const int64_t* entries,
    int32_t* count, int64_t* tenant, int64_t* header, int64_t* est, long long N, int T,
    const int64_t* expire, long long C, int S, long long now, int decay,
    long long over_weight, int topk, unsigned long long* ecount, unsigned* edone,
    int64_t* stats, int X, int key_cap, int sketch_smem) {
  const Args a{sketch, D, W, index, entries, count, tenant, header, est, N, T, expire, C,
               now, decay, over_weight, topk, ecount, edone, stats, 8 + 3 * T + 4 * topk,
               S, X, key_cap, sketch_smem, nullptr};
  // the dynamic shared memory: the sketch's copy and the rank keys
  std::vector<unsigned char> smem_buf(
      static_cast<size_t>(key_cap) * 16 + (sketch_smem ? sketch_bytes(D, W) : 0) + 16);
  host_smem = smem_buf.data();
  // the S finishers and the S X expiry slices; the slices first: the two
  // write disjoint fields, so any order must give the same vector
  gridDim.x = S + S * X;
  for (int b = S; b < S + S * X; ++b) {
    blockIdx.x = b;
    stats_finish_kernel(a);
  }
  for (int b = 0; b < S; ++b) {
    blockIdx.x = b;
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
    int64_t* f_tstamp, int64_t* f_expire, int32_t* f_algo, int tile) {
  const Lanes lanes{s_valid, s_hits, s_limit, s_duration, s_algo, s_init, s_agg, pos,
                    seg_len, seg_start_idx, seg_fold, h0, l0, d0, a0, fresh_seg, nz,
                    n_lead, hstar, r_limit, r_duration, r_remaining, r_tstamp, r_expire,
                    r_algo};
  const MathOut outs{status, limit, remaining, reset, f_limit, f_duration, f_remaining,
                     f_tstamp, f_expire, f_algo};
  // ceil(B / tile) one-thread CTAs, the last first: no CTA may depend on
  // another having run
  gridDim.x = static_cast<unsigned>((B + tile - 1) / tile);
  for (int c = static_cast<int>(gridDim.x) - 1; c >= 0; --c) {
    blockIdx.x = static_cast<unsigned>(c);
    window_math_kernel(lanes, outs, B, tile, now, max_pos);
  }
}
"""

_PHASES = r"""
// the entries' arguments: the arena, its config, the control, the sums
#define HOST_ARENA_ARGS                                                              \
  int64_t *limit, int64_t *duration, int64_t *remaining, int64_t *tstamp,            \
      int64_t *expire, int32_t *algo, int64_t *cfg_limit, int64_t *cfg_duration,     \
      int32_t *cfg_algo, long long G, const int64_t *control, long long n, long long kg, \
      int64_t *sums
#define HOST_ARENA                                                                   \
  const GArena a{limit, duration, remaining, tstamp, expire, algo, G};              \
  const GConfig cfg{cfg_limit, cfg_duration, cfg_algo};                             \
  const Control c{control, n, kg}
// the same with the control's upsert lanes: the entries named *_ku take
// `long long ku` after HOST_ARENA_ARGS
#define HOST_ARENA_KU                                                                \
  const GArena a{limit, duration, remaining, tstamp, expire, algo, G};              \
  const GConfig cfg{cfg_limit, cfg_duration, cfg_algo};                             \
  const Control c{control, n, kg, ku}
"""

_APPLY_ENTRY = _PHASES + r"""
// global_stage's and global_apply's items in turn, the apply's lanes
// forward or backward (which lane of a slot wins must not matter)
extern "C" void host_global_stage(HOST_ARENA_ARGS) {
  HOST_ARENA;
  for (int64_t i = 0; i < stage_items(c); ++i) stage_item(a, cfg, c, sums, i);
}
extern "C" void host_global_apply(HOST_ARENA_ARGS, long long now, int backward) {
  HOST_ARENA;
  for (int64_t k = 0; k < n; ++k) apply_lane(a, cfg, c, sums, now, backward ? n - 1 - k : k);
}
// global_stage with upsert lanes: its upsert launch's items, then its stage
// launch's, each forward or backward (no item may depend on another's
// order within a launch)
extern "C" void host_global_stage_ku(HOST_ARENA_ARGS, long long ku, int backward) {
  HOST_ARENA_KU;
  for (int64_t p = 0; p < ku; ++p) upsert_item(a, cfg, c, backward ? ku - 1 - p : p);
  const int64_t m = stage_items(c);
  for (int64_t i = 0; i < m; ++i) stage_item(a, cfg, c, sums, backward ? m - 1 - i : i);
}
"""

_GLOBAL_ENTRY = _PHASES + r"""
// the cluster kernel's segments as `threads` threads would run them, each
// segment over every thread (first t, stride threads) before the next, as
// the cluster barriers order them; the threads of a segment in turn,
// forward or backward (no thread may depend on another's order)
extern "C" void host_global_window(HOST_ARENA_ARGS, long long now, int64_t* read,
                                   int backward, long long threads) {
  HOST_ARENA;
  std::vector<WindowThread> ts(static_cast<size_t>(threads));
  for (long long t = 0; t < threads; ++t) {
    ts[t].first = t;
    ts[t].stride = threads;
  }
  auto each = [&](auto seg) {
    for (long long k = 0; k < threads; ++k) seg(ts[backward ? threads - 1 - k : k]);
  };
  each([&](WindowThread& t) { window_seg_a(a, cfg, c, sums, t); });
  each([&](WindowThread& t) { window_seg_b(a, cfg, c, sums, now, read, t); });
  each([&](WindowThread& t) { window_seg_c(a, cfg, c, sums, now, t); });
}
// the same with the control's upsert lanes
extern "C" void host_global_window_ku(HOST_ARENA_ARGS, long long ku, long long now,
                                      int64_t* read, int backward, long long threads) {
  HOST_ARENA_KU;
  std::vector<WindowThread> ts(static_cast<size_t>(threads));
  for (long long t = 0; t < threads; ++t) {
    ts[t].first = t;
    ts[t].stride = threads;
  }
  auto each = [&](auto seg) {
    for (long long k = 0; k < threads; ++k) seg(ts[backward ? threads - 1 - k : k]);
  };
  each([&](WindowThread& t) { window_seg_u(a, cfg, c, t); });
  each([&](WindowThread& t) { window_seg_a(a, cfg, c, sums, t); });
  each([&](WindowThread& t) { window_seg_b(a, cfg, c, sums, now, read, t); });
  each([&](WindowThread& t) { window_seg_c(a, cfg, c, sums, now, t); });
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
    device_code = device_code.replace(
        "extern __shared__ __align__(16) unsigned char smem[];",
        "unsigned char* smem = host_smem;")
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


def _host_drain(lib, st0, packed, nows, P=1):
    """One shard: st0 [C] planes, packed [K, B, 2]."""
    arena, words, limits, mism = _host_drain_s(
        lib, [_planes(st0)], packed[:, None], nows, P)
    return ([a[0] for a in arena], words[:, 0], limits[:, 0], mism[:, 0])


def _flags(K, S):
    """u8[K, S] mismatch flags; the kernel sets one through an atomic on
    its 4-byte word, so the buffer runs on to a whole word."""
    return np.zeros(K * S + 4, np.uint8)[:K * S].reshape(K, S)


def _host_drain_s(lib, states, packed, nows, P=1):
    """S shards over a P x S grid: states S lists of [C] planes, packed
    [K, S, B, 2]."""
    arena = [np.ascontiguousarray(np.stack(p)) for p in zip(*states)]
    K, S, B = packed.shape[:3]
    # outputs start as garbage, as torch.empty leaves them on the card
    words = np.full((K, S, B), -7, np.int64)
    limits = np.full((K, S, B), -7, np.int64)
    mism = _flags(K, S)
    mism[:] = 7
    packed = np.ascontiguousarray(packed, np.int64)
    nows = np.ascontiguousarray(nows, np.int64)
    lib.host_drain_compact(_ptr(packed), _ptr(nows), K, S, B,
                           *[_ptr(a) for a in arena],
                           ctypes.c_longlong(arena[0].shape[1]), _ptr(words),
                           _ptr(limits), _ptr(mism), P)
    return arena, words, limits, mism.astype(bool)


def _assert_host_drain(lib, st0, packed, nows, tag, P=1):
    arena, words, limits, mism = _host_drain(lib, st0, packed, nows, P)
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
            *[_ptr(o) for o in outs], 1)
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


def _arena_copies(state, cfg):
    """Copies of numpy (state, cfg) dicts as lists of planes, and an
    all-zero scratch of sums."""
    planes = [np.ascontiguousarray(state[f]).copy()
              for f in jk.BucketState._fields]
    cfgs = [np.ascontiguousarray(cfg[f]).copy()
            for f in jk.GlobalConfig._fields]
    return planes, cfgs, np.zeros(planes[0].shape[0], np.int64)


def _host_global(lib, entry, planes, cfgs, sums, ctl, *tail):
    """Call a host GLOBAL entry on lists of numpy planes, a scratch and the
    packed control `ctl` (ops/global_kernel.py Control on the CPU), all
    written in place; `tail` the entry's further arguments (arrays by
    pointer)."""
    block = np.ascontiguousarray(ctl.block.numpy())
    getattr(lib, entry)(
        *[_ptr(p) for p in planes], *[_ptr(c) for c in cfgs],
        ctypes.c_longlong(sums.shape[0]), _ptr(block),
        ctypes.c_longlong(ctl.n), ctypes.c_longlong(ctl.kg), _ptr(sums),
        *[_ptr(a) if isinstance(a, np.ndarray) else a for a in tail])


def _host_window(lib, state, cfg, ctl, now, backward=0, threads=None):
    """global_window.cu's three segments as `threads` threads run them
    (default 2n: a thread per read lane and per apply lane, as the card
    launches it), each segment over every thread in turn, on copies:
    (state, cfg, read, scratches)."""
    planes, cfgs, sums = _arena_copies(state, cfg)
    read = np.full((ctl.n, 4), -7, np.int64)
    _host_global(lib, "host_global_window", planes, cfgs, sums, ctl,
                 ctypes.c_longlong(now), read, ctypes.c_int(backward),
                 ctypes.c_longlong(2 * ctl.n if threads is None else threads))
    return planes, cfgs, read, (sums,)


def _host_per_op(lib, state, cfg, ctl, now, backward=0):
    """global_apply.cu's global_stage, the torch replica reads on the staged
    arena, then its global_apply, on copies: (state, cfg, read,
    scratches)."""
    planes, cfgs, sums = _arena_copies(state, cfg)
    _host_global(lib, "host_global_stage", planes, cfgs, sums, ctl)
    read = gk.global_read_block(
        tk.BucketState(*[torch.from_numpy(p) for p in planes]), ctl,
        now).numpy()
    _host_global(lib, "host_global_apply", planes, cfgs, sums, ctl,
                 ctypes.c_longlong(now), ctypes.c_int(backward))
    return planes, cfgs, read, (sums,)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_host_global_kernel_matches_oracle(host_global, case, seed):
    """global_window.cu's device code on the inputs of
    tests/test_torch_global.py (all five algorithms and out-of-range
    values, int64 values wrapped at both ends, expired rows, algorithm
    switches, is_init, zero sums, pad and out-of-range slots), the sums
    carried as one contributing lane per row: the arena, updated in place,
    and every valid read lane equal kernel.global_combined, pads answer 0,
    and the scratch comes back all zero."""
    algos, wrap = CASES[case]
    state, cfg, batch, summed = global_inputs(
        np.random.default_rng(100 + seed), algos, wrap)
    ctl = summed_control(batch, summed)
    js = jk.BucketState(**{k: jnp.asarray(v) for k, v in state.items()})
    jc = jk.GlobalConfig(**{k: jnp.asarray(v) for k, v in cfg.items()})
    jb = jk.WindowBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    w_state, w_out = jk.global_combined(js, jc, jb, jnp.asarray(summed),
                                        jnp.int64(T0))
    n = batch["slot"].shape[0]
    valid = batch["slot"] >= 0
    for backward in (0, 1):
        new, cfgs, read, (sums,) = _host_window(host_global, state, cfg, ctl,
                                                T0, backward)
        tag = f"{case} backward={backward}"
        for f, a, b in zip(jk.BucketState._fields, new, w_state):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{tag} state.{f}")
        for f, a in zip(jk.GlobalConfig._fields, cfgs):
            np.testing.assert_array_equal(a, cfg[f], err_msg=f"{tag} cfg.{f}")
        assert not sums.any(), "the scratch is not back at zero"
        read = read[:n]
        for i, f in enumerate(jk.WindowOutput._fields):
            np.testing.assert_array_equal(
                read[valid, i], np.asarray(w_out[i]).astype(np.int64)[valid],
                err_msg=f"{tag} read.{f}")
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
            ctypes.c_longlong(C), _ptr(status), *[_ptr(o) for o in outs], 1)
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


def _host_window_math(lib, prep, now, tile):
    """window_math.cu's kernel on one window's port prep ([B] lanes), in
    CTAs of `tile` lanes."""
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
                         *[_ptr(a) for a in lanes + reg + out + fin], tile)
    return out, fin


def _tile_edge_window(B, C):
    """numpy WindowBatch fields of one window whose segments sit across
    the tiles: sorted, a 3-lane replayed run (lanes 0-2), a 10-lane folded
    run (3-12, across the 7-lane tiles' edge at 7), a 9-lane replayed run
    (13-21, across 14), eight 3-lane replayed runs (22-45, eight walkers in
    one 64-lane tile), a lone lane (46), a 6-lane folded run of reads on
    row 12 (47-52, across 49), and pads; the lanes arrive in sorted
    order."""
    runs = ([(0, [1, 2, 3])], [(1, [1] * 10)], [(2, [2, 1, 1, 0, 3, 1, 1, 2, 1])],
            [(3 + j, [1, 2, 1]) for j in range(8)], [(11, [1])], [(12, [0] * 6)])
    slot, hits = [], []
    for group in runs:
        for sl, hs in group:
            slot += [sl] * len(hs)
            hits += hs
    n = len(slot)
    slot = np.asarray(slot + [-1] * (B - n), np.int32)
    hits = np.asarray(hits + [0] * (B - n), np.int64)
    algo = np.where(slot % 3 == 0, jk.LEAKY_BUCKET, jk.TOKEN_BUCKET)
    limit = np.where(slot == 12, 100, 7)
    # the first folded run starts fresh, so it folds whatever its row
    # holds; the second reads a live leaky row (LEAKY_ROW)
    is_init = np.zeros(B, bool)
    is_init[3] = True
    return jk.WindowBatch(slot=slot, hits=hits, limit=limit.astype(np.int64),
                          duration=np.full(B, 60_000, np.int64),
                          algo=algo.astype(np.int32), is_init=is_init)


def _leaky_row(now):
    """Row 12 before _tile_edge_window: a live leaky bucket that leaks 2 a
    window of reads and is 90 short of its limit, so each read of the
    run enters with its own balance."""
    return dict(limit=100, duration=60_000, remaining=10, tstamp=now - 1200,
                expire=now + 50_000, algo=jk.LEAKY_BUCKET)


# lanes a CTA of the host build: one lane, a width no segment lines up
# with, part of the window, the whole window (MATH_B)
MATH_B = 96
MATH_TILES = [1, 7, 64, MATH_B]


@pytest.mark.parametrize("tile", MATH_TILES)
@pytest.mark.parametrize("wide", [False, True], ids=["compact", "int64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_window_math_matches_oracle(host_math, seed, wide, tile):
    """window_math.cu's device code in CTAs of `tile` lanes, run last CTA
    first, over eight chained windows of 96 lanes (all five algorithms and
    out-of-range values, hot runs that fold and runs that replay, AGG
    lanes, inits, pads, slots past the arena beside row C - 1, a clock that
    steps backwards; `int64` at full int64 range) and a ninth whose folded
    and replayed runs cross the tiles' edges, with eight walkers in one
    tile: its responses and final registers equal kernel.window_math on
    the same prep at every valid lane (pads 0, fin their register), and
    committed with kernel.window_commit the window equals
    kernel.window_step."""
    rng = np.random.default_rng(450 + seed + 10 * wide)
    C, B = 32, MATH_B
    jst = per_op_state(rng, C, T0, wide)
    tst = tk.BucketState(*[_tt(a) for a in jst])
    clock = per_op_clock(rng, 8)
    clock = np.append(clock, clock[-1] + 1000)
    for w, now in enumerate(clock):
        now = int(now)
        if w < len(clock) - 1:
            bt = per_op_window(rng, B, C, wide)
        else:
            bt = _tile_edge_window(B, C)
            for f, v in _leaky_row(now).items():
                getattr(tst, f)[12] = v
                jst = jst._replace(**{f: getattr(jst, f).at[12].set(v)})
        tbt = tk.WindowBatch(*[_tt(a) for a in bt])
        prep = tk.window_prep(tst, tbt, _tt(np.int64(now)))
        if w == len(clock) - 1:
            fold = prep.seg_fold.numpy()
            assert fold[3:13].all() and not fold[:3].any()
            assert fold[47:53].all()
            assert not fold[13:46].any() and prep.max_pos == 8
        out, fin = _host_window_math(host_math, prep, now, tile)
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


@pytest.mark.parametrize("backward", [0, 1], ids=["forward", "backward"])
@pytest.mark.parametrize("case", list(CASES))
def test_host_global_apply_matches_oracle(host_apply, case, backward):
    """global_apply.cu's device code (global_stage, then global_apply) on
    tests/test_torch_global.py's edge inputs (all five algorithms and
    out-of-range values, int64 wrapped at both ends, expired rows,
    switches, zero sums) at G = 64 and at 37 rows, each row's sum split
    over three lanes (three shards, wrapping at int64's ends): the arena,
    updated in place, equals kernel.global_apply whichever lane of a slot
    applies it (phase C's lanes run forward or backward), and the scratch
    comes back all zero."""
    algos, wrap = CASES[case]
    for g in (G, 37):
        rng = np.random.default_rng(300 + g)
        state, cfg, _, summed = global_inputs(rng, algos, wrap, G=g)
        parts = rng.integers(-2**62, 2**62, (2, g))
        lanes = np.concatenate([parts[0], parts[1], summed - parts[0]
                                - parts[1]])
        rows = np.tile(np.arange(g, dtype=np.int32), 3)
        batch = dict(slot=rows, hits=np.zeros(3 * g, np.int64),
                     limit=np.zeros(3 * g, np.int64),
                     duration=np.zeros(3 * g, np.int64),
                     algo=np.zeros(3 * g, np.int32),
                     is_init=np.zeros(3 * g, bool))
        ctl = gk.make_control(
            tk.WindowBatch(*[batch[f] for f in tk.WindowBatch._fields]),
            lanes, (np.full(1, g, np.int32), np.zeros(1, np.int64),
                    np.zeros(1, np.int64), np.zeros(1, np.int32),
                    np.full(1, g, np.int32)), "cpu")
        st, cfgs, sums = _arena_copies(state, cfg)
        _host_global(host_apply, "host_global_stage", st, cfgs, sums, ctl)
        np.testing.assert_array_equal(sums, summed)
        _host_global(host_apply, "host_global_apply", st, cfgs, sums, ctl,
                     ctypes.c_longlong(T0), ctypes.c_int(backward))
        want = jk.global_apply(
            jk.BucketState(**{k: jnp.asarray(v) for k, v in state.items()}),
            jk.GlobalConfig(**{k: jnp.asarray(v) for k, v in cfg.items()}),
            jnp.asarray(summed), jnp.int64(T0))
        for f, a, b in zip(jk.BucketState._fields, st, want):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{case} G={g} {f}")
        assert not sums.any(), "the scratch is not back at zero"


def _edge_lanes(G, S, Bg, entries):
    """numpy (gbatch [S, Bg], gacc [S, Bg]): pads (slot -1) but for
    entries (shard, lane, slot, hits, gacc, limit, duration, algo,
    is_init)."""
    gb = dict(slot=np.full((S, Bg), -1, np.int32),
              hits=np.zeros((S, Bg), np.int64),
              limit=np.zeros((S, Bg), np.int64),
              duration=np.zeros((S, Bg), np.int64),
              algo=np.zeros((S, Bg), np.int32),
              is_init=np.zeros((S, Bg), bool))
    gacc = np.zeros((S, Bg), np.int64)
    for s_, ln, slot, hits, acc, limit, dur, algo, init in entries:
        for k, v in (("slot", slot), ("hits", hits), ("limit", limit),
                     ("duration", dur), ("algo", algo), ("is_init", init)):
            gb[k][s_, ln] = v
        gacc[s_, ln] = acc
    return tk.WindowBatch(*[gb[f] for f in tk.WindowBatch._fields]), gacc


def _edge_upd(G, Kg, writes=(), resets=()):
    upd = (np.full(Kg, G, np.int32), np.zeros(Kg, np.int64),
           np.zeros(Kg, np.int64), np.zeros(Kg, np.int32),
           np.full(Kg, G, np.int32))
    for i, (slot, limit, dur, algo) in enumerate(writes):
        upd[0][i], upd[1][i], upd[2][i], upd[3][i] = slot, limit, dur, algo
    for i, slot in enumerate(resets):
        upd[4][i] = slot
    return upd


def _live_arena(G, now):
    """numpy (state, cfg): every row live until now + 30 s, token bucket,
    limit 10, 4 remaining; the config the rows' own."""
    state = dict(limit=np.full(G, 10, np.int64),
                 duration=np.full(G, 60_000, np.int64),
                 remaining=np.full(G, 4, np.int64),
                 tstamp=np.full(G, now + 30_000, np.int64),
                 expire=np.full(G, now + 30_000, np.int64),
                 algo=np.zeros(G, np.int32))
    cfg = dict(limit=state["limit"].copy(), duration=state["duration"].copy(),
               algo=state["algo"].copy())
    return state, cfg


def _edge_window(kind, now):
    """(state, cfg, (gbatch, gacc, upd)) of one GLOBAL edge window."""
    G, S, Bg, Kg = (1, 2, 3, 3) if kind == "g1" else (16, 4, 4, 6)
    state, cfg = _live_arena(G, now)
    lane = lambda s_, ln, slot, hits, acc=None, limit=10, algo=0, init=False: (  # noqa: E731
        s_, ln, slot, hits, hits if acc is None else acc, limit, 60_000,
        algo, init)
    if kind == "reset_and_read":
        # row 3 is reset and rewritten in the window its lanes read, from
        # three shards (the reads take the init path: expire is 0)
        lanes = [lane(0, 0, 3, 2), lane(1, 0, 3, 1), lane(3, 2, 3, 0),
                 lane(2, 1, 5, 1)]
        upd = _edge_upd(G, Kg, [(3, 7, 9_000, 0)], [3])
    elif kind == "algo_switch":
        # a config write turns live token row 6 leaky; its lanes still ask
        # token (read: algo matches the row, no init) and leaky
        lanes = [lane(0, 0, 6, 1), lane(1, 0, 6, 2, algo=1),
                 lane(2, 3, 6, 0, algo=1)]
        upd = _edge_upd(G, Kg, [(6, 20, 4_000, 1), (-G + 9, 3, 5_000, 1)])
    elif kind == "expired_refresh":
        # rows 8 and 9 expired before the window: their reads take the init
        # path while their sums refresh them (the apply moves expire past
        # now, so a read after it would answer otherwise)
        state["expire"][[8, 9]] = now - 5
        lanes = [lane(0, 0, 8, 1), lane(1, 1, 8, 2), lane(2, 2, 9, 3),
                 lane(3, 3, 9, 0, acc=1)]
        upd = _edge_upd(G, Kg)
    elif kind == "cancel":
        # a CONCURRENCY release beside a hit on row 2 sums to 0 (the row
        # stays as it is); row 4's sum cancels then grows again
        state["algo"][[2, 4]] = 4
        cfg["algo"][[2, 4]] = 4
        lanes = [lane(0, 0, 2, 3, algo=4), lane(1, 0, 2, -3, algo=4),
                 lane(0, 1, 4, 2, algo=4), lane(2, 0, 4, -2, algo=4),
                 lane(3, 0, 4, 1, algo=4), lane(3, 1, 4, 5, acc=0, algo=4)]
        upd = _edge_upd(G, Kg)
    elif kind == "shards_one_slot":
        # every shard's lanes on row 5, most contributing
        lanes = [lane(s_, ln, 5, (s_ + ln) % 3, acc=(s_ * ln) % 2)
                 for s_ in range(S) for ln in range(Bg)]
        upd = _edge_upd(G, Kg, [(5, 12, 60_000, 0)], [])
    elif kind == "pads":
        # read lanes below 0 and at G and past it, contributing or not;
        # config writes and resets below -G, at G and past it
        lanes = [lane(0, 0, -1, 2), lane(0, 1, -5, 1), lane(1, 0, G, 3),
                 lane(1, 1, G + 4, 1), lane(2, 0, -G - 1, 1),
                 lane(2, 1, 7, 1), lane(3, 3, G - 1, 2)]
        upd = _edge_upd(G, Kg, [(-G - 1, 1, 1, 1), (G, 2, 2, 1),
                                (G + 3, 3, 3, 1), (-1, 9, 6_000, 0)],
                        [-G - 2, G, G + 9, -G])
    else:  # g1: one row; lanes on it, below it and past it
        lanes = [lane(0, 0, 0, 1), lane(1, 0, -1, 1), lane(0, 1, 1, 2),
                 lane(1, 2, 0, 3)]
        upd = _edge_upd(G, Kg, [(-1, 5, 2_000, 0)], [-2, 1])
    gbatch, gacc = _edge_lanes(G, S, Bg, lanes)
    return state, cfg, (gbatch, gacc, upd)


EDGE_WINDOWS = ("reset_and_read", "algo_switch", "expired_refresh", "cancel",
                "shards_one_slot", "pads", "g1")


@pytest.mark.parametrize("path", ["window", "per_op"])
@pytest.mark.parametrize("kind", EDGE_WINDOWS)
def test_host_global_phases_match_oracle_on_edge_windows(host_global,
                                                         host_apply, kind,
                                                         path):
    """global_window.cu's three segments (path "window") as a launch of 2n
    threads, of 1 and of 5 runs them (a thread per read and per apply
    lane; every item on one thread; threads taking several items), the
    threads of a segment forward and backward, and global_apply.cu's
    global_stage, the torch reads and global_apply ("per_op"), phase C's
    lanes forward and backward, against the JAX
    engine's composition (_apply_config, global_accumulate summed over the
    shards, global_combined or global_read + global_apply) on edge
    windows: a slot reset and read in the same window, a config write that
    switches a live row's algorithm, expired rows read and refreshed in
    one window, sums that cancel to 0, lanes from
    every shard on one slot, pads below 0 and at G or above in every lane
    kind, and G = 1.  Bit for bit on every plane and read; the scratch is
    all zero after every call."""
    now = T0 + 77
    state, cfg, ctl_np = _edge_window(kind, now)
    want = jax_window(state, cfg, *ctl_np, now, per_op=path == "per_op")
    ctl = gk.make_control(*ctl_np, "cpu")
    runs = ([(backward, threads) for backward in (0, 1)
             for threads in (None, 1, 5)] if path == "window"
            else [(0, None), (1, None)])
    for backward, threads in runs:
        if path == "window":
            st, cf, read, sums = _host_window(host_global, state, cfg, ctl,
                                              now, backward, threads)
        else:
            st, cf, read, sums = _host_per_op(host_apply, state, cfg, ctl,
                                              now, backward)
        tag = f"{kind} {path} backward={backward} threads={threads}"
        assert_window(st, cf, read, want, tag)
        for sm in sums:
            assert not sm.any(), f"{tag}: the scratch is not back at zero"


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


def _host_stats_drain(lib, arena, packed, nows, tenants, acc, P=1):
    """One host stats drain over S shards and P partitions: arena [S, C]
    numpy planes, packed [K, S, B, 2], tenants [K, S, B]; acc a dict of
    the accumulator's numpy arrays, added to in place."""
    K, S, B = packed.shape[:3]
    words = np.zeros((K, S, B), np.int64)
    limits = np.zeros((K, S, B), np.int64)
    mism = _flags(K, S)
    packed = np.ascontiguousarray(packed, np.int64)
    lib.host_drain_compact_stats(
        _ptr(packed), _ptr(np.ascontiguousarray(nows, np.int64)), K, S, B,
        *[_ptr(a) for a in arena], ctypes.c_longlong(arena[0].shape[1]),
        _ptr(words), _ptr(limits), _ptr(mism),
        _ptr(np.ascontiguousarray(tenants, np.int32)),
        acc["tenant"].shape[1], _ptr(acc["index"]), _ptr(acc["entries"]),
        _ptr(acc["count"]), _ptr(acc["tenant"]), _ptr(acc["header"]),
        ctypes.c_longlong(acc["entries"].shape[1]), P)
    return words


def _host_finish(lib, sketch, acc, expire, now, decay, topk, ow, X,
                 key_cap=None, sketch_smem=1):
    """The host finisher, with `key_cap` rank keys in shared memory (None:
    the entry capacity, as the card's default) and the sketch worked on
    in shared memory (sketch_smem 1) or in place (0)."""
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
        _ptr(stats), X,
        acc["entries"].shape[1] if key_cap is None else key_cap, sketch_smem)
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


# accumulators filled directly, for the finisher's rank:
# (entries a shard, topk, C, sketch width, sketch start, weights[, rank
# keys in shared memory, sketch in shared memory])
FINISH_CASES = {
    # more entries than the shared memory's keys: rebuilt every pass, the
    # sketch worked on in place
    "keys_past_shared": (70, 8, 128, 16, "flat", "few", 32, 0),
    # many entries share the topk-th estimate: ties to the lower row
    "ties": (40, 6, 64, 16, "flat", "few"),
    # more candidates in the topk-th key's first byte than the shared list
    # holds: the select goes on into the rows' bytes
    "deep_select": (1500, 20, 4096, 64, "flat", "few"),
    "empty": (0, 6, 64, 32, "random", "few"),
    "topk_over_n": (5, 9, 64, 32, "random", "few"),
    # more chosen entries than the shared list holds (kSelCap = 256),
    # beside entries whose estimate is below 0
    "past_shared_list": (400, 280, 512, 64, "few_negative", "spread"),
    # estimates below 0 (a negative sketch start) never rank
    "negative": (30, 20, 64, 32, "negative", "few"),
    # estimates near 2^62: the select runs over eight bytes of them
    "wide": (50, 7, 1 << 17, 48, "huge", "spread"),
}


def _filled_acc(rng, S, C, T, n, weights):
    """An accumulator (numpy, _acc's arrays) holding n touched rows a shard,
    as the stats drain leaves it."""
    acc = _acc(S, C, T, max(n, 1))
    for s in range(S):
        rows = rng.choice(C, n, replace=False)
        if weights == "few":
            hits = rng.choice([3, 3, 3, 7], n)
            over = rng.choice([0, 0, 1], n)
        else:
            hits = rng.integers(0, 1 << 20, n)
            over = rng.integers(0, 4, n)
        acc["entries"][s, :n] = np.stack(
            [rows, rng.integers(1, 4, n), over, hits], axis=-1)
        acc["index"][s, rows] = np.arange(1, n + 1)
        acc["count"][s] = n
        acc["tenant"][s] = rng.integers(0, 50, (T, 3))
        acc["header"][s] = [n + 9, 400, 3, 2]
    return acc


def _jax_finish(sketch, acc, s, expire, now, decay, topk, ow):
    """The JAX package's staged_stats_tail over shard s of a filled
    accumulator, from the dense i32 planes (hits as lo/hi pairs) its TPU
    drain kernel leaves."""
    C = acc["index"].shape[1]
    T = acc["tenant"].shape[1]
    n = int(acc["count"][s])
    rows, occ, over, hits = acc["entries"][s, :n].T
    d = {k: np.zeros(C, np.int64) for k in ("occ", "over", "hits")}
    d["occ"][rows], d["over"][rows], d["hits"][rows] = occ, over, hits

    def pair(x):
        p = np.ascontiguousarray(x, np.int64).view(np.int32).reshape(-1, 2)
        return jnp.asarray(p[:, 0]), jnp.asarray(p[:, 1])

    t = acc["tenant"][s]
    lanes, h, o, inits = acc["header"][s]
    hdr = np.zeros(8, np.int32)
    hdr[0], hdr[3], hdr[4] = lanes, o, inits
    hdr[1:3] = np.asarray([h], np.int64).view(np.int32)
    planes = (jnp.asarray(d["occ"].astype(np.int32)),
              jnp.asarray(d["over"].astype(np.int32)), *pair(d["hits"]),
              jnp.asarray(t[:, 0].astype(np.int32)),
              jnp.asarray(t[:, 2].astype(np.int32)), *pair(t[:, 1]),
              jnp.asarray(hdr))
    return ja.staged_stats_tail(
        jnp.asarray(sketch[s]), planes, jnp.asarray(expire[s]), now, decay,
        tenant_slots=T, topk=topk, over_weight=ow)


def _host_finish_matches_jax(finish_lib, case, X):
    """The host finisher on a filled accumulator against the JAX package's
    staged_stats_tail, shard by shard; the case's shape checked on the
    JAX side's estimates."""
    n, topk, C, W, start, weights, *layout = FINISH_CASES[case]
    rng = np.random.default_rng(990 + X + 7 * len(case))
    S, T, D, ow, now = 2, 4, 3, 4, T0
    acc = _filled_acc(rng, S, C, T, n, weights)
    lo, hi = {"flat": (6, 7), "random": (0, 100), "few_negative": (0, 1),
              "negative": (-(1 << 40), 1 << 40),
              "huge": (0, 1 << 62)}[start]
    sketch = rng.integers(lo, hi, (S, D, W)).astype(np.int64)
    if start == "few_negative":
        sketch[rng.random((S, D, W)) < 0.05] = -(1 << 40)
    expire = now + rng.integers(-5000, 5000, (S, C))
    expire[rng.random((S, C)) < 0.2] = 0
    want = [_jax_finish(sketch, acc, s, expire, now, 1, topk, ow)
            for s in range(S)]
    stats = _host_finish(finish_lib, sketch, acc, expire, now, 1, topk, ow,
                         X, *layout)
    for s, (want_sk, want_st) in enumerate(want):
        np.testing.assert_array_equal(sketch[s], np.asarray(want_sk),
                                      err_msg=f"{case} s{s} sketch")
        np.testing.assert_array_equal(stats[s], np.asarray(want_st),
                                      err_msg=f"{case} s{s} stats")
        rows = acc["entries"][s, :n, 0]
        est = np.min([np.asarray(want_sk)[r][ja.hash_slots(np, rows, r, W)]
                      for r in range(D)], axis=0) if n else np.zeros(0)
        ranked = np.sort(est[est >= 0])[::-1]
        if case == "ties":
            assert ranked[topk] == ranked[topk - 1]
        elif case == "deep_select":
            assert (ranked >> 8 == ranked[topk - 1] >> 8).sum() > 256
        elif case == "keys_past_shared":
            assert n > layout[0] and ranked.size > topk
        elif case == "topk_over_n" or case == "empty":
            assert ranked.size < topk
        elif case == "past_shared_list":
            assert ranked.size > topk > 256 and (est < 0).any()
        elif case == "negative":
            assert (est < 0).any() and ranked.size < topk
        elif case == "wide":
            assert ranked[0] >= 1 << 56
    for name in ("index", "count", "tenant", "header", "ecount", "edone"):
        assert not acc[name].any(), f"{case} {name} left set"


@pytest.mark.parametrize("case", ["drains", *FINISH_CASES])
@pytest.mark.parametrize("X", [1, 3])
def test_host_stats_kernels_match_oracle(host_stats, X, case):
    """`drains`: three carried drains over S = 3 shards (shard 1 all
    padding on the second), a decay drain, a non-zero starting sketch, X
    expiry slices per shard: the host stats drain's words, limits, flags
    and arena equal the plain drain's oracle, and the host finisher's
    sketch and stats equal oracle_stats over those words, shard by shard;
    every accumulator array is zero again after each finish.  The other
    cases fill the accumulator directly (FINISH_CASES: ties at the topk-th
    estimate, with the rank keys and the sketch in shared memory and
    both past it, a select that needs the rows' bytes, no entries, topk past the entries, more chosen entries
    than the shared list holds, estimates below 0, estimates near 2^62)
    and hold the finisher against the JAX package's staged_stats_tail."""
    drain_lib, finish_lib = host_stats
    if case != "drains":
        _host_finish_matches_jax(finish_lib, case, X)
        return
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


# ---------------------------------------------------------------------------
# the slot-partitioned grid: P CTAs a shard, each owning the rows that hash
# to it (the host build runs the P x S CTAs in turn)

# P = 1; a few partitions; more partitions than the windows' distinct rows
GRID_P = [1, 2, 5, 40]


def _segment_lanes(rng, n, hot):
    """n lanes on slot `hot`, in arrival order, cut into virtual segments
    by is_init lanes: each segment either uniform (one config, every
    nonzero hit equal: it folds) or mixed (configs, hits and AGG lanes
    drawn per lane: it replays), algorithms 0..7 (5..7 take the token
    ladder)."""
    cols = dict(slot=[], hits=[], limit=[], duration=[], algo=[], init=[])
    while len(cols["slot"]) < n:
        m = min(n - len(cols["slot"]), int(rng.integers(1, 9)))
        a = int(rng.integers(0, 8))
        lim, dur = int(rng.integers(1, 40)), int(rng.integers(10, 3000))
        uniform = rng.random() < 0.5
        h = int(rng.integers(1, 4))
        if a == jk.CONCURRENCY and rng.random() < 0.5:
            h = -h
        for i in range(m):
            if not uniform:
                a = int(rng.integers(0, 8))
                lim, dur = int(rng.integers(1, 40)), int(rng.integers(10, 3000))
                h = int(rng.integers(1, 6))
                if a == jk.CONCURRENCY and rng.random() < 0.4:
                    h = -h
            hits = 0 if rng.random() < 0.3 else h
            agg = (not uniform and a <= 1 and hits > 0
                   and rng.random() < 0.3)
            cols["slot"].append(hot | (jk.AGG_SLOT_BIT if agg else 0))
            cols["hits"].append(hits)
            cols["limit"].append(lim)
            cols["duration"].append(dur)
            cols["algo"].append(a)
            cols["init"].append(i == 0 and rng.random() < 0.9)
    return cols


def _segmented_drain(rng, K, B, C, n_hot=56):
    """K windows of B lanes: n_hot lanes on one hot slot cut into many
    virtual segments (_segment_lanes), the rest on other slots or
    padding; arena rows under all eight wire algorithms with clocks
    around the windows', and a window clock that steps back."""
    st0 = jk.BucketState(
        limit=jnp.asarray(rng.integers(1, 40, C).astype(np.int64)),
        duration=jnp.asarray(rng.integers(10, 3000, C).astype(np.int64)),
        remaining=jnp.asarray(rng.integers(0, 45, C).astype(np.int64)),
        tstamp=jnp.asarray(T0 + rng.integers(-3_000, 3_000, C)),
        expire=jnp.asarray(T0 + rng.integers(-500, 3_000, C)),
        algo=jnp.asarray(rng.integers(0, 8, C).astype(np.int32)))
    packs = []
    for _ in range(K):
        hot = int(rng.integers(0, C))
        seg = _segment_lanes(rng, n_hot, hot)
        slot = rng.integers(0, C, B).astype(np.int32)
        slot[rng.random(B) < 0.1] = jk.PAD_SLOT
        algo = rng.integers(0, 5, B).astype(np.int32)
        hits = rng.integers(0, 4, B).astype(np.int64)
        limit = rng.integers(1, 40, B).astype(np.int64)
        duration = rng.integers(10, 3000, B).astype(np.int64)
        is_init = rng.random(B) < 0.05
        at = np.sort(rng.choice(B, n_hot, replace=False))
        slot[at] = seg["slot"]
        hits[at] = seg["hits"]
        limit[at] = seg["limit"]
        duration[at] = seg["duration"]
        algo[at] = seg["algo"]
        is_init[at] = seg["init"]
        packs.append(np.asarray(jk.encode_batch_host(
            slot, hits, limit, duration, algo, is_init)))
    nows = np.asarray([T0 + 500, T0 + 200, T0 + 900][:K], np.int64)
    return st0, np.stack(packs), nows


@pytest.mark.parametrize("P", GRID_P)
def test_host_drain_many_virtual_segments_over_partitions(host_kernel, P):
    """A hot run cut into many virtual segments by is_init lanes, folded
    and replayed segments mixed, algorithm values past 4, a clock that
    steps back, over P partitions: every output, flag and plane equals
    the oracle's, whose every segment enters from the row as the window
    found it."""
    rng = np.random.default_rng(900)
    for rep in range(4):
        st0, packed, nows = _segmented_drain(rng, 3, 96, 16)
        _assert_host_drain(host_kernel, st0, packed, nows, f"P{P} r{rep}", P)


def _hot_fold_drain(rng, C, hot):
    """Five windows, one an algorithm (token, leaky, GCRA, sliding,
    concurrency releases), each with a 64-lane run on slot `hot` under
    the row's own config, three leading zero-hit lanes, every other hit
    equal, beside 32 lanes elsewhere; the row's clock is behind every
    window's, and its balance lets most of the run through, so a lane's
    count of earlier hits moves its answer."""
    limit = np.full(C, 1000, np.int64)
    duration = np.full(C, 60_000, np.int64)
    st0 = jk.BucketState(
        limit=jnp.asarray(limit), duration=jnp.asarray(duration),
        remaining=jnp.asarray(np.full(C, 100, np.int64)),
        tstamp=jnp.asarray(np.full(C, T0 - 1_000, np.int64)),
        expire=jnp.asarray(np.full(C, T0 + 50_000, np.int64)),
        algo=jnp.asarray(np.zeros(C, np.int32)))
    packs, B = [], 96
    for a, h in [(0, 1), (1, 2), (2, 1), (3, 1), (4, -2)]:
        slot = np.full(B, hot, np.int32)
        other = np.zeros(B, bool)
        other[rng.choice(B, 32, replace=False)] = True
        slot[other] = rng.integers(0, C, 32)
        slot[other & (slot == hot)] = (hot + 1) % C
        run = np.flatnonzero(~other)
        hits = np.where(rng.random(B) < 0.2, 0, h).astype(np.int64)
        hits[run[:3]] = 0
        algo = np.full(B, a, np.int32)
        hits[other] = rng.integers(0, 3, 32)
        algo[other] = rng.integers(0, 4, 32)
        packs.append(np.asarray(jk.encode_batch_host(
            slot, hits, np.full(B, 1000, np.int64), np.full(B, 60_000, np.int64),
            algo, np.zeros(B, bool))))
    return st0, np.stack(packs), np.asarray(
        [T0 + 10 * (k + 1) for k in range(5)], np.int64)


@pytest.mark.parametrize("P", GRID_P)
def test_host_drain_folds_a_64_lane_hot_run(host_kernel, P):
    """A 64-lane run that folds in every window (the port's prep says
    so), three leading zero-hit lanes, and CONCURRENCY releases in the
    last: each lane answers from its own closed-form entering register,
    bit for bit the oracle's, over P partitions."""
    C, hot = 16, 5
    st0, packed, nows = _hot_fold_drain(np.random.default_rng(901), C, hot)
    # the hot run folds in every window of the chained oracle
    st = tk.BucketState(*[_tt(a) for a in st0])
    for k in range(packed.shape[0]):
        bt = tk.decode_batch(_tt(packed[k]))
        prep = tk.window_prep(st, bt, _tt(np.int64(nows[k])))
        on_hot = (prep.s_slot == hot).numpy()
        assert on_hot.sum() == 64
        assert prep.seg_fold.numpy()[on_hot].all(), f"window {k} replays"
        st, _ = tk.window_step(st, bt, _tt(np.int64(nows[k])))
    _assert_host_drain(host_kernel, st0, packed, nows, f"P{P}", P)


@pytest.mark.parametrize("P", [2, 3, 8, 40])
@pytest.mark.parametrize("entry", ["drain_compact", "window_full"])
def test_host_drain_routes_row_c_minus_1_and_past_the_arena_together(
        host_kernel, entry, P):
    """Lanes on slot C - 1 (hits, so the row is committed) and lanes on
    ten slots past the arena (they read row C - 1 as the window found
    it) in one window, over P > 1 partitions: all of them route to the
    partition of row C - 1, so no read sees the window's commit however
    the CTAs are ordered; a routing on the raw slot would put some past
    the arena in a later CTA than the commit."""
    C, B = 8, 40
    rng = np.random.default_rng(902)
    st0 = jk.BucketState(
        limit=jnp.full(C, 5, jnp.int64), duration=jnp.full(C, 60_000, jnp.int64),
        remaining=jnp.full(C, 5, jnp.int64),
        tstamp=jnp.full(C, T0 + 60_000, jnp.int64),
        expire=jnp.full(C, T0 + 60_000, jnp.int64),
        algo=jnp.zeros(C, jnp.int32))
    slot = np.full(B, C - 1, np.int32)
    slot[10:20] = C + np.arange(10) * 7
    slot[20:30] = rng.integers(0, C - 1, 10)
    slot[30:] = jk.PAD_SLOT
    rng.shuffle(slot)
    cols = [slot, np.ones(B, np.int64), np.full(B, 5, np.int64),
            np.full(B, 60_000, np.int64), np.zeros(B, np.int32),
            np.zeros(B, np.uint8)]
    want_st, want = _jstep(st0, jk.WindowBatch(
        *[jnp.asarray(c) for c in cols[:5]], jnp.asarray(cols[5] != 0)),
        jnp.int64(T0))
    past = slot >= C
    # every lane past the arena sees the row before the window: 5 - 1
    assert (np.asarray(want.remaining)[past] == 4).all()
    if entry == "drain_compact":
        packed = np.asarray(jk.encode_batch_host(*cols[:5], cols[5] != 0))
        got_st, words, limits, _ = _host_drain(host_kernel, st0, packed[None],
                                               np.asarray([T0]), P)
        valid = slot >= 0
        want_words = np.asarray(jk.encode_output_word(want, jnp.int64(T0)))
        np.testing.assert_array_equal(words[0][valid], want_words[valid])
        np.testing.assert_array_equal(limits[0][valid],
                                      np.asarray(want.limit)[valid])
        assert not words[0][~valid].any()
    else:
        got_st = _planes(st0)
        status = np.full(B, -7, np.int32)
        outs = [np.full(B, -7, np.int64) for _ in range(3)]
        host_kernel.host_window_full(
            *[_ptr(np.ascontiguousarray(c)) for c in cols],
            ctypes.c_longlong(T0), 1, B, *[_ptr(a) for a in got_st],
            ctypes.c_longlong(C), _ptr(status), *[_ptr(o) for o in outs], P)
        valid = slot >= 0
        for name, got, exp in zip(jk.WindowOutput._fields, [status] + outs,
                                  want):
            np.testing.assert_array_equal(got[valid], np.asarray(exp)[valid],
                                          err_msg=name)
            assert not got[~valid].any(), f"{name} pad lanes"
    for f, a, b in zip(jk.BucketState._fields, got_st, want_st):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"state.{f}")


def _acc_dense(acc, C):
    """An accumulator's content whatever the order of its entries: per
    shard, {row: (lanes, over, hits)}, and the count, tenant and header
    arrays; every index entry must point at its row's entry."""
    rows = []
    for s in range(acc["count"].shape[0]):
        n = int(acc["count"][s])
        ent = acc["entries"][s, :n]
        d = {int(e[0]): tuple(int(x) for x in e[1:]) for e in ent}
        assert len(d) == n, f"shard {s}: a row has two entries"
        idx = acc["index"][s]
        for k, e in enumerate(ent):
            assert idx[e[0]] == k + 1, f"shard {s} row {e[0]} index"
        assert (idx != 0).sum() == n
        rows.append(d)
    return rows, acc["count"].copy(), acc["tenant"].copy(), \
        acc["header"].copy()


@pytest.mark.parametrize("P", [2, 5, 24])
def test_host_stats_drain_entries_from_several_ctas(host_stats, P):
    """The stats drain over P partitions, so several CTAs append entries
    to one shard's accumulator and add into its tenant rows and header:
    its words and arena equal the P = 1 drain's, its accumulator holds
    the same sums whatever the order of the entries, and the finisher
    turns it into oracle_stats' vector on every shard."""
    drain_lib, finish_lib = host_stats
    rng = np.random.default_rng(903)
    S, K, B, C, T, topk, D, W = 3, 3, 48, 24, 5, 6, 4, 16
    shards = [_release_drain(rng, K, B, C, T) for _ in range(S)]
    packed = np.stack([d[1] for d in shards], axis=1)
    tenants = np.stack([d[3] for d in shards], axis=1)
    nows = shards[0][2]
    base = [np.ascontiguousarray(np.stack(p))
            for p in zip(*[_planes(d[0]) for d in shards])]
    runs = {}
    for p in (1, P):
        arena = [a.copy() for a in base]
        acc = _acc(S, C, T, K * B)
        words = _host_stats_drain(drain_lib, arena, packed, nows, tenants,
                                  acc, p)
        runs[p] = (arena, acc, words)
    (a1, acc1, w1), (ap, accp, wp) = runs[1], runs[P]
    np.testing.assert_array_equal(wp, w1)
    for f, x, y in zip(jk.BucketState._fields, ap, a1):
        np.testing.assert_array_equal(x, y, err_msg=f"state.{f}")
    for got, want in zip(_acc_dense(accp, C), _acc_dense(acc1, C)):
        if isinstance(got, list):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)
    sketch = rng.integers(0, 100, (S, D, W)).astype(np.int64)
    want_sk = sketch.copy()
    stats = _host_finish(finish_lib, sketch, accp, ap[4], int(nows[0]), 0,
                         topk, 4, 2)
    for s in range(S):
        want_sk[s], want = ja.oracle_stats(
            want_sk[s], packed[:, s], wp[:, s], tenants[:, s], ap[4][s],
            int(nows[0]), 0, tenant_slots=T, topk=topk, over_weight=4)
        np.testing.assert_array_equal(stats[s], want, err_msg=f"s{s} stats")
        np.testing.assert_array_equal(sketch[s], want_sk[s])


# ---------------------------------------------------------------------------
# the GLOBAL window's upsert lanes (an owner's broadcast on a replica)


def _host_global_ku(lib, entry, planes, cfgs, sums, ctl, *tail):
    """_host_global for the *_ku entries: the control's ku after the
    sums."""
    block = np.ascontiguousarray(ctl.block.numpy())
    getattr(lib, entry)(
        *[_ptr(p) for p in planes], *[_ptr(c) for c in cfgs],
        ctypes.c_longlong(sums.shape[0]), _ptr(block),
        ctypes.c_longlong(ctl.n), ctypes.c_longlong(ctl.kg), _ptr(sums),
        ctypes.c_longlong(ctl.ku),
        *[_ptr(a) if isinstance(a, np.ndarray) else a for a in tail])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_global_kernels_with_upserts_match_jax_apply_control(
        host_global, host_apply, seed):
    """global_window.cu's segments (2n, 1 and 5 threads, forward and
    backward; the upserts' segment before the barrier that precedes phase
    A) and global_apply.cu's global_stage (its upsert launch, then its
    stage launch, items forward and backward), the torch reads and
    global_apply, on a window whose control carries upsert lanes (rows
    also named by config lanes and resets, rows the lanes read, negative
    indices, pads), against the JAX composition with _apply_control."""
    rng = np.random.default_rng(900 + seed)
    Gs, S, Bg, Kg = 64, 2, 8, 12
    now = T0 + 5
    state, cfg = arena(rng, Gs)
    gbatch, gacc, upd = random_control(rng, Gs, S, Bg, Kg)
    ups = random_upserts(rng, Gs, 10, upd)
    gbatch.slot.reshape(-1)[:4] = np.asarray(ups[0])[:4] % Gs
    ctl = gk.make_control(gbatch, gacc, upd, "cpu", ups)
    for per_op in (False, True):
        want = jax_window_ups(state, cfg, gbatch, gacc, upd, ups, now,
                              per_op)
        for backward in (0, 1):
            for threads in ((None, 1, 5) if not per_op else (None,)):
                planes, cfgs, sums = _arena_copies(state, cfg)
                if per_op:
                    _host_global_ku(host_apply, "host_global_stage_ku",
                                    planes, cfgs, sums, ctl,
                                    ctypes.c_int(backward))
                    read = gk.global_read_block(
                        tk.BucketState(*[torch.from_numpy(p)
                                         for p in planes]), ctl, now).numpy()
                    _host_global(host_apply, "host_global_apply", planes,
                                 cfgs, sums, ctl, ctypes.c_longlong(now),
                                 ctypes.c_int(backward))
                else:
                    read = np.full((ctl.n, 4), -7, np.int64)
                    _host_global_ku(
                        host_global, "host_global_window_ku", planes, cfgs,
                        sums, ctl, ctypes.c_longlong(now), read,
                        ctypes.c_int(backward),
                        ctypes.c_longlong(2 * ctl.n if threads is None
                                          else threads))
                tag = f"per_op={per_op} backward={backward} t={threads}"
                assert_window(planes, cfgs, read, want, tag)
                assert not sums.any(), tag
