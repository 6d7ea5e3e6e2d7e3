"""Build the PyTorch/CUDA port's kernels and drive its serving path on one GPU.

    python3 chip_smoke.py

Phases (one line each; any mismatch raises and exits non-zero):

  1. device: the card (nvidia-smi name and power limit) and the nvcc build
     of gubernator_tpu_torch/ops/csrc/window_drain.cu;
  2. kernel vs plain: drain_compact on seeded windows (hot duplicates, AGG
     lanes, recycle inits, zero reads, cap edges, all five algorithms,
     negative CONCURRENCY hits; K in {1, 4}), on uniform runs that fold
     over an arena whose clock is often ahead, and window_full on int64
     values outside the compact caps, each bit for bit against the plain
     torch version (ops/kernel.py) on copies of the same arena, on the card;
  3. full size: a RateLimitEngine with a 2^24-slot arena (a random arena
     brought in with import_arena) and K=8 windows of B=1024 lanes (half
     to 64 hot slots).  3a calls the kernel's wrappers directly: one
     window per launch, the same drain shape with no hot slots and with
     every lane on one key (the serial walk's hot-key cost), and
     window_full.  3b drives the engine's pipeline_dispatch: one drain
     compared with the plain version including the whole arena, then 50
     drains timed with CUDA events and 50 with the profiler (device time);
  4. the serving path end to end: RateLimitEngine() on its default device
     (warmup, a 1000-request window, scripted token / leaky /
     duplicate-burst / out-of-cap sequences against closed-form answers),
     Instance.get_rate_limits under asyncio and a 4-window
     pipeline_dispatch; the kernels' launch counters must move by what
     each entry point launches and the plain versions must not run.

The launch counts in the kernel table are those of phases 3b and 4, the
main path: every count is set to 0 just before 3b.  The third-to-last line
is the kernel table as JSON, the next the card's nvidia-smi name and power
limit; the last line is {"ok": true, "device": {...}}.
Tolerance everywhere is exact equality:
every quantity is an integer.
"""

import asyncio
import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script only runs on a GPU")

from gubernator_tpu_torch.api.types import (  # noqa: E402
    Algorithm,
    RateLimitReq,
    millisecond_now,
)
from gubernator_tpu_torch.core.engine import RateLimitEngine  # noqa: E402
from gubernator_tpu_torch.core.service import Instance  # noqa: E402
from gubernator_tpu_torch.ops import drain_kernel as dk  # noqa: E402
from gubernator_tpu_torch.ops import kernel as tk  # noqa: E402

DEV = torch.device("cuda")
T0 = 1_754_000_000_000
# NVIDIA's H100 SXM data sheet: device memory rate, and the float32 rate
# outside the tensor cores (the nearest published rate for scalar integer
# work); both assume the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
SECTOR = 32                 # bytes per scattered arena access
PLANES = 6
SOURCE = "gubernator_tpu_torch/ops/csrc/window_drain.cu"
# phase 3: the survey's 100M keys over 8 chips (12.5M a chip), rounded up to
# a power of two; the top of the JAX engine's stacked-drain depths
# (PIPELINE_K_BUCKETS, gubernator_tpu/core/engine.py:68-84); the engine's
# default window width
FULL_CAPACITY = 1 << 24
FULL_K = 8
FULL_LANES = 1024
TIMED_DRAINS = 50


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


# ---------------------------------------------------------------- inputs

def random_windows(rng, K, B, C, hot=6, cap_edges=False):
    """K compact windows (numpy i64[K, B, 2]): pads, duplicate-heavy hot
    slots, AGG runs, recycle inits, zero reads, all five algorithms,
    negative CONCURRENCY hits, optionally cap-edge configs."""
    out = np.zeros((K, B, 2), np.int64)
    for k in range(K):
        slot = rng.integers(0, C, B).astype(np.int32)
        dup = rng.random(B) < 0.5
        slot[dup] = rng.integers(0, C, hot)[rng.integers(0, hot, int(dup.sum()))]
        slot[rng.random(B) < 0.15] = tk.PAD_SLOT
        algo = rng.integers(0, 5, B).astype(np.int32)
        hits = rng.choice([0, 0, 1, 1, 2, 7], B).astype(np.int64)
        conc = algo == tk.CONCURRENCY
        rel = conc & (rng.random(B) < 0.4)
        hits[rel] = -rng.integers(1, 9, int(rel.sum()))
        limit = rng.integers(1, 1000, B).astype(np.int64)
        duration = rng.integers(1, 600_000, B).astype(np.int64)
        if cap_edges:
            edge = rng.random(B) < 0.2
            big = (rng.random(B) < 0.1) & ~conc
            hits[big] = tk.COMPACT_MAX_HITS - 1
            limit[edge] = tk.COMPACT_MAX_LIMIT - 1
            duration[edge & (algo != tk.SLIDING_WINDOW)] = \
                tk.COMPACT_MAX_DURATION - 1
        is_init = rng.random(B) < 0.1
        agg = (rng.random(B) < 0.1) & (slot >= 0) & (hits > 0) & (algo <= 1)
        eslot = np.where(agg, slot | tk.AGG_SLOT_BIT, slot).astype(np.int32)
        out[k] = tk.encode_batch_host(eslot, hits, limit, duration, algo,
                                      is_init)
    return out


def random_arena(gen, C, now, device):
    """Arena rows as serving would leave them: configs inside the compact
    caps, times within a few minutes of `now` (about half expired)."""
    def ri(lo, hi):
        return torch.randint(lo, hi, (C,), generator=gen, device=device,
                             dtype=torch.int64)
    limit = ri(1, 1000)
    return tk.BucketState(
        limit=limit, duration=ri(1_000, 600_000),
        remaining=torch.remainder(ri(0, 1 << 20), limit + 1),
        tstamp=now + ri(-300_000, 300_000), expire=now + ri(-300_000, 300_000),
        algo=ri(0, 5).to(torch.int32))


def clone(arena):
    return tk.BucketState(*[t.clone() for t in arena])


def assert_same(a, b, what):
    for name, x, y in zip(a._fields if hasattr(a, "_fields") else range(len(a)),
                          a, b):
        if not torch.equal(x, y):
            bad = (x != y).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"{what}.{name} differs at {bad}")


def max_abs_err(pairs):
    err = 0
    for x, y in pairs:
        err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def touched_slots(packed):
    """Distinct valid slots over the whole drain: a K-window drain need
    read and write each arena row only once."""
    bt = tk.decode_batch(packed)
    s = bt.slot[bt.slot >= 0] & ~tk.AGG_SLOT_BIT
    return int(torch.unique(s).numel())


def bound_ms(lanes, in_bytes, out_bytes, slots, ops_per_lane=400):
    """The least time for one launch: bytes each input read once, each
    output written once, each touched arena row read and written on six
    planes at sector granularity; or the scalar integer work, whichever
    is larger.  `ops_per_lane` counts that work: about 2 x 55 operations
    of the sort's compare-exchanges at 1024 lanes, the decode and encode,
    and ~100 int64 operations (~200 in 32-bit units) of the ladder."""
    nbytes = lanes * (in_bytes + out_bytes) + slots * PLANES * SECTOR * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lanes * ops_per_lane / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, n):
    """Mean device ms per call over n calls (the caller warms up)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_ms(fn, n, kernel_name):
    """Mean device time (ms) of the kernel named `kernel_name` per launch
    over n calls, from a torch.profiler CUDA trace; None when the trace
    shows no device time for it (CUDA events then stand in)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = count = 0
    for e in prof.key_averages():
        if kernel_name in e.key:
            total_us += (getattr(e, "device_time_total", None)
                         or getattr(e, "cuda_time_total", 0) or 0)
            count += e.count
    return total_us / count / 1e3 if count and total_us else None


# ---------------------------------------------------------------- phases

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    dk.load_library()
    load_s = time.perf_counter() - t0
    build_s, build_log = dk.build_info if dk.build_info else (0.0, "")
    regs = [ln.strip() for ln in build_log.splitlines() if "registers" in ln]
    log(f"phase 1 device: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvcc build {build_s:.1f} s (load "
        f"{load_s:.1f} s); ptxas: {' | '.join(regs)}")
    return smi


def phase_kernel_vs_plain():
    rng = np.random.default_rng(2024)
    gen = torch.Generator(device=DEV).manual_seed(2024)
    C = 4096
    n_windows = 0
    errs = []
    # (K, lanes, hot slots, traffic): K in {1, 4}; powers of two and not
    # (the kernel pads its sort to one); up to the 16384-lane shared-memory
    # cap.  "mixed" draws each lane's config apart, so hot runs replay lane
    # by lane; "uniform" gives a key one config, so its runs fold, over an
    # arena whose clock is often ahead of the window's (negative leaks).
    shapes = [(4, 256, 6, "mixed"), (4, 256, 6, "mixed"),
              (1, 256, 6, "mixed"), (1, 200, 6, "mixed"),
              (4, 100, 6, "mixed"), (1, 37, 6, "mixed"),
              (4, 3000, 64, "mixed"), (1, dk.MAX_LANES, 2048, "mixed"),
              (4, 256, 8, "uniform"), (1, 1024, 64, "uniform"),
              (4, 1024, 4, "uniform")]
    for i, (K, lanes, hot, traffic) in enumerate(shapes):
        arena = random_arena(gen, C, T0, DEV)
        if traffic == "uniform":
            # rows hold the config their key's traffic sends
            algo, limit, duration = slot_config(np.arange(C))
            arena = arena._replace(
                algo=torch.from_numpy(algo).to(DEV),
                limit=torch.from_numpy(limit).to(DEV),
                duration=torch.from_numpy(duration).to(DEV),
                remaining=torch.remainder(arena.remaining,
                                          torch.from_numpy(limit).to(DEV) + 1))
        plain_arena = clone(arena)
        if traffic == "mixed":
            packed = random_windows(rng, K, lanes, C, hot=hot,
                                    cap_edges=(i % 2 == 1))
        else:
            packed = full_size_traffic(rng, K, lanes, C, 0.5, hot)
        packed = torch.from_numpy(packed).to(DEV)
        nows = torch.tensor([T0 + 997 * (k + 1) * (i + 1) for k in range(K)],
                            dtype=torch.int64, device=DEV)
        got = dk.drain_compact(arena, packed, nows)
        want = dk.drain_compact_plain(plain_arena, packed, nows)
        torch.cuda.synchronize()
        assert_same(got, want, f"drain {i} (K={K}) outputs")
        assert_same(arena, plain_arena, f"drain {i} (K={K}) arena")
        errs += list(zip(got, want)) + list(zip(arena, plain_arena))
        n_windows += K
    drain_err = max_abs_err(errs)

    errs = []
    full_lanes = [256, 1000, 256, 77]
    for i, B in enumerate(full_lanes):
        arena = random_arena(gen, C, T0, DEV)
        plain_arena = clone(arena)
        bt = tk.decode_batch(torch.from_numpy(
            random_windows(rng, 1, B, C)[0]))
        big = torch.from_numpy(rng.random(B) < 0.5)
        bt = tk.WindowBatch(
            slot=bt.slot, is_init=bt.is_init,
            hits=torch.where(torch.from_numpy(rng.random(B) < 0.2),
                             torch.from_numpy(rng.integers(-5, 2**33, B)),
                             bt.hits),
            limit=torch.where(big, torch.from_numpy(
                rng.integers(2**31, 2**45, B)), bt.limit),
            duration=torch.where(big, torch.from_numpy(
                rng.integers(2**31, 2**40, B)), bt.duration),
            algo=torch.where(torch.from_numpy(rng.random(B) < 0.1),
                             torch.tensor(9, dtype=torch.int32), bt.algo))
        bt = tk.WindowBatch(*[t.contiguous().to(DEV) for t in bt])
        now = T0 + 10**9 * (i + 1)
        got = dk.window_full(arena, bt, now)
        want = dk.window_full_plain(plain_arena, bt, now)
        torch.cuda.synchronize()
        assert_same(got, want, f"full window {i} outputs")
        assert_same(arena, plain_arena, f"full window {i} arena")
        errs += list(zip(got, want)) + list(zip(arena, plain_arena))
    full_err = max_abs_err(errs)
    log(f"phase 2 kernel vs plain: drain_compact {n_windows} windows "
        f"(K in 1,4; B in {sorted({sh[1] for sh in shapes})}; C={C}; mixed "
        f"and uniform runs) and "
        f"window_full 4 int64 windows (B in {sorted(set(full_lanes))}), "
        f"bit-exact (max_abs_err {drain_err}, {full_err})")
    return drain_err, full_err


def slot_config(slot):
    """A key's (algo, limit, duration) in full_size_traffic: it follows the
    slot.  60% token, 30% leaky, 10% over GCRA / sliding / concurrency."""
    mix = slot % 100
    algo = np.select([mix < 60, mix < 90, mix < 94, mix < 97],
                     [0, 1, 2, 3], 4).astype(np.int32)
    limit = 10 + (slot * 2654435761) % 990
    duration = np.asarray([1_000, 60_000, 3_600_000])[slot % 3]
    return algo, limit, duration


def full_size_traffic(rng, K, B, C, hot_share=0.5, n_hot=64):
    """Phase 3 traffic: `hot_share` of the lanes on `n_hot` hot slots, the
    rest uniform over the arena; 10% AGG runs, 5% inits; 60% token, 30%
    leaky, 10% over GCRA / sliding / concurrency; a key's config follows
    its slot."""
    out = np.zeros((K, B, 2), np.int64)
    hot = rng.integers(0, C, n_hot)
    for k in range(K):
        slot = rng.integers(0, C, B).astype(np.int64)
        h = rng.random(B) < hot_share
        slot[h] = hot[rng.integers(0, n_hot, int(h.sum()))]
        algo, limit, duration = slot_config(slot)
        hits = np.where(rng.random(B) < 0.1, 0, 1).astype(np.int64)
        conc = algo == tk.CONCURRENCY
        hits[conc & (rng.random(B) < 0.3)] = -1
        agg = (rng.random(B) < 0.1) & (algo <= 1)
        hits[agg] = rng.integers(2, 17, int(agg.sum()))
        is_init = rng.random(B) < 0.05
        eslot = np.where(agg, slot | tk.AGG_SLOT_BIT, slot).astype(np.int32)
        out[k] = tk.encode_batch_host(eslot, hits, limit.astype(np.int64),
                                      duration.astype(np.int64), algo,
                                      is_init)
    return out


def full_size_engine(gen):
    """The phase-3 engine: a 2^24-slot arena on the card holding a random
    arena, imported the way a state transfer would bring it in."""
    eng = RateLimitEngine(capacity_per_shard=FULL_CAPACITY,
                          batch_per_shard=FULL_LANES)
    check(eng.device.type == DEV.type, f"engine on {eng.device}")
    arena = random_arena(gen, FULL_CAPACITY, T0, DEV)
    eng.import_arena({name: t.cpu().numpy()[None]
                      for name, t in zip(tk.BucketState._fields, arena)})
    return eng


def phase_kernel_full_size(eng, packed, nows):
    """Phase 3a: the kernel's wrappers called directly on the full-size
    arena: one window per launch (the engine's single-window compact step),
    the serial walk's hot-key cost, and window_full at the engine's width."""
    arena = eng._arena()
    plain_arena = clone(arena)
    B = packed.shape[1]

    one, now1 = packed[:1].contiguous(), nows[:1].contiguous()
    dk.drain_compact(arena, one, now1)  # warm-up
    k1_ms = device_ms(lambda: dk.drain_compact(arena, one, now1), 20,
                      "drain_compact_kernel")
    if k1_ms is None:
        k1_ms = cuda_ms(lambda: dk.drain_compact(arena, one, now1), 20)
    dk.drain_compact_plain(plain_arena, one, now1)  # warm-up
    k1_plain = cuda_ms(lambda: dk.drain_compact_plain(plain_arena, one, now1),
                       3)
    k1_bound, _ = bound_ms(B, 16, 16, touched_slots(one))
    log(f"phase 3a K=1 drain: B={B} on the 2^24-slot arena: kernel "
        f"{k1_ms:.4f} ms device, plain {k1_plain:.2f} ms, byte bound "
        f"{k1_bound * 1e3:.3f} us")

    # the serial walk's hot-key cost: the phase-3b drain shape with no hot
    # slots, and with every lane on one key
    costs = []
    for label, share, n_hot in (("uniform", 0.0, 1), ("one key", 1.0, 1)):
        pk = torch.from_numpy(full_size_traffic(
            np.random.default_rng(8), FULL_K, B, FULL_CAPACITY, share,
            n_hot)).to(DEV)
        dk.drain_compact(arena, pk, nows)  # warm-up
        t = device_ms(lambda: dk.drain_compact(arena, pk, nows), 10,
                      "drain_compact_kernel")
        if t is None:
            t = cuda_ms(lambda: dk.drain_compact(arena, pk, nows), 10)
        costs.append(f"{label} {t:.4f} ms")
    log(f"phase 3a hot-key cost, device ms per {FULL_K} x {B} drain: "
        f"{costs[0]}, {costs[1]} (half on 64 hot slots: phase 3b)")

    # window_full at the engine's full-format width on the same arena
    bt = tk.decode_batch(packed[0])
    bt = bt._replace(limit=bt.limit + (1 << 31))
    dk.window_full(arena, bt, T0 + 100)  # warm-up
    fcall = cuda_ms(lambda: dk.window_full(arena, bt, T0 + 100), 20)
    fms = device_ms(lambda: dk.window_full(arena, bt, T0 + 100), 20,
                    "window_full_kernel")
    ftimer = "profiler"
    if fms is None:
        fms, ftimer = fcall, "events"
    dk.window_full_plain(plain_arena, bt, T0 + 100)  # warm-up
    fplain = cuda_ms(lambda: dk.window_full_plain(plain_arena, bt, T0 + 100),
                     3)
    fbms, fby = bound_ms(B, 4 + 8 * 3 + 4 + 1, 4 + 8 * 3,
                         touched_slots(packed[:1]))
    log(f"phase 3a window_full: B={B} on the same arena: kernel {fms:.4f} ms "
        f"device ({ftimer}), {fcall:.4f} ms/call (CUDA events), plain "
        f"{fplain:.2f} ms, byte bound {fbms * 1e3:.3f} us")
    return dict(ms=fms, plain_ms=fplain, bound_ms=fbms, bound_by=fby)


def phase_engine_full_size(eng, packed, nows):
    """Phase 3b: the engine's stacked drain at full size.  One
    pipeline_dispatch compared with the plain version including the whole
    arena, then 50 timed with CUDA events and 50 with the profiler."""
    K, B = packed.shape[0], packed.shape[1]
    C = eng.capacity_per_shard
    arena = eng._arena()
    plain_arena = clone(arena)
    arena_mb = sum(t.numel() * t.element_size() for t in eng.state) / 1e6
    stack = packed[:, None]

    def drain():
        return eng.pipeline_dispatch(stack, nows)

    before = dk.launches["drain_compact"]
    words, limits, mism = drain()
    want = dk.drain_compact_plain(plain_arena, packed, nows)
    torch.cuda.synchronize()
    check(dk.launches["drain_compact"] - before == 1,
          "pipeline_dispatch did not launch the kernel exactly once")
    got = (words[:, 0], limits[:, 0], mism[:, 0])
    assert_same(got, want, "full-size pipeline_dispatch outputs")
    assert_same(arena, plain_arena, "full-size pipeline_dispatch arena")
    err = max_abs_err(list(zip(got, want)) + list(zip(arena, plain_arena)))
    valid = int(((packed[..., 0] & 0xFFFFFFFF) != 0).sum())

    drain()  # warm-up
    before = dk.launches["drain_compact"]
    call_ms = cuda_ms(drain, TIMED_DRAINS)
    moved = dk.launches["drain_compact"] - before
    check(moved == TIMED_DRAINS,
          f"launch counter moved {moved}, want {TIMED_DRAINS}")
    ms = device_ms(drain, TIMED_DRAINS, "drain_compact_kernel")
    timer = "profiler"
    if ms is None:
        ms, timer = call_ms, "events"
    dk.drain_compact_plain(plain_arena, packed, nows)  # warm-up
    plain_ms = cuda_ms(lambda: dk.drain_compact_plain(plain_arena, packed,
                                                      nows), 3)
    slots = touched_slots(packed)
    bms, by = bound_ms(K * B, 16, 16, slots)
    log(f"phase 3b full-size pipeline_dispatch: C={C} ({arena_mb:.0f} MB "
        f"arena), K={K} x B={B}, {valid} valid lanes, {slots} distinct "
        f"slots; bit-exact vs plain incl. the whole arena; kernel {ms:.4f} "
        f"ms/drain device ({timer}) = {valid / ms * 1e3:.3e} decisions/s, "
        f"{call_ms:.4f} ms/call over {TIMED_DRAINS} back-to-back calls (CUDA "
        f"events); plain {plain_ms:.2f} ms/drain; byte bound "
        f"{bms * 1e3:.3f} us")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                max_abs_err=err)


def expect(resps, want, what):
    got = [(int(r.status), int(r.limit), int(r.remaining), int(r.reset_time))
           for r in resps]
    check(got == want, f"{what}: got {got}, want {want}")


def moved(before, after):
    return {k: after[k] - before[k] for k in after}


def phase_serving():
    launch0, plain0 = dict(dk.launches), dict(dk.plain_calls)
    eng = RateLimitEngine()
    check(eng.device.type == DEV.type, f"engine on {eng.device}")
    t0 = millisecond_now()

    # warmup launches the full format once, each compact lane bucket once
    # and a one-window stacked drain
    before = dict(dk.launches)
    eng.warmup(now=t0)
    want_warm = {"drain_compact": len(eng._lane_bucket_list) + 1,
                 "window_full": 1}
    check(moved(before, dk.launches) == want_warm,
          f"warmup launches {moved(before, dk.launches)}, want {want_warm}")

    # a 1000-request window: 400 keys, hot duplicates, all algorithms
    rng = np.random.default_rng(11)
    window = [RateLimitReq(name="smoke", unique_key=f"k{int(rng.zipf(1.3)) % 400}",
                           hits=int(rng.integers(0, 3)), limit=20,
                           duration=60_000, algorithm=int(rng.integers(0, 5)))
              for _ in range(1000)]
    big = eng.process(window, now=t0)
    check(len(big) == 1000 and all(r.status in (0, 1) for r in big),
          "1000-request window")
    # host wall time of the same window through the whole engine (slot
    # lookups, staging, copy in, kernel, copy out, response objects)
    walls = []
    for i in range(10):
        w0 = time.perf_counter()
        eng.process(window, now=t0 + 1 + i)
        walls.append((time.perf_counter() - w0) * 1e3)
    wall_ms = float(np.median(walls))

    # token: limit 5, 7 hits -> 5 UNDER then 2 OVER, reset at init + 60 s
    tok = [eng.process([RateLimitReq(name="s", unique_key="tok", hits=1,
                                     limit=5, duration=60_000)],
                       now=t0 + i)[0] for i in range(7)]
    expect(tok, [(0, 5, 4 - i, t0 + 60_000) for i in range(5)]
           + [(1, 5, 0, t0 + 60_000)] * 2, "token sequence")

    # leaky: limit 4 over 4 s leaks one per 1000 ms
    def leaky(hits, dt):
        return eng.process([RateLimitReq(
            name="s", unique_key="leaky", hits=hits, limit=4, duration=4_000,
            algorithm=Algorithm.LEAKY_BUCKET)], now=t0 + dt)[0]
    lk = [leaky(4, 0), leaky(1, 100), leaky(1, 2_100), leaky(1, 2_100),
          leaky(1, 2_200)]
    expect(lk, [(0, 4, 0, 0), (1, 4, 0, t0 + 1_100), (0, 4, 1, 0),
                (0, 4, 0, 0), (1, 4, 0, t0 + 3_200)], "leaky sequence")

    # duplicate-key burst in one call: sequential semantics inside a window
    burst = eng.process([RateLimitReq(name="s", unique_key="dup", hits=1,
                                      limit=3, duration=60_000)] * 5,
                        now=t0 + 10)
    expect(burst, [(0, 3, 2, t0 + 60_010), (0, 3, 1, t0 + 60_010),
                   (0, 3, 0, t0 + 60_010), (1, 3, 0, t0 + 60_010),
                   (1, 3, 0, t0 + 60_010)], "duplicate burst")

    # Instance.get_rate_limits: 3 RPCs of 100 items (50 keys x 2 hits each,
    # limit 3) -> all UNDER; then 50 UNDER + 50 OVER; then all OVER
    inst = Instance(engine=eng)

    async def rpcs():
        out = []
        for _ in range(3):
            reqs = [RateLimitReq(name="rpc", unique_key=f"r{j % 50}", hits=1,
                                 limit=3, duration=60_000)
                    for j in range(100)]
            out.append([r.status for r in await inst.get_rate_limits(reqs)])
        return out

    try:
        statuses = asyncio.run(rpcs())
    finally:
        inst.close()
    check(statuses == [[0] * 100, [0] * 50 + [1] * 50, [1] * 100],
          f"Instance RPC statuses {statuses}")

    # four pre-packed windows through pipeline_dispatch: one launch; held
    # against the plain version below, once the serving counts are read
    rng4 = np.random.default_rng(12)
    packed = torch.from_numpy(full_size_traffic(
        rng4, 4, eng.batch_per_shard, eng.capacity_per_shard)).to(DEV)
    nows = torch.tensor([t0 + 30 + k for k in range(4)], dtype=torch.int64,
                        device=DEV)
    pre = clone(eng._arena())
    before = dict(dk.launches)
    stacked = eng.pipeline_dispatch(packed[:, None], nows)
    check(moved(before, dk.launches) == {"drain_compact": 1, "window_full": 0},
          f"pipeline_dispatch launches {moved(before, dk.launches)}")
    post = clone(eng._arena())

    # a config past the compact caps takes the full-format kernel
    huge = eng.process([RateLimitReq(name="s", unique_key="huge", hits=2**30,
                                     limit=2**40, duration=2**35)],
                       now=t0 + 20)
    expect(huge, [(0, 2**40, 2**40 - 2**30, t0 + 20 + 2**35)], "int64 config")
    check(not eng._compact_sound, "full-format window kept compact on")

    launches = moved(launch0, dk.launches)
    plain = moved(plain0, dk.plain_calls)
    check(launches["drain_compact"] > 0 and launches["window_full"] > 0,
          f"a kernel of the serving path never launched: {launches}")
    check(plain == {"drain_compact": 0, "window_full": 0},
          f"the plain versions ran on the serving path: {plain}")

    want = dk.drain_compact_plain(pre, packed, nows)
    assert_same(tuple(t[:, 0] for t in stacked), want,
                "pipeline_dispatch outputs")
    assert_same(post, pre, "pipeline_dispatch arena")

    # the same 1000-request window on a CPU engine (plain version) agrees
    ref = RateLimitEngine(device="cpu")
    want = ref.process(window, now=t0)
    check([(r.status, r.limit, r.remaining, r.reset_time) for r in big]
          == [(r.status, r.limit, r.remaining, r.reset_time) for r in want],
          "1000-request window differs from the CPU plain engine")
    log(f"phase 4 serving: warmup, engine.process (1000-request window = "
        f"CPU plain engine; {wall_ms:.3f} ms median host wall per such window "
        f"over 10, {1000 / wall_ms * 1e3:.3e} decisions/s), token/leaky/"
        f"burst/int64 sequences, 3 Instance RPCs x 100, a 4-window "
        f"pipeline_dispatch = plain; launches {launches}, plain calls {plain}")


def main():
    smi = phase_device()
    drain_err, full_err = phase_kernel_vs_plain()
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=DEV).manual_seed(7)
    eng = full_size_engine(gen)
    packed = torch.from_numpy(full_size_traffic(
        rng, FULL_K, FULL_LANES, FULL_CAPACITY)).to(DEV)
    nows = torch.tensor([T0 + 5 * k for k in range(FULL_K)],
                        dtype=torch.int64, device=DEV)
    full = phase_kernel_full_size(eng, packed, nows)
    # the main path: every count from 0, read when the serving phase ends
    dk.reset_counts()
    drain = phase_engine_full_size(eng, packed, nows)
    del eng
    phase_serving()
    launches = dict(dk.launches)
    kernels = [
        dict(name="drain_compact", route="cuda", source=SOURCE,
             replaces="gubernator_tpu/ops/pallas_kernel.py:974",
             launches=launches["drain_compact"],
             max_abs_err=max(drain_err, drain["max_abs_err"]),
             ms=drain["ms"], plain_ms=drain["plain_ms"],
             bound_ms=drain["bound_ms"], bound_by=drain["bound_by"],
             library_ms=None),
        dict(name="window_full", route="cuda", source=SOURCE,
             replaces="gubernator_tpu/ops/kernel.py:1084",
             launches=launches["window_full"], max_abs_err=full_err,
             ms=full["ms"], plain_ms=full["plain_ms"],
             bound_ms=full["bound_ms"], bound_by=full["bound_by"],
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
