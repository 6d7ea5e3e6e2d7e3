"""The analytics accumulator and the wrapper of the finisher kernel
(ops/csrc/stats_finish.cu).

A drain with analytics runs in two launches: the stats drain
(ops/drain_kernel.py `drain_compact_stats`, window_drain.cu) adds every
window's sums into a `StatsAccumulator`, then `stats_finish` turns the
accumulator and the resident count-min sketch into the stats vectors
(ops/analytics.py layout) and clears the accumulator.  Together they
replace the JAX package's staged analytics: the TPU drain kernel's
in-kernel stats fold (pallas_kernel.py:852) and staged_stats_finish
(:1168).

`stats_finish` launches the kernel on the current stream for CUDA tensors
(building it with nvcc on first use, ops/build.py) or raises; for CPU
tensors it runs the plain version, `stats_finish_plain`:
ops/analytics.py staged_stats_tail per shard over the accumulator's dense
sums.  chip_smoke.py and the tests hold the kernel against it.

`launch_finish` launches the kernel uncounted at a chosen geometry (the
expiry slices a shard, the rank keys and the sketch in shared memory or
not) and, with `debug_stamps`, records the finisher's phases
(`stamp_split`).

`launches` counts kernel launches and `plain_calls` plain-version runs.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from gubernator_tpu_torch.ops import analytics, build
from gubernator_tpu_torch.ops.analytics import DrainStats
from gubernator_tpu_torch.ops.build import check_tensor

SOURCE = "stats_finish"

launches = {"stats_finish": 0}
plain_calls = {"stats_finish": 0}

_lock = threading.Lock()
_lib = None


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


def load_library() -> ctypes.CDLL:
    """Build stats_finish.cu for sm_90a (ops/build.py) and bind its C entry
    point with ctypes."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.guber_stats_finish.argtypes = [p, i, ll, p, p, p, p, p, p, ll, i,
                                           p, ll, i, ll, i, ll, i, p, p, p, i,
                                           i, i, p, p]
        lib.guber_stats_finish.restype = i
        lib.guber_stats_expiry_ctas.argtypes = [ll, i]
        lib.guber_stats_expiry_ctas.restype = i
        lib.guber_stats_error_string.argtypes = [i]
        lib.guber_stats_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


class StatsAccumulator:
    """One engine's analytics sums since the last finish, per shard, on its
    device (window_drain.cu StatsAcc):

      index   i32[S, C]     arena row -> its entry + 1 (0: untouched)
      entries i64[S, N, 4]  (row, occupied lanes, over-limit lanes, hits),
                            count[s] in use, in the order the drain first
                            saw the rows (on the card: any order)
      count   i32[S]
      tenant  i64[S, T, 3]  occupied lanes, hits, over per tenant id
      header  i64[S, 4]     lanes, hits, over, inits

    plus the finisher's scratch (est i64[S, N]; ecount, edone, its expiry
    counters).  A drain adds at most one entry per lane, so the host keeps
    `pending`, the lanes drained since the last finish: `reserve` grows N
    when nothing is pending and raises when a drain could overflow it."""

    def __init__(self, num_shards: int, capacity: int, tenant_slots: int,
                 device):
        S, C, T = num_shards, capacity, tenant_slots
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
        self.index = z((S, C), torch.int32)
        self.device = self.index.device
        self.count = z((S,), torch.int32)
        self.tenant = z((S, T, 3), torch.int64)
        self.header = z((S, 4), torch.int64)
        self.ecount = z((S, 2), torch.int64)
        self.edone = z((S,), torch.int32)
        self.entries = z((S, 1, 4), torch.int64)
        self.est = z((S, 1), torch.int64)
        self.pending = 0

    @property
    def shape(self) -> tuple:
        """(S, C, T)."""
        return (self.index.shape[0], self.index.shape[1],
                self.tenant.shape[1])

    @property
    def entry_capacity(self) -> int:
        return self.entries.shape[1]

    def reserve(self, lanes: int) -> None:
        """Make room for a drain of `lanes` lanes per shard."""
        if self.pending + lanes > self.entry_capacity:
            if self.pending:
                raise RuntimeError(
                    f"stats accumulator holds {self.pending} lanes of "
                    f"unfinished drains; finish it before draining {lanes} "
                    f"more")
            S = self.index.shape[0]
            self.entries = torch.zeros((S, lanes, 4), dtype=torch.int64,
                                       device=self.device)
            self.est = torch.zeros((S, lanes), dtype=torch.int64,
                                   device=self.device)
        self.pending += lanes

    def add(self, s: int, ds: DrainStats) -> None:
        """Shard s += one drain's DrainStats (the plain version's
        accumulation): rows new to the accumulator are appended in row
        order."""
        rows = torch.nonzero(ds.d_occ).flatten()
        fresh = rows[self.index[s, rows] == 0]
        n0, k = int(self.count[s]), int(fresh.numel())
        self.index[s, fresh] = torch.arange(n0 + 1, n0 + k + 1,
                                            dtype=torch.int32,
                                            device=self.device)
        self.entries[s, n0:n0 + k, 0] = fresh
        self.entries[s, n0:n0 + k, 1:] = 0
        self.count[s] = n0 + k
        e = self.index[s, rows].long() - 1
        for col, plane in ((1, ds.d_occ), (2, ds.d_over), (3, ds.d_hits)):
            self.entries[s, e, col] += plane[rows]
        self.tenant[s] += torch.stack([ds.t_occ, ds.t_hits, ds.t_over], -1)
        self.header[s] += ds.hdr

    def dense(self) -> DrainStats:
        """The sums as DrainStats of [S, C] / [S, T] / [S, 4] planes,
        whatever the entries' order."""
        S, C, _ = self.shape
        planes = [torch.zeros((S, C), dtype=torch.int64, device=self.device)
                  for _ in range(3)]
        for s in range(S):
            ent = self.entries[s, :int(self.count[s])]
            for plane, col in zip(planes, (1, 2, 3)):
                plane[s, ent[:, 0]] = ent[:, col]
        t = self.tenant.clone()
        return DrainStats(*planes, t[..., 0], t[..., 2], t[..., 1],
                          self.header.clone())

    def clear(self) -> None:
        """Zero what the drains since the last finish added (the plain
        finisher's clear)."""
        for s in range(self.index.shape[0]):
            rows = self.entries[s, :int(self.count[s]), 0]
            self.index[s, rows] = 0
        self.count.zero_()
        self.tenant.zero_()
        self.header.zero_()
        self.pending = 0


def _check(sketch, acc: StatsAccumulator, expire, decay, topk):
    dev = sketch.device
    if sketch.dim() != 3:
        raise ValueError(f"sketch: want i64[S, D, W], got "
                         f"{tuple(sketch.shape)}")
    S, D, W = sketch.shape
    check_tensor(sketch, "sketch", torch.int64, (S, D, W), dev)
    S_acc, C, _ = acc.shape
    if S_acc != S or acc.device != dev:
        raise ValueError(f"accumulator of {S_acc} shards on {acc.device}, "
                         f"sketch of {S} on {dev}")
    check_tensor(expire, "expire", torch.int64, (S, C), dev)
    if not 1 <= D <= analytics.MAX_SKETCH_DEPTH or W < 1:
        raise ValueError(f"sketch depth {D} (1..{analytics.MAX_SKETCH_DEPTH}) "
                         f"or width {W}")
    if int(decay) not in (0, 1):
        raise ValueError(f"decay must be 0 or 1, got {decay}")
    if not 1 <= topk <= C:
        raise ValueError(f"topk {topk} outside 1..{C}")


def stats_finish(sketch: torch.Tensor, acc: StatsAccumulator,
                 expire: torch.Tensor, now: int, decay: int, *, topk: int,
                 over_weight: int) -> torch.Tensor:
    """Finish the drains accumulated in `acc` since the last finish.

    sketch i64[S, D, W] (decayed and added to in place); expire i64[S, C],
    the arena's expiry plane after the drain; now the drain's timestamp;
    decay 0 or 1.  Returns stats i64[S, stats_len(T, topk)] and leaves
    `acc` empty."""
    _check(sketch, acc, expire, decay, topk)
    dev = sketch.device
    if dev.type == "cpu":
        return stats_finish_plain(sketch, acc, expire, now, decay, topk=topk,
                                  over_weight=over_weight)
    if dev.type != "cuda":
        raise ValueError(f"stats_finish runs on cuda or cpu, not {dev}")
    stats = launch_finish(sketch, acc, expire, now, decay, topk=topk,
                          over_weight=over_weight)
    launches["stats_finish"] += 1
    return stats


def expiry_ctas(C: int, S: int) -> int:
    """The expiry slices a shard the kernel chooses for [S, C] arenas on
    the current card."""
    x = load_library().guber_stats_expiry_ctas(C, S)
    if x < 0:
        raise RuntimeError(
            f"stats_finish: {load_library().guber_stats_error_string(-x)}")
    return x


# the debug stamps a shard (stats_finish.cu kStamps): the finisher's
# start and the ends of its decay, adds, estimates, select, places and
# clears, then the select's passes
STAMPS = 8


def launch_finish(sketch: torch.Tensor, acc: StatsAccumulator,
                  expire: torch.Tensor, now: int, decay: int, *, topk: int,
                  over_weight: int, X: int = 0, key_cap: int = -1,
                  sketch_smem: int = -1,
                  stamps: torch.Tensor = None) -> torch.Tensor:
    """guber_stats_finish on checked CUDA inputs, uncounted: stats_finish
    launches through here, and a check may launch with another geometry
    (chip_smoke.py).  X: expiry slices a shard (0: the kernel's choice);
    key_cap: rank keys held in shared memory (-1: the kernel's choice, 0:
    none); sketch_smem: 1 works on the sketch in shared memory, 0 in
    place (-1: the kernel's choice); stamps: None, or a u64 tensor of
    S * STAMPS + 2 that takes the
    globaltimer stamps of each finisher's phases and the expiry slices'
    first start and last end (debug_stamps)."""
    dev = sketch.device
    lib = load_library()
    S, D, W = sketch.shape
    _, C, T = acc.shape
    stats = torch.empty((S, analytics.stats_len(T, topk)), dtype=torch.int64,
                        device=dev)
    rc = lib.guber_stats_finish(
        sketch.data_ptr(), D, W, acc.index.data_ptr(), acc.entries.data_ptr(),
        acc.count.data_ptr(), acc.tenant.data_ptr(), acc.header.data_ptr(),
        acc.est.data_ptr(), acc.entry_capacity, T, expire.data_ptr(), C, S,
        int(now), int(decay), int(over_weight), topk, acc.ecount.data_ptr(),
        acc.edone.data_ptr(), stats.data_ptr(), int(X), int(key_cap),
        int(sketch_smem), None if stamps is None else stamps.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.guber_stats_error_string(rc).decode()
        raise RuntimeError(f"stats_finish launch failed: {msg} ({rc})")
    acc.pending = 0
    return stats


def debug_stamps(S: int, device) -> torch.Tensor:
    """A stamps buffer for launch_finish: the expiry slices' first start
    takes a minimum, their last end a maximum."""
    t = torch.zeros(S * STAMPS + 2, dtype=torch.int64, device=device)
    t[S * STAMPS] = -1   # u64 max
    return t


def stamp_split(stamps: torch.Tensor, S: int) -> dict:
    """Microseconds of each finisher phase (the mean over shards), each
    finisher's whole span and the expiry slices' span, and the select's
    passes, from one launch's stamps."""
    v = stamps.cpu().numpy().astype("uint64")
    ph = v[:S * STAMPS].reshape(S, STAMPS).astype("int64")
    names = ("decay", "adds", "estimates", "select", "places", "clears")
    out = {n: float((ph[:, k + 1] - ph[:, k]).mean()) / 1e3
           for k, n in enumerate(names)}
    out["finisher"] = float((ph[:, 6] - ph[:, 0]).mean()) / 1e3
    out["expiry"] = float(int(v[S * STAMPS + 1]) - int(v[S * STAMPS])) / 1e3
    out["finisher_start_after_expiry_us"] = float(
        (ph[:, 0] - int(v[S * STAMPS])).mean()) / 1e3
    out["select_passes"] = float(ph[:, 7].mean())
    return out


def stats_finish_plain(sketch: torch.Tensor, acc: StatsAccumulator,
                       expire: torch.Tensor, now: int, decay: int, *,
                       topk: int, over_weight: int) -> torch.Tensor:
    """The plain version of stats_finish on any device: staged_stats_tail
    per shard over the accumulator's dense sums, then the clear."""
    plain_calls["stats_finish"] += 1
    _, _, T = acc.shape
    ds = acc.dense()
    out = []
    for s in range(sketch.shape[0]):
        new, stats = analytics.staged_stats_tail(
            sketch[s], DrainStats(*[f[s] for f in ds]), expire[s], now,
            int(decay), tenant_slots=T, topk=topk, over_weight=over_weight)
        sketch[s].copy_(new)
        out.append(stats)
    acc.clear()
    return torch.stack(out)
