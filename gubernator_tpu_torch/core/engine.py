"""The rate-limit engine: host routing + kernel launches per window.

The single-process serving subset of `gubernator_tpu/core/engine.py`
(RateLimitEngine) on PyTorch, over S shards on one device.  The JAX
package's mesh shard axis is the leading dimension of the arena: regular
keys live in [S, C] planes, a key's shard given by `shard_of`, and GLOBAL
keys live in one replicated [G] arena.  The host maps each key to a slot
(state/arena.py SlotTable, the JAX engine's use_native=False path) and
stages the window's lanes; the device applies them.  With the native
router (`use_native`, gubernator_tpu_torch/native: the JAX engine's C++
router, copied) one C call hashes, routes and slot-allocates a whole
window of regular keys instead (`_process_native`, the JAX engine's
use_native path), GLOBAL keys staying on the Python table, and the serving
pipeline (core/pipeline.py) packs K-window compact stacks with it for
`pipeline_dispatch`:

  * the regular lanes with one launch of the window-drain kernel
    (ops/drain_kernel.py), one CTA per shard.  Windows inside the compact
    caps travel as two i64 words per lane and come back as one response
    word plus the stored limit (drain_compact); windows outside them take
    the full int64 columns (window_full), and an out-of-range limit or
    duration switches compact dispatch off for the engine's life, exactly
    like the JAX engine's `_compact_sound` latch, so both engines choose
    the same path for the same stream;
  * the GLOBAL lanes, spread round-robin over the shards, and the
    window's config writes and resets, packed into one pinned control
    block (ops/global_kernel.py), with one non-blocking copy and one
    launch of the GLOBAL window kernel: the config writes land, every lane
    reads the replicated arena as they left it, and the hits of all
    shards' lanes, summed per slot on the device (the mesh psum of the
    JAX package), apply once under each slot's config, in place, on the
    touched rows only.  A window with no GLOBAL lane and no config write
    launches nothing there: it would read nothing and apply nothing.
    Host arrays reach the device through pinned buffers the engine owns,
    so a dispatch never waits for the device before its fetch;
  * `pipeline_dispatch` runs K pre-packed windows in one launch, and
    `pipeline_dispatch_global` adds one GLOBAL window to them;
  * with analytics enabled (`enable_analytics`), `pipeline_dispatch_global
    (..., analytics_args=(tenants, decay))` drains through the stats drain
    kernel and finishes the drain's traffic stats with the finisher
    kernel (ops/stats_kernel.py) against the resident count-min sketch;
    `analytics_dispatch` is the same reduction in torch ops over a
    drain's wire arrays.

With GUBER_PALLAS=1 in the environment when the engine is built
(config.per_op_lowering) it takes the per-op lowering instead, the JAX
engine's GUBER_PALLAS=1 route: every regular window, compact or full,
sorts, segments and gathers in torch ops, runs the window-math kernel
(ops/window_math_kernel.py) and commits in torch ops, one shard at a time;
the GLOBAL window stages its config writes and sums with global_stage,
reads the replica in torch ops (kernel.global_read) and applies the sums
with global_apply (both global_kernel); the composed drain's analytics are
the torch reduction of `analytics_dispatch`.  The drain, global_window and
the stats kernels are not launched then.  Both lowerings answer every
request alike and leave the same arenas.

The state lifecycle (JAX engine.py:1858-2043, 2268-2465): `export_state`
/ `import_state` move the arenas, the key tables and the warm tier's rows
as a state/snapshot.py ArenaSnapshot; `enable_tiers` puts the warm tier
(state/tiers.py) behind the Python tables, its demotions and promotions
resolved at a fence before each window's dispatch with one gather and one
scatter on the device's planes.

Upserts from an owner's broadcast (`step([], upserts=...)`, JAX
engine.py:324-384) are the GLOBAL window's upsert lanes: written into the
replica arena and its config in phase A of global_window (or
global_stage), before the window's config lanes and reads.  Live key
migration (state/migrate.py) reads and writes rows through `local_keys`,
`export_rows` / `import_rows`, `export_global_rows` /
`import_global_rows` and `remove_keys` (JAX engine.py:2045-2258), on the
Python tables.  Mesh-mode registration (several processes) and the
stacked legacy step (`step_stacked`) are not part of this single-process
engine.

Device profiling (observability/devprof.py) joins kernels to serving arms
by the `torch.profiler.record_function` annotations put around each
per-drain call, never per item (JAX engine.py:1379-1382, :1463, :1538,
:1594, :1604, :1671): `guber_window` around a compact `_dispatch`
(`guber_window_full` around a full-format one), `guber_drain` around
`pipeline_dispatch` and a `pipeline_dispatch_global` without analytics
(`guber_analytics` with it, and around `analytics_dispatch`), and
`guber_fetch` around `fetch_async`.
"""

from __future__ import annotations

import logging
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from gubernator_tpu_torch import config
from gubernator_tpu_torch import native as native_mod
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    RateLimitResp,
    millisecond_now,
)
from gubernator_tpu_torch.ops import (
    analytics,
    drain_kernel,
    global_kernel,
    kernel,
    stats_kernel,
    window_math_kernel,
)
from gubernator_tpu_torch.ops.kernel import (
    BucketState,
    GlobalConfig,
    WindowBatch,
    WindowOutput,
)
from gubernator_tpu_torch.state.arena import SlotTable
from gubernator_tpu_torch.state.snapshot import ArenaSnapshot, SnapshotError
from gubernator_tpu_torch.state.tiers import ROW_FIELDS, TierManager, WarmStore

log = logging.getLogger("gubernator.engine")

# planes of the arenas, in BucketState / GlobalConfig order
ARENA_FIELDS = BucketState._fields
GSTATE_FIELDS = tuple(f"gstate.{f}" for f in BucketState._fields)
GCFG_FIELDS = tuple(f"gcfg.{f}" for f in GlobalConfig._fields)


def _k_buckets_from_env():
    """The serving pipeline's stacked-drain depths (JAX engine.py:68-84):
    a drain of k windows dispatches padded up to the nearest bucket, and
    warmup launches exactly these shapes.  Dense through 8, then 32, 128
    and 512 below GUBER_PIPELINE_KMAX, and KMAX itself."""
    kmax = config.env_int("GUBER_PIPELINE_KMAX", 8)
    buckets = list(range(1, min(kmax, 8) + 1))
    buckets += [b for b in (32, 128, 512) if buckets[-1] < b < kmax]
    if kmax > buckets[-1]:
        buckets.append(kmax)
    return tuple(buckets)


PIPELINE_K_BUCKETS = _k_buckets_from_env()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "torch versions of the kernels")
    return dev


def shard_of(key: str, num_shards: int) -> int:
    """Map a hash key to its owning shard: crc32 IEEE (the reference ring's
    hash, hash.go:41) modulo the shard count."""
    return zlib.crc32(key.encode("utf-8")) % num_shards


class _PackedWindow:
    """Host-side staging buffers for one window (numpy, reused per step):
    regular lanes [S, B], GLOBAL lanes [S, Bg], Kg GLOBAL config-write
    (u*) and state-reset (rslot) lanes, and Kg upsert lanes (p*), of which
    the first n_ups are live."""

    def __init__(self, S: int, B: int, Bg: int, Kg: int):
        self.slot = np.full((S, B), kernel.PAD_SLOT, dtype=np.int32)
        self.hits = np.zeros((S, B), dtype=np.int64)
        self.limit = np.zeros((S, B), dtype=np.int64)
        self.duration = np.zeros((S, B), dtype=np.int64)
        self.algo = np.zeros((S, B), dtype=np.int32)
        self.is_init = np.zeros((S, B), dtype=bool)
        self.gslot = np.full((S, Bg), kernel.PAD_SLOT, dtype=np.int32)
        self.ghits = np.zeros((S, Bg), dtype=np.int64)
        # hits contributed to the per-slot sum (0 for accumulate=False lanes)
        self.ghits_acc = np.zeros((S, Bg), dtype=np.int64)
        self.glimit = np.zeros((S, Bg), dtype=np.int64)
        self.gduration = np.zeros((S, Bg), dtype=np.int64)
        self.galgo = np.zeros((S, Bg), dtype=np.int32)
        self.gis_init = np.zeros((S, Bg), dtype=bool)
        self.uslot = np.zeros((Kg,), dtype=np.int32)
        self.ulimit = np.zeros((Kg,), dtype=np.int64)
        self.uduration = np.zeros((Kg,), dtype=np.int64)
        self.ualgo = np.zeros((Kg,), dtype=np.int32)
        self.rslot = np.zeros((Kg,), dtype=np.int32)
        self.pslot = np.zeros((Kg,), dtype=np.int32)
        self.plimit = np.zeros((Kg,), dtype=np.int64)
        self.pduration = np.zeros((Kg,), dtype=np.int64)
        self.premaining = np.zeros((Kg,), dtype=np.int64)
        self.ptstamp = np.zeros((Kg,), dtype=np.int64)
        self.pexpire = np.zeros((Kg,), dtype=np.int64)
        self.palgo = np.zeros((Kg,), dtype=np.int32)
        self.n_ups = 0

    def reset(self, G: int):
        self.slot.fill(kernel.PAD_SLOT)
        self.gslot.fill(kernel.PAD_SLOT)
        self.ghits.fill(0)
        self.ghits_acc.fill(0)
        # pad config-write/reset lanes point one past the GLOBAL arena: dropped
        self.uslot.fill(G)
        self.rslot.fill(G)
        self.n_ups = 0

    def gbatch(self) -> WindowBatch:
        return WindowBatch(self.gslot, self.ghits, self.glimit,
                           self.gduration, self.galgo, self.gis_init)

    def upd(self) -> tuple:
        return (self.uslot, self.ulimit, self.uduration, self.ualgo,
                self.rslot)

    def ups(self) -> Optional[tuple]:
        """The live upsert lanes, [n_ups] each, or None."""
        if not self.n_ups:
            return None
        k = self.n_ups
        return (self.pslot[:k], self.plimit[:k], self.pduration[:k],
                self.premaining[:k], self.ptstamp[:k], self.pexpire[:k],
                self.palgo[:k])

    def stage_upserts(self, gtable: SlotTable, upserts, now: int) -> None:
        """Stage an owner broadcast's records (UpdatePeerGlobal: key,
        status, algorithm, duration) as upsert lanes (JAX engine.py:
        356-379): each looks up its GLOBAL slot; token sets tstamp and
        expire to the status's reset_time, leaky restarts tstamp at `now`
        and lives a full duration from it (the divergence from the
        reference documented in api/proto/peers.proto).  A key twice in
        one window raises: the JAX scatter leaves the order of duplicate
        slots undefined."""
        keys = [u.key for u in upserts]
        if len(set(keys)) != len(keys):
            raise ValueError("an upsert window names a GLOBAL key twice")
        if len(upserts) > len(self.pslot):
            raise ValueError(
                f"{len(upserts)} upserts exceed the window's "
                f"{len(self.pslot)} upsert lanes (max_global_updates)")
        for i, u in enumerate(upserts):
            slot, _ = gtable.lookup(u.key, now, u.duration)
            st = u.status
            is_token = u.algorithm == Algorithm.TOKEN_BUCKET
            self.pslot[i] = slot
            self.plimit[i] = st.limit
            self.pduration[i] = u.duration
            self.premaining[i] = st.remaining
            self.ptstamp[i] = st.reset_time if is_token else now
            self.pexpire[i] = (st.reset_time if is_token
                               else now + u.duration)
            self.palgo[i] = u.algorithm
        self.n_ups = len(upserts)


def _control_live(gslot, upd, G: int, ups=None) -> bool:
    """Does a GLOBAL window stage a lane, a config write or an upsert?
    Without any it is exact to skip it: every lane pads and every summed
    hit is 0.  Decided on the host arrays, before anything crosses to the
    device."""
    uslot, rslot = upd[0], upd[4]
    return bool((gslot >= 0).any()) or bool((uslot < G).any()) \
        or bool((rslot < G).any()) or ups is not None


def _host(a) -> np.ndarray:
    """A host array (numpy, or a CPU tensor) as numpy.  Raises on a device
    tensor: fetching it would wait for the device, and the serving path
    stages these arrays on the host."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise TypeError(f"want a host array, got a tensor on {a.device}")
        return a.numpy()
    return np.asarray(a)


class _Staging:
    """Host arrays to the device through buffers the engine owns and reuses.
    Each named transfer has two pinned host buffers used in turn and one
    device buffer; a host buffer is written only once the event recorded
    behind its last copy has passed: the host waits for that copy, issued
    two stages of the name earlier, when it is still in flight, and never
    otherwise.  A pinned host tensor the caller owns (the serving
    pipeline's arenas) skips the host buffers: it crosses straight into the
    device buffer.  Every copy is one non-blocking copy_ on the current
    stream.  On a CPU engine the buffers are plain host tensors."""

    def __init__(self, device: torch.device):
        self.device = device
        self._slots: dict = {}
        self._dev: dict = {}

    def stage(self, name: str, numel: int, fill,
              dtype=torch.int64) -> torch.Tensor:
        """fill(view) writes numel elements into a numpy view of a host
        buffer; returns the device tensor [numel] they were copied into
        (valid until the next stage of `name`)."""
        cuda = self.device.type == "cuda"
        slot = self._slots.get(name)
        if slot is None or slot["dev"].numel() < numel:
            slot = self._slots[name] = dict(
                host=[torch.empty(numel, dtype=dtype, pin_memory=cuda)
                      for _ in range(2)],
                events=[torch.cuda.Event() if cuda else None
                        for _ in range(2)],
                turn=0, dev=torch.empty(numel, dtype=dtype,
                                        device=self.device))
        i = slot["turn"]
        slot["turn"] = 1 - i
        ev = slot["events"][i]
        # an event not yet recorded has passed
        if ev is not None and not ev.query():
            ev.synchronize()
        host = slot["host"][i][:numel]
        fill(host.numpy())
        dev = slot["dev"][:numel]
        dev.copy_(host, non_blocking=True)
        if ev is not None:
            ev.record()
        return dev

    def copy_in(self, name: str, a: torch.Tensor) -> torch.Tensor:
        """A pinned host tensor in the device buffer of `name`, through one
        non-blocking copy (valid until the next copy_in of `name`).  The
        caller leaves `a` unchanged until an event recorded after the work
        that reads the copy has passed."""
        n = a.numel()
        dev = self._dev.get(name)
        if dev is None or dev.numel() < n or dev.dtype != a.dtype:
            dev = self._dev[name] = torch.empty(n, dtype=a.dtype,
                                                device=self.device)
        out = dev[:n].view(a.shape)
        out.copy_(a, non_blocking=True)
        return out

    def array(self, name: str, a, dtype=None) -> torch.Tensor:
        """A host array on the device as `dtype` (default: its own), with
        its shape.  A tensor already on the device is used as it is (cast
        to `dtype`); on a CUDA engine a pinned host tensor of that dtype
        crosses with copy_in and any other host tensor through the pinned
        buffers, so no copy here waits for the device."""
        if isinstance(a, torch.Tensor):
            if a.device.type != "cpu" or self.device.type != "cuda":
                return a.to(self.device, dtype).contiguous()
            if a.is_pinned() and a.is_contiguous() and dtype in (None,
                                                                 a.dtype):
                return self.copy_in(name, a)
            a = a.numpy()
        a = np.asarray(a)
        if dtype is None:
            dtype = torch.from_numpy(a[:0].reshape(-1)).dtype

        def fill(view):
            view[:] = a.reshape(-1)
        return self.stage(name, a.size, fill, dtype).reshape(a.shape)


class RateLimitEngine:
    """Dense rate-limit state on one device over S shards + kernel launches
    per window.

    capacity_per_shard: slots per shard.
    batch_per_shard: max regular-key request lanes per shard per window.
    num_shards: S, the shards of the regular arena (keys by `shard_of`).
    global_capacity: G, slots of the replicated GLOBAL arena.
    global_batch_per_shard: max GLOBAL lanes per shard per window.
    max_global_updates: max distinct GLOBAL keys per window.
    replay_cap: max lanes of a non-uniform duplicate-key run per window
        (0 disables); GUBER_REPLAY_CAP in the environment at
        construction overrides it (config.replay_cap_override).  The
        kernel walks a slot's run serially and has no replay rounds to
        bound; the cap only mirrors the JAX engine's window cuts, so the
        differential tests see the same windows.  It can go once parity
        no longer depends on it.
    device: where the arenas live and the kernels run (default `cuda`).
    use_native: regular-key routing.  False (the default here; Instance
        passes EngineConfig.use_native, "auto") keeps the Python slot
        tables; "auto" or True builds the native router when it is
        available and logs a warning and keeps the tables when it is not;
        "on" requires it and raises with g++'s output when it cannot be
        built.  `self.native` is the router or None.
    exact_keys: the router's exact-key guard (also GUBER_EXACT_KEYS=1).

    GUBER_PALLAS=1 in the environment at construction selects the per-op
    lowering (`per_op`; see the module docstring).
    """

    def __init__(
        self,
        capacity_per_shard: int = 65536,
        batch_per_shard: int = 1024,
        num_shards: int = 1,
        global_capacity: int = 4096,
        global_batch_per_shard: int = 256,
        max_global_updates: int = 256,
        replay_cap: Optional[int] = None,
        device=None,
        use_native=False,
        exact_keys: bool = False,
    ):
        self.device = resolve_device(device)
        self.per_op = config.per_op_lowering()
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.num_shards = num_shards
        self.capacity_per_shard = capacity_per_shard
        self.batch_per_shard = batch_per_shard
        self.global_capacity = global_capacity
        self.global_batch_per_shard = global_batch_per_shard
        self.max_global_updates = max_global_updates
        S, C, G = num_shards, capacity_per_shard, global_capacity
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=self.device)  # noqa: E731
        self.state = BucketState(*[z((S, C), torch.int64) for _ in range(5)],
                                 z((S, C), torch.int32))
        self.gstate = BucketState(*[z((G,), torch.int64) for _ in range(5)],
                                  z((G,), torch.int32))
        self.gcfg = GlobalConfig.zeros(G, self.device)
        # the GLOBAL window's per-slot sums, all zero between windows (the
        # kernels clear what they add)
        self._gsums = torch.zeros(G, dtype=torch.int64, device=self.device)
        self._staging = _Staging(self.device)
        self.tables = [SlotTable(C) for _ in range(S)]
        self.gtable = SlotTable(G)
        self._buf = _PackedWindow(S, batch_per_shard, global_batch_per_shard,
                                  max_global_updates)
        # Sound-saturation guard for the compact wire format: once any
        # out-of-range config enters the arena via the full path, stored
        # limits/durations may exceed what a compact response can carry, so
        # compact dispatch is disabled for the engine's lifetime.  int64
        # arithmetic needs no caps; the latch keeps the JAX engine's path
        # choice so the two engines stay comparable window for window.
        self._compact_enabled = True
        self._compact_sound = True
        self.windows_processed = 0
        self.decisions_processed = 0
        # the warm tier (enable_tiers): a state/tiers.py TierManager
        self._tiers = None
        # traffic analytics (enable_analytics): the reduction's geometry,
        # the resident sketch i64[S, D, W] and the stats drain's accumulator
        self._an_conf = None
        self._an_sketch: Optional[torch.Tensor] = None
        self._an_acc: Optional[stats_kernel.StatsAccumulator] = None
        B = batch_per_shard
        self._lane_bucket_list = sorted(
            {b for b in (max(64, B // 16), max(64, B // 4)) if b < B} | {B})
        env_cap = config.replay_cap_override()
        self.replay_cap = (env_cap if env_cap is not None
                           else 128 if replay_cap is None else replay_cap)
        # the native C++ router (JAX engine.py:296-312): regular-key
        # routing state lives in exactly one of it and self.tables
        self.native = None
        if use_native in ("auto", True, "on"):
            if native_mod.available():
                self.native = native_mod.NativeRouter(S, C)
                if exact_keys or config.exact_keys_env():
                    self.native.set_exact_keys()
                self.native.set_replay_cap(self.replay_cap)
            elif use_native != "auto":
                raise RuntimeError("native router requested but unavailable: "
                                   f"{native_mod.build_error()}")

    # ------------------------------------------------------------ serving

    def step(self, requests: Sequence[RateLimitReq],
             now: Optional[int] = None,
             accumulate: Optional[Sequence[bool]] = None,
             upserts: Optional[Sequence] = None
             ) -> List[RateLimitResp]:
        """Process one window of requests synchronously.

        accumulate[i]=False keeps request i's GLOBAL hits out of the
        per-slot sum and its config out of the arena (a replica read whose
        hits reconcile elsewhere: a non-owner host, core/service.py
        _global_nonowner).  upserts: UpdatePeerGlobal records (key,
        status, algorithm, duration) of an owner's broadcast, written into
        the replica arena before this window's reads (stage_upserts); no
        key twice.  The caller must respect the window caps (use `process`
        for auto-chunking): per-shard regular lanes <= batch_per_shard,
        GLOBAL lanes <= num_shards * global_batch_per_shard, distinct
        GLOBAL keys <= max_global_updates, upserts <= max_global_updates.
        With the native router it is `_process_native`, which chunks.
        """
        if self.native is not None:
            return self._process_native(requests, now, accumulate, upserts)
        now = self._resolve_now(now)
        buf = self._buf
        buf.reset(self.global_capacity)
        # init-pending protocol (state/arena.py): fresh allocations keep
        # reporting is_init until the dispatch below commits this window
        for t in self.tables:
            t.begin_window()
        self.gtable.begin_window()
        if upserts:
            buf.stage_upserts(self.gtable, list(upserts), now)
        lanes, gcfg_upd, greset, max_fill, g_count = self._stage_requests(
            buf, requests, now, accumulate)
        for i, (slot, cfg) in enumerate(gcfg_upd.items()):
            buf.uslot[i] = slot
            buf.ulimit[i], buf.uduration[i], buf.ualgo[i] = cfg
        for i, slot in enumerate(greset):
            buf.rslot[i] = slot
        if self._tiers is not None:
            self._tier_fence(now)
        out, gout = self._dispatch(now, reg_fill=max_fill)
        for t in self.tables:
            t.commit_window()
        self.gtable.commit_window()
        self.decisions_processed += len(requests)
        responses = []
        for s, lane, is_global in lanes:
            if is_global:
                st, lim, rem, rst = (int(v) for v in gout[s, lane])
            else:
                st, lim, rem, rst = (int(out.status[s, lane]),
                                     int(out.limit[s, lane]),
                                     int(out.remaining[s, lane]),
                                     int(out.reset_time[s, lane]))
            responses.append(RateLimitResp(status=st, limit=lim,
                                           remaining=rem, reset_time=rst))
        return responses

    def _stage_requests(self, buf, requests, now, accumulate):
        """Stage one window's requests into `buf`.  Returns (lanes,
        gcfg_upd, greset, max_reg_fill, g_count) with lanes [(shard, lane,
        is_global)] per request for demux."""
        S = self.num_shards
        reg_fill = [0] * S
        glob_fill = [0] * S
        # slot -> (limit, duration, algo): the window's latest request per
        # slot wins (deduplicated here: a scatter with duplicate indices
        # has no order)
        gcfg_upd: dict = {}
        greset: List[int] = []
        lanes: List[tuple] = []
        g_count = 0
        for i, r in enumerate(requests):
            key = r.hash_key()
            if r.behavior == Behavior.GLOBAL:
                slot, is_init = self.gtable.lookup(key, now, r.duration)
                contribute = accumulate is None or accumulate[i]
                if contribute:
                    gcfg_upd[slot] = (r.limit, r.duration, r.algorithm)
                    if is_init:
                        greset.append(slot)
                # GLOBAL lanes are shard-agnostic (the sum covers every
                # shard), so they spread round-robin over the shards
                if g_count >= S * self.global_batch_per_shard:
                    raise ValueError(
                        "window exceeds the GLOBAL lane cap "
                        f"({S} shards x {self.global_batch_per_shard}); use "
                        "process() for auto-chunking")
                s = g_count % S
                g_count += 1
                lane = glob_fill[s]
                glob_fill[s] += 1
                buf.gslot[s, lane] = slot
                buf.ghits[s, lane] = r.hits
                buf.ghits_acc[s, lane] = r.hits if contribute else 0
                buf.glimit[s, lane] = r.limit
                buf.gduration[s, lane] = r.duration
                buf.galgo[s, lane] = r.algorithm
                buf.gis_init[s, lane] = is_init
                lanes.append((s, lane, True))
            else:
                s = shard_of(key, S)
                slot = None
                is_init = False
                if self._tiers is not None and key not in self.tables[s]:
                    # a demoted key comes back into the arena with its
                    # live row (scattered at the fence before the
                    # dispatch); a miss in warm too takes the cold lookup
                    slot = self._tiers.stage_promote(
                        s, self.tables[s], key, now, r.duration)
                if slot is None:
                    slot, is_init = self.tables[s].lookup(
                        key, now, r.duration)
                lane = reg_fill[s]
                reg_fill[s] += 1
                buf.slot[s, lane] = slot
                buf.hits[s, lane] = r.hits
                buf.limit[s, lane] = r.limit
                buf.duration[s, lane] = r.duration
                buf.algo[s, lane] = r.algorithm
                buf.is_init[s, lane] = is_init
                lanes.append((s, lane, False))
        return lanes, gcfg_upd, greset, max(reg_fill, default=0), g_count

    def _process_native(
        self,
        requests: Sequence[RateLimitReq],
        now: Optional[int] = None,
        accumulate: Optional[Sequence[bool]] = None,
        upserts: Optional[Sequence] = None,
    ) -> List[RateLimitResp]:
        """Window processing with the C++ router resolving regular keys
        (JAX engine.py:721-928).  Upserts ride the windows in chunks of
        max_global_updates, first, like the JAX engine's.

        One `router_pack` call hashes, routes and slot-allocates a window's
        regular requests straight into the staging buffers; on lane
        overflow it packs what fits and the loop ships that window and
        packs the rest (built-in chunking).  GLOBAL keys keep the Python
        gtable, spread round-robin over the shards in the same dispatch.
        Like step(), a call always dispatches at least one window, even for
        no requests."""
        now = self._resolve_now(now)
        S = self.num_shards
        B = self.batch_per_shard
        buf = self._buf
        responses: List[Optional[RateLimitResp]] = [None] * len(requests)

        glob: List[tuple] = []
        reg_idx: List[int] = []
        keys_b: List[bytes] = []
        rhits: List[int] = []
        rlim: List[int] = []
        rdur: List[int] = []
        ralgo: List[int] = []
        for i, r in enumerate(requests):
            if r.behavior == Behavior.GLOBAL:
                glob.append((i, r, accumulate is None or accumulate[i]))
            else:
                reg_idx.append(i)
                keys_b.append(r.hash_key().encode("utf-8"))
                rhits.append(r.hits)
                rlim.append(r.limit)
                rdur.append(r.duration)
                ralgo.append(r.algorithm)
        nreg = len(reg_idx)
        if nreg:
            key_bytes = np.frombuffer(b"".join(keys_b), dtype=np.uint8)
            key_ends = np.cumsum([len(k) for k in keys_b]).astype(np.int64)
            c_hits = np.asarray(rhits, dtype=np.int64)
            c_lim = np.asarray(rlim, dtype=np.int64)
            c_dur = np.asarray(rdur, dtype=np.int64)
            c_algo = np.asarray(ralgo, dtype=np.int32)
        if nreg:
            out_shard = np.zeros(nreg, np.int32)
            out_lane = np.zeros(nreg, np.int32)
        shard_fill = np.zeros(S, np.int32)

        pending_upserts = list(upserts) if upserts else []
        pos = 0
        gpos = 0
        first = True
        while first or pos < nreg or gpos < len(glob) or pending_upserts:
            first = False
            buf.reset(self.global_capacity)
            shard_fill[:] = 0
            self.gtable.begin_window()
            ups_chunk = pending_upserts[:self.max_global_updates]
            pending_upserts = pending_upserts[self.max_global_updates:]
            if ups_chunk:
                buf.stage_upserts(self.gtable, ups_chunk, now)

            packed = 0
            if pos < nreg:
                base = 0 if pos == 0 else int(key_ends[pos - 1])
                packed = self.native.pack(
                    key_bytes[base:], key_ends[pos:] - base,
                    c_hits[pos:], c_lim[pos:], c_dur[pos:], c_algo[pos:],
                    now, B,
                    buf.slot, buf.hits, buf.limit, buf.duration, buf.algo,
                    buf.is_init.view(np.uint8),
                    out_shard[pos:], out_lane[pos:], shard_fill,
                )

            # GLOBAL lanes (Python table) up to the caps, round-robin over
            # the shards (the per-slot sum covers every shard)
            glanes: List[tuple] = []
            g_count = 0
            gcfg_upd: dict = {}
            greset: List[int] = []
            while gpos + len(glanes) < len(glob):
                i, r, contribute = glob[gpos + len(glanes)]
                if g_count + 1 > S * self.global_batch_per_shard:
                    break
                if len(gcfg_upd) + 1 > self.max_global_updates:
                    break
                slot, is_init = self.gtable.lookup(r.hash_key(), now,
                                                   r.duration)
                if contribute:
                    gcfg_upd[slot] = (r.limit, r.duration, r.algorithm)
                    if is_init:
                        greset.append(slot)
                s = g_count % S
                lane = g_count // S
                g_count += 1
                buf.gslot[s, lane] = slot
                buf.ghits[s, lane] = r.hits
                buf.ghits_acc[s, lane] = r.hits if contribute else 0
                buf.glimit[s, lane] = r.limit
                buf.gduration[s, lane] = r.duration
                buf.galgo[s, lane] = r.algorithm
                buf.gis_init[s, lane] = is_init
                glanes.append((i, s, lane))
            for j, (slot, cfg) in enumerate(gcfg_upd.items()):
                buf.uslot[j] = slot
                buf.ulimit[j], buf.uduration[j], buf.ualgo[j] = cfg
            for j, slot in enumerate(greset):
                buf.rslot[j] = slot

            if (packed == 0 and not glanes and not ups_chunk
                    and (pos < nreg or gpos < len(glob))):
                raise RuntimeError("window packing made no progress")

            out, gout = self._dispatch(
                now, reg_fill=int(shard_fill.max()) if packed else 0)
            self.native.commit()
            self.gtable.commit_window()
            if packed:
                # vectorized demux: one fancy-indexed gather per field
                sh = out_shard[pos:pos + packed]
                ln = out_lane[pos:pos + packed]
                sts = out.status[sh, ln].tolist()
                lims = out.limit[sh, ln].tolist()
                rems = out.remaining[sh, ln].tolist()
                rsts = out.reset_time[sh, ln].tolist()
                for j, i in enumerate(reg_idx[pos:pos + packed]):
                    responses[i] = RateLimitResp(
                        status=sts[j], limit=lims[j],
                        remaining=rems[j], reset_time=rsts[j])
            for i, s, lane in glanes:
                st, lim, rem, rst = gout[s, lane].tolist()
                responses[i] = RateLimitResp(status=st, limit=lim,
                                             remaining=rem, reset_time=rst)
            pos += packed
            gpos += len(glanes)
            self.decisions_processed += packed + len(glanes)

        return responses  # type: ignore[return-value]

    def _resolve_now(self, now: Optional[int]) -> int:
        return millisecond_now() if now is None else now

    def _compact_eligible(self, buf) -> bool:
        """May this window travel in the compact wire format?  A limit or
        duration outside the caps disables compact dispatch permanently
        (those values persist in the arena); a hits violation only routes
        THIS window to the full path (JAX engine.py:1283)."""
        if self._compact_sound:
            dur_cap = np.where(buf.algo == kernel.SLIDING_WINDOW,
                               kernel.SLIDING_MAX_DURATION,
                               kernel.COMPACT_MAX_DURATION)
            cfg_ok = (
                bool((buf.limit >= 0).all())
                and bool((buf.limit < kernel.COMPACT_MAX_LIMIT).all())
                and bool((buf.duration >= 0).all())
                and bool((buf.duration < dur_cap).all())
            )
            if not cfg_ok:
                self._compact_enabled = False
                self._compact_sound = False
        if not self._compact_enabled or not self._compact_sound:
            return False
        conc = buf.algo == kernel.CONCURRENCY
        h_lo = np.where(conc, 1 - kernel.CONC_MAX_HITS, 0)
        h_hi = np.where(conc, kernel.CONC_MAX_HITS, kernel.COMPACT_MAX_HITS)
        return (
            bool(((buf.hits >= h_lo) & (buf.hits < h_hi)).all())
            and bool(((buf.algo >= 0)
                      & (buf.algo <= kernel.CONCURRENCY)).all())
        )

    def _lane_bucket(self, max_fill: int) -> int:
        """Occupied-prefix lane width: the smallest lane bucket >= max_fill,
        so the host<->device transfer follows occupancy, not capacity."""
        for b in self._lane_bucket_list:
            if b >= max_fill:
                return b
        return self.batch_per_shard

    def _dispatch(self, now: int, reg_fill: Optional[int] = None):
        """Run the staged buffers through the kernels; returns host copies
        of the responses: the regular window as a WindowOutput of [S, lanes]
        numpy arrays, the GLOBAL window as i64[S, Bg, 4] (status, limit,
        remaining, reset_time), or None when it staged nothing.

        Compact-eligible windows are sliced to the occupied-prefix bucket
        and travel as wire words; the rest take the full int64 columns at
        full width."""
        buf = self._buf
        compact = self._compact_eligible(buf)
        with record_function("guber_window" if compact
                             else "guber_window_full"):
            lanes = (self._lane_bucket(reg_fill)
                     if compact and reg_fill is not None
                     else self.batch_per_shard)
            stage = self._staging.array
            if compact:
                packed = kernel.encode_batch_host(
                    buf.slot[:, :lanes], buf.hits[:, :lanes],
                    buf.limit[:, :lanes], buf.duration[:, :lanes],
                    buf.algo[:, :lanes], buf.is_init[:, :lanes])
                if self.per_op:
                    wire = kernel.encode_output_compact(
                        self._step_per_op(kernel.decode_batch(
                            stage("packed", packed)), now), now)
                else:
                    words, limits, _ = drain_kernel.drain_compact(
                        self.state, stage("packed", packed[None]),
                        stage("nows", np.full(1, now, np.int64)))
                    wire = torch.stack([words[0], limits[0]], dim=-1)
            else:
                batch = WindowBatch(*[
                    stage(f"full.{name}", a[:, :lanes])
                    for name, a in zip(WindowBatch._fields,
                                       (buf.slot, buf.hits, buf.limit,
                                        buf.duration, buf.algo, buf.is_init))])
                if self.per_op:
                    fout = self._step_per_op(batch, now)
                else:
                    fout = drain_kernel.window_full(self.state, batch, now)
            self.windows_processed += 1
            gout = None
            ups = buf.ups()
            if _control_live(buf.gslot, buf.upd(), self.global_capacity, ups):
                gout = self._global_window(buf.gbatch(), buf.ghits_acc,
                                           buf.upd(), now, ups)
            # one fetch point: the responses come back after both launches
            if compact:
                out = kernel.decode_output_host(wire.cpu().numpy(), now)
            else:
                out = WindowOutput(*[f.cpu().numpy() for f in fout])
            return out, (None if gout is None else gout.cpu().numpy())

    def _step_per_op(self, batch: WindowBatch, now: int) -> WindowOutput:
        """One window of [S, B] decoded lanes through the per-op lowering:
        window_step_per_op (torch prep, the window-math kernel, torch
        commit) on each shard in turn, the touched rows scattered into the
        shard's planes in place.  Returns the responses [S, B], pad lanes
        0."""
        outs = []
        for s in range(self.num_shards):
            _, out = window_math_kernel.window_step_per_op(
                BucketState(*[p[s] for p in self.state]),
                WindowBatch(*[t[s] for t in batch]), now, in_place=True)
            outs.append(out)
        return WindowOutput(*[torch.stack(f) for f in zip(*outs)])

    def _global_window(self, gbatch: WindowBatch, gacc, upd,
                       now: int, ups=None) -> torch.Tensor:
        """One GLOBAL window (JAX engine.py:2617-2700, _apply_control and
        _global_window): gbatch/gacc [S, Bg] lanes, upd's Kg config-write
        and reset lanes and ups's upsert lanes (host arrays, or None)
        packed into the engine's pinned control block, one non-blocking
        copy to the device, then one launch of global_window: the upserts,
        the config writes and resets, every lane's read,
        and the hits summed per slot over every shard (the mesh psum)
        applied to the touched rows, in place.  Under the per-op lowering
        global_stage writes the config and sums the hits, the replica reads
        are torch ops (kernel.global_read) on the staged arena, and
        global_apply applies the sums after them in stream order.  Nothing
        here waits for the device.  Returns the read block i64[S, Bg, 4] on
        the device, pad lanes 0."""
        n, kg = int(np.size(gacc)), int(np.size(upd[0]))
        ku = 0 if ups is None else int(np.size(ups[0]))
        block = self._staging.stage(
            "control", global_kernel.control_words(n, kg, ku),
            lambda view: global_kernel.pack_control(view, gbatch, gacc, upd,
                                                    ups))
        ctl = global_kernel.Control(block, n, kg, ku)
        if self.per_op:
            global_kernel.global_stage(self.gstate, self.gcfg, ctl,
                                       self._gsums)
            # a 0-d tensor filled on the device: torch.as_tensor(now,
            # device=cuda) would copy from pageable memory and wait
            now_t = torch.full((), now, dtype=torch.int64, device=self.device)
            read = global_kernel.global_read_block(self.gstate, ctl, now_t)
            global_kernel.global_apply(self.gstate, self.gcfg, ctl,
                                       self._gsums, now)
        else:
            read = global_kernel.global_window(self.gstate, self.gcfg, ctl,
                                               self._gsums, now)
        return read.reshape(*np.shape(gbatch.slot), 4)

    def pipeline_dispatch(self, packed, nows, n_windows: Optional[int] = None):
        """Dispatch a stacked compact drain WITHOUT fetching: K windows over
        every shard in one kernel launch.  packed: i64[K, S, B, 2] compact
        request stack (numpy or tensor); nows: i64[K] per-window
        timestamps.  Returns device tensors (words i64[K, S, B], limits
        i64[K, S, B], mism bool[K, S]).  The caller guarantees compact
        eligibility.  A pinned host tensor (the serving pipeline's arena)
        crosses in one non-blocking copy and must stay unchanged until
        the drain's outputs have been fetched (fetch_async's event)."""
        with record_function("guber_drain"):
            return self._drain(packed, nows, n_windows)

    def fetch_async(self, pairs) -> Optional["torch.cuda.Event"]:
        """Start copying each (device tensor, host tensor) pair of `pairs`
        into its host tensor - pinned, on a CUDA engine - without waiting,
        and return an event recorded behind the copies: once it has passed
        the host tensors hold the values, and everything queued before it
        on the stream (the drain that made them, the copies that fed it)
        is done.  On a CPU engine the copies are done on return and the
        event is None."""
        with record_function("guber_fetch"):
            for src, dst in pairs:
                dst.copy_(src, non_blocking=True)
            if self.device.type != "cuda":
                return None
            ev = torch.cuda.Event()
            ev.record()
            return ev

    def _drain(self, packed, nows, n_windows: Optional[int],
               tenants=None):
        """One launch of the compact drain, or with `tenants` (lane tenant
        ids [K, S, B]) of the stats drain into the analytics accumulator.
        Under the per-op lowering the windows run one at a time through
        _drain_per_op, and `tenants` is not read (the caller reduces the
        stats in torch ops)."""
        stage = self._staging.array
        packed = stage("packed", packed, torch.int64)
        if self.per_op:
            out = self._drain_per_op(packed, nows)
        else:
            nows = stage("nows", nows, torch.int64)
            if tenants is None:
                out = drain_kernel.drain_compact(self.state, packed, nows)
            else:
                out = drain_kernel.drain_compact_stats(
                    self.state, packed, nows,
                    stage("tenants", tenants, torch.int32), self._an_acc)
        self.windows_processed += (int(packed.shape[0]) if n_windows is None
                                   else n_windows)
        return out

    def _drain_per_op(self, packed: torch.Tensor, nows):
        """The per-op lowering of a K-window compact drain (the JAX
        _drain_scan body, engine.py:2971): per window in order, decode the
        words, run each shard through window_step_per_op, encode the
        response words.  Returns what drain_compact returns: words and
        limits i64[K, S, B] (pad lanes 0) and mism bool[K, S]."""
        host_nows = torch.as_tensor(nows, dtype=torch.int64).cpu()
        words, limits, mism = [], [], []
        for k in range(packed.shape[0]):
            now = int(host_nows[k])
            bt = kernel.decode_batch(packed[k])
            out = self._step_per_op(bt, now)
            words.append(kernel.encode_output_word(out, now))
            limits.append(out.limit)
            mism.append(((out.limit != bt.limit) & (bt.slot >= 0)).any(-1))
        return torch.stack(words), torch.stack(limits), torch.stack(mism)

    def pipeline_dispatch_global(self, packed, nows, gbatch, gacc, upd,
                                 n_windows: Optional[int] = None,
                                 analytics_args=None):
        """pipeline_dispatch's K-window compact stack PLUS one GLOBAL window
        at nows[0] (JAX engine.py:1545): the config writes, the replica
        reads and the summed-hit apply.  gbatch: full-format GLOBAL
        WindowBatch [S, Bg] (PAD_SLOT lanes drop); gacc: the lanes'
        contributed hits i64[S, Bg]; upd: the 5-tuple of config-write and
        reset lanes (empty_drain_control gives inert padding for all
        three).  nows and the GLOBAL control are host arrays, numpy or CPU
        tensors, as the serving path stages them (a device tensor raises):
        now0 is read on the host and the control crosses in one pinned
        copy.  Returns device tensors (words, limits,
        mism, gfused) with gfused i64[S, Bg, 4] the GLOBAL responses
        (status, limit, remaining, reset_time).

        `analytics_args=(tenants, decay)` (analytics enabled): tenants
        i32[K, S, B] each lane's tenant id, decay 0 or 1 (halve the sketch
        first).  The drain then runs the stats drain kernel, and after the
        GLOBAL window the finisher kernel turns its sums into stats
        i64[S, V] against the post-drain expiry plane at nows[0], updating
        the resident sketch in place; the call returns (words, limits,
        mism, gfused, stats).  Under the per-op lowering the drain runs
        without tenants and the stats are analytics_dispatch's torch
        reduction over its words (the JAX engine's route without the
        staged kernels, engine.py:3136)."""
        with record_function("guber_drain" if analytics_args is None
                             else "guber_analytics"):
            now0 = int(_host(nows).reshape(-1)[0])
            tenants = decay = None
            if analytics_args is not None:
                conf = self._analytics_conf()
                tenants, decay = analytics_args
            words, limits, mism = self._drain(packed, nows, n_windows, tenants)
            gbatch = WindowBatch(*[_host(a) for a in gbatch])
            gacc, upd = _host(gacc), tuple(_host(a) for a in upd)
            if _control_live(gbatch.slot, upd, self.global_capacity):
                gfused = self._global_window(gbatch, gacc, upd, now0)
            else:
                gfused = torch.zeros((*tuple(gbatch.slot.shape), 4),
                                     dtype=torch.int64, device=self.device)
            if analytics_args is None:
                return words, limits, mism, gfused
            if self.per_op:
                stats = self.analytics_dispatch(packed, words, tenants, now0,
                                                decay)
                return words, limits, mism, gfused, stats
            stats = stats_kernel.stats_finish(
                self._an_sketch, self._an_acc, self.state.expire, now0,
                int(decay), topk=conf.topk, over_weight=conf.over_weight)
            return words, limits, mism, gfused, stats

    # ------------------------------------------------------ traffic analytics

    def enable_analytics(self, conf) -> None:
        """Allocate the resident per-shard count-min sketch i64[S, D, W] and
        the stats drain's accumulator, and record the reduction's geometry
        (config.AnalyticsConfig).  Call once at wiring time
        (core/service.py), before serving starts."""
        conf.validate()
        if conf.topk > self.capacity_per_shard:
            raise ValueError(f"Analytics.topk {conf.topk} exceeds the "
                             f"{self.capacity_per_shard} slots of a shard")
        S = self.num_shards
        self._an_conf = conf
        self._an_sketch = torch.zeros(
            (S, conf.sketch_depth, conf.sketch_width), dtype=torch.int64,
            device=self.device)
        if not self.per_op:  # the per-op lowering reduces in torch ops
            self._an_acc = stats_kernel.StatsAccumulator(
                S, self.capacity_per_shard, conf.tenant_slots, self.device)

    def _analytics_conf(self):
        if self._an_conf is None:
            raise RuntimeError("analytics is not enabled on this engine "
                               "(enable_analytics)")
        return self._an_conf

    def analytics_dispatch(self, packed, words, tenants, now: int,
                           decay: int) -> torch.Tensor:
        """The per-drain stats reduction on its own (JAX engine.py:1647),
        in torch ops (ops/analytics.py shard_stats) per shard: the drain's
        compact request stack [K, S, B, 2], its response words i64[K, S, B]
        and the lanes' tenant ids [K, S, B] against the current expiry
        plane; updates the resident sketch in place and returns stats
        i64[S, V] on the device.  decay=1 halves the sketch first."""
        with record_function("guber_analytics"):
            conf = self._analytics_conf()
            stage = self._staging.array
            packed = stage("packed", packed, torch.int64)
            words = stage("words", words, torch.int64)
            tenants = stage("tenants", tenants, torch.int32)
            out = []
            for s in range(self.num_shards):
                sk, stats = analytics.shard_stats(
                    self._an_sketch[s], packed[:, s], words[:, s],
                    tenants[:, s], self.state.expire[s], now, int(decay),
                    tenant_slots=conf.tenant_slots, topk=conf.topk,
                    over_weight=conf.over_weight)
                self._an_sketch[s].copy_(sk)
                out.append(stats)
            return torch.stack(out)

    def export_analytics(self) -> np.ndarray:
        """The resident sketch as host i64[S, D, W]."""
        self._analytics_conf()
        return self._an_sketch.cpu().numpy().copy()

    def import_analytics(self, sketch) -> None:
        """Overwrite the resident sketch with host i64[S, D, W] (the JAX
        engine's `np.asarray(eng._an_sketch)`)."""
        self._analytics_conf()
        src = np.asarray(sketch)
        if src.shape != tuple(self._an_sketch.shape):
            raise ValueError(f"sketch: want {tuple(self._an_sketch.shape)}, "
                             f"got {src.shape}")
        self._an_sketch.copy_(torch.from_numpy(np.array(src, np.int64)))

    def empty_drain_control(self):
        """(gbatch, gacc, upd) padding for a pipeline_dispatch_global that
        carries no GLOBAL lanes (JAX engine.py:1071): slots one past the
        arena, which drop.  A drain never carries upserts (they ride
        step's windows), as in the JAX engine."""
        S, Bg, G, Kg = (self.num_shards, self.global_batch_per_shard,
                        self.global_capacity, self.max_global_updates)
        gbatch = WindowBatch(
            slot=np.full((S, Bg), kernel.PAD_SLOT, np.int32),
            hits=np.zeros((S, Bg), np.int64),
            limit=np.zeros((S, Bg), np.int64),
            duration=np.zeros((S, Bg), np.int64),
            algo=np.zeros((S, Bg), np.int32),
            is_init=np.zeros((S, Bg), bool),
        )
        gacc = np.zeros((S, Bg), np.int64)
        upd = (np.full((Kg,), G, np.int32), np.zeros((Kg,), np.int64),
               np.zeros((Kg,), np.int64), np.zeros((Kg,), np.int32),
               np.full((Kg,), G, np.int32))
        return gbatch, gacc, upd

    def warmup(self, now: Optional[int] = None) -> None:
        """Build the kernels and launch each serving shape once on an empty
        window: the full format at full width, every compact lane bucket,
        a one-window stacked drain (with the native router one stacked
        drain per PIPELINE_K_BUCKETS depth, the serving pipeline's shapes)
        and a GLOBAL window at full width, and with analytics enabled the
        composed drain with analytics (zero tenants, no decay: the sketch
        stays as it was).  Leaves both arenas as they were."""
        now = self._resolve_now(now)
        saved = self._compact_enabled
        self._compact_enabled = False
        self._buf.reset(self.global_capacity)
        self._dispatch(now)
        self._compact_enabled = saved
        if saved:
            for lanes in self._lane_bucket_list:
                self._buf.reset(self.global_capacity)
                self._dispatch(now, reg_fill=lanes)
        for kb in PIPELINE_K_BUCKETS if self.native is not None else (1,):
            packed = np.zeros((kb, self.num_shards, self.batch_per_shard, 2),
                              np.int64)
            _, _, mism = self.pipeline_dispatch(
                packed, np.full(kb, now, np.int64), n_windows=0)
        packed = packed[:1]
        read = self._global_window(*self.empty_drain_control(), now)
        mism.cpu()
        read.cpu()
        if self._an_conf is not None:
            out = self.pipeline_dispatch_global(
                packed, np.full(1, now, np.int64), *self.empty_drain_control(),
                n_windows=0, analytics_args=(np.zeros(
                    packed.shape[:3], np.int32), 0))
            out[4].cpu()

    def process(self, requests: Sequence[RateLimitReq],
                now: Optional[int] = None,
                accumulate: Optional[Sequence[bool]] = None
                ) -> List[RateLimitResp]:
        """step() with automatic chunking when a window overflows the caps
        (with the native router, `_process_native` chunks itself)."""
        if self.native is not None:
            return self._process_native(requests, now, accumulate)
        out: List[RateLimitResp] = []
        acc = (list(accumulate) if accumulate is not None
               else [True] * len(requests))
        pos = 0
        while pos < len(requests):
            n = self.max_window_prefix(requests[pos:])
            out.extend(self.step(requests[pos:pos + n], now,
                                 acc[pos:pos + n]))
            pos += n
        return out

    def routing_error(self, r: RateLimitReq) -> Optional[str]:
        """Why this request cannot be served by THIS engine, or None.  One
        process holds every shard and registers GLOBAL keys on first use,
        so every well-formed request is servable here."""
        return None

    def max_window_prefix(self, requests: Sequence[RateLimitReq]) -> int:
        """How many leading requests fit in ONE step() window (>= 1 when any
        are given): the per-shard lane cap, the GLOBAL lane cap
        (num_shards x global_batch_per_shard), the distinct-GLOBAL-key cap
        (max_global_updates), and the replay-bound guard that cuts a
        NON-uniform duplicate-key run longer than replay_cap lanes."""
        S = self.num_shards
        reg_fill = [0] * S
        g_count = 0
        gkeys: set = set()
        cap = self.replay_cap
        runs: dict = {}  # key -> [first (h,l,d,a), lanes, nonuniform]
        for i, r in enumerate(requests):
            key = r.hash_key()
            if r.behavior == Behavior.GLOBAL:
                new_gkey = 0 if key in gkeys else 1
                if (g_count + 1 > S * self.global_batch_per_shard
                        or len(gkeys) + new_gkey > self.max_global_updates):
                    return max(i, 1)
                g_count += 1
                gkeys.add(key)
                continue
            s = shard_of(key, S)
            if reg_fill[s] + 1 > self.batch_per_shard:
                return max(i, 1)
            if cap:
                tup = (r.hits, r.limit, r.duration, r.algorithm)
                run = runs.get(key)
                if run is None:
                    runs[key] = [tup, 1, r.hits == 0]
                else:
                    run[1] += 1
                    if not run[2] and (tup != run[0] or r.hits == 0):
                        run[2] = True
                    if run[2] and run[1] > cap:
                        return max(i, 1)
            reg_fill[s] += 1
        return len(requests)

    # ------------------------------------------------------------ metrics

    @property
    def cache_size(self) -> int:
        reg = (self.native.size if self.native is not None
               else sum(len(t) for t in self.tables))
        return reg + len(self.gtable)

    @property
    def cache_hits(self) -> int:
        reg = (self.native.hits if self.native is not None
               else sum(t.hits for t in self.tables))
        return reg + self.gtable.hits

    @property
    def cache_misses(self) -> int:
        reg = (self.native.misses if self.native is not None
               else sum(t.misses for t in self.tables))
        return reg + self.gtable.misses

    def cache_stats(self, now: Optional[int] = None) -> dict:
        """Hit/miss counters plus free/live/expired slot occupancy (by the
        host expiry estimates) of the regular keys (the router's or the
        tables') and the GLOBAL table."""
        now = int(now) if now is not None else millisecond_now()
        if self.native is not None:
            live, expired, free = self.native.occupancy(now)
        else:
            live = expired = free = 0
            for t in self.tables:
                st = t.stats(now)
                free += st["free"]
                live += st["live"]
                expired += st["expired"]
        g = self.gtable.stats(now)
        return {
            "size": self.cache_size,
            "capacity": (self.num_shards * self.capacity_per_shard
                         + self.global_capacity),
            "hits": self.cache_hits,
            "misses": self.cache_misses,
            "free": free + g["free"],
            "live": live + g["live"],
            "expired": expired + g["expired"],
        }

    # ------------------------------------------------------- state transfer

    def _planes(self) -> Dict[str, torch.Tensor]:
        return dict(zip(ARENA_FIELDS + GSTATE_FIELDS + GCFG_FIELDS,
                        (*self.state, *self.gstate, *self.gcfg)))

    def import_arena(self, planes: Dict[str, np.ndarray]) -> None:
        """Overwrite the arenas with host planes - the JAX engine's
        `np.asarray(eng.state.<field>)` [S, C] under BucketState's field
        names, and optionally its `gstate.<field>` [G] and
        `gcfg.<field>` [G] under "gstate.<field>" / "gcfg.<field>" (each
        group whole or not at all).  int64, algo int32."""
        names = list(ARENA_FIELDS)
        for group in (GSTATE_FIELDS, GCFG_FIELDS):
            given = [n for n in group if n in planes]
            if given and len(given) != len(group):
                raise ValueError(f"planes {sorted(set(group) - set(given))} "
                                 f"missing from a partial {group[0]} group")
            names += given
        dst_of = self._planes()
        for name in names:
            dst = dst_of[name]
            src = np.asarray(planes[name])
            if src.shape != tuple(dst.shape):
                raise ValueError(f"plane {name}: want {tuple(dst.shape)}, "
                                 f"got {src.shape}")
            dt = np.int32 if name.endswith("algo") else np.int64
            dst.copy_(torch.from_numpy(np.array(src, dtype=dt)))

    def export_arena(self) -> Dict[str, np.ndarray]:
        """The arenas as host planes: [S, C] under BucketState's field
        names, [G] under "gstate.<field>" and "gcfg.<field>"."""
        return {name: t.cpu().numpy().copy()
                for name, t in self._planes().items()}

    # ------------------------------------------------------ state lifecycle

    def export_state(self, now: Optional[int] = None, layout: str = "auto"):
        """The arenas and key maps as a state/snapshot.py ArenaSnapshot
        (JAX engine.py:1858): one device-to-host copy a plane, then the
        key tables (the Python tables' entries, or the native router's
        fingerprints, shard by shard) and the warm tier's rows when tiers
        are on.  `layout` picks the file's time encoding ("int64",
        "compact32", or "auto": compact32 while the compact latch holds);
        dumps widens to int64 whenever compact32 cannot hold the data
        exactly.  Call it where no window is half staged (the engine
        thread, core/service.py)."""
        now = self._resolve_now(now)
        if self.native is not None and self.native.exact:
            raise SnapshotError(
                "exact-keys native router cannot export its key map "
                "(key bytes are not part of the export format); disable "
                "GUBER_EXACT_KEYS / EngineConfig.exact_keys to snapshot")
        arena = self.export_arena()
        planes = {n: arena[n] for n in ARENA_FIELDS}
        gplanes = {n: arena[f"gstate.{n}"] for n in BucketState._fields}
        gcfg = {n: arena[f"gcfg.{n}"] for n in GlobalConfig._fields}
        tables, native_tables = [], []
        if self.native is not None:
            backend = "native"
            native_tables = [self.native.export_keys(s)
                             for s in range(self.num_shards)]
        else:
            backend = "python"
            tables = [_table_columns(t) for t in self.tables]
        warm = (None if self._tiers is None
                else self._tiers.warm.export_rows())
        if layout == "auto":
            layout = "compact32" if self._compact_sound else "int64"
        return ArenaSnapshot(
            now=now, layout=layout, warm=warm,
            num_shards=self.num_shards,
            capacity_per_shard=self.capacity_per_shard,
            global_capacity=self.global_capacity,
            num_local_shards=self.num_shards, local_shard_offset=0,
            compact_sound=self._compact_sound, backend=backend,
            planes=planes, gplanes=gplanes, gcfg=gcfg,
            tables=tables, native_tables=native_tables,
            gtable=_table_columns(self.gtable), gpending=[])

    def import_state(self, snap, rebase_to: Optional[int] = None) -> None:
        """Replace the arenas and key maps with a snapshot's (JAX
        engine.py:1932).  Times stay absolute by default: the downtime
        counts against every TTL, as if the process had kept running.
        `rebase_to` shifts every live time by (rebase_to - snap.now)
        instead, keeping each bucket's remaining lifetime across a change
        of clock domain.  Refuses (SnapshotError) another geometry, a mesh
        snapshot (GLOBAL keys pending registration), a native snapshot
        into Python tables (fingerprints cannot give back key strings) and
        an exact-keys router.  A Python-table snapshot restores into the
        native router with the fingerprints the router would assign."""
        geometry = dict(num_shards=self.num_shards,
                        capacity_per_shard=self.capacity_per_shard,
                        global_capacity=self.global_capacity,
                        num_local_shards=self.num_shards,
                        local_shard_offset=0)
        for attr, want in geometry.items():
            if getattr(snap, attr) != want:
                raise SnapshotError(
                    f"snapshot geometry mismatch: {attr}={getattr(snap, attr)}"
                    f" but engine has {want}")
        if snap.gpending:
            raise SnapshotError(
                f"snapshot holds {len(snap.gpending)} GLOBAL keys pending "
                "mesh registration; a single-process engine cannot restore "
                "a mesh snapshot")
        if snap.backend == "native" and self.native is None:
            raise SnapshotError(
                "snapshot holds a native fingerprint table but this engine "
                "routes in Python; key strings cannot be recovered from "
                "fingerprints")
        if self.native is not None and self.native.exact:
            raise SnapshotError(
                "exact-keys native router cannot import a snapshot key map "
                "(stored keys would stay empty and every lookup would "
                "collide); disable exact_keys to restore")
        shift = 0 if rebase_to is None else int(rebase_to) - snap.now

        def shifted(planes):
            if shift == 0:
                return planes
            out = dict(planes)
            live = planes["expire"] != 0
            for name in ("tstamp", "expire"):
                a = planes[name].copy()
                a[live] += shift
                out[name] = a
            return out

        rp, gp = shifted(snap.planes), shifted(snap.gplanes)
        self.import_arena({**rp, **{f"gstate.{n}": a for n, a in gp.items()},
                           **{f"gcfg.{n}": a for n, a in snap.gcfg.items()}})
        if snap.backend == "native":
            for s in range(self.num_shards):
                fp, slots, exps = snap.native_tables[s]
                self.native.import_keys(
                    s, np.asarray(fp, np.uint64), np.asarray(slots, np.int32),
                    np.asarray(exps, np.int64) + shift)
        elif self.native is not None:
            # A Python-table snapshot into the router: the fingerprints the
            # C router assigns (FNV-1a 64), and each key's expiry from the
            # device plane, not the table.  The table's estimate may lag
            # the kernel (leaky hits extend expire on the device only),
            # which the Python tables never act on, but the router trusts
            # its host expiry at lookup and would start a live bucket over.
            for s, (keys, slots, exps) in enumerate(snap.tables):
                fp = np.asarray([_fnv1a64(k.encode("utf-8")) for k in keys],
                                np.uint64)
                si = np.asarray(slots, np.int64)
                dev = rp["expire"][s, si] if len(si) else \
                    np.empty(0, np.int64)
                self.native.import_keys(
                    s, fp, np.asarray(slots, np.int32),
                    np.maximum(np.asarray(exps, np.int64) + shift, dev))
        else:
            for t, (keys, slots, exps) in zip(self.tables, snap.tables):
                t.restore_entries(zip(
                    keys, np.asarray(slots, np.int64).tolist(),
                    (np.asarray(exps, np.int64) + shift).tolist()))
        gkeys, gslots, gexps = snap.gtable if snap.gtable else ([], [], [])
        self.gtable.restore_entries(zip(
            gkeys, np.asarray(gslots, np.int64).tolist(),
            (np.asarray(gexps, np.int64) + shift).tolist()))
        warm = snap.warm
        if self._tiers is not None:
            tm = self._tiers
            now_r = self._resolve_now(rebase_to)
            # an import replaces all key state: a fresh warm store (its
            # epoch the restore clock) takes the snapshot's warm rows,
            # shifted as the arenas are
            tm.warm = WarmStore(tm.conf.warm_rows, tm.conf.layout,
                                epoch=now_r)
            tm.pending_spills.clear()
            tm.pending_promos.clear()
            if warm is not None:
                tm.warm.restore_rows(warm[0], warm[1], now=now_r,
                                     shift=shift)
        elif warm is not None and len(warm[0]):
            log.warning(
                "snapshot carries %d warm-tier rows but tiers are disabled "
                "on this engine; dropping them to cold (keys re-init from "
                "request configs)", len(warm[0]))
        if not snap.compact_sound:
            # the snapshotted arena held out-of-range configs: the compact
            # latch trips as it would have live
            self._compact_sound = False
            self._compact_enabled = False

    # ------------------------------------------------------ live migration
    #
    # The row API of state/migrate.py (JAX engine.py:2045-2258): a ring
    # change ships live rows between nodes.  The native router keeps
    # fingerprints, not key strings, so regular-key migration needs the
    # Python tables.  The gathers and scatters are torch indexing on the
    # device's planes (the JAX package's XLA _gather_rows_jit and
    # _scatter_rows_jit), one of each a call, as the tier fence's.  Call
    # these where no window is half staged (the engine thread).

    def _check_migratable(self) -> None:
        if self.native is not None:
            raise RuntimeError(
                "native router does not retain key strings; live migration "
                "needs the Python tables (EngineConfig use_native=False)")

    def local_keys(self) -> List[str]:
        """Every committed regular key resident on this engine."""
        self._check_migratable()
        out: List[str] = []
        for t in self.tables:
            out.extend(k for k in t.keys() if not t.is_pending(k))
        return out

    def global_keys(self) -> List[str]:
        """Every committed GLOBAL key registered on this engine."""
        return [k for k in self.gtable.keys()
                if not self.gtable.is_pending(k)]

    def export_rows(self, keys: Sequence[str]) -> List[dict]:
        """The live device rows of `keys` (regular arena) as host dicts.
        Keys not resident here, still pending their initializing dispatch,
        or whose device row was never written (expire 0) are skipped."""
        self._check_migratable()
        picks = []
        for key in keys:
            s = shard_of(key, self.num_shards)
            t = self.tables[s]
            slot = t.peek(key)
            if slot is None or t.is_pending(key):
                continue
            picks.append((key, s, slot))
        if not picks:
            return []
        vals = self._gather_rows([(s, slot) for _, s, slot in picks])
        rows = []
        for (key, _s, _slot), v in zip(picks, vals.T.tolist()):
            if v[4] == 0:
                continue  # registered but never initialized on the device
            row = dict(zip(ARENA_FIELDS, v))
            row["key"] = key
            rows.append(row)
        return rows

    def import_rows(self, rows: Sequence[dict],
                    now: Optional[int] = None) -> tuple:
        """Install migrated regular rows into the arena.  Returns
        (imported, skipped_stale).  An incoming row never clobbers a
        fresher local entry: a key pending its initializing dispatch (a
        request already arrived here), or a committed row whose device
        expire is at least the incoming one's.

        With the warm tier on, an allocation may spill an LRU victim whose
        device row the fence gathers later.  Two departures from the JAX
        engine (ROADMAP Queue 3), whose import runs inside the last
        window: there, a victim that window touched drops to cold as
        stale, and the imported row is scattered into the victim's slot
        before the fence, which then stores the imported key's row as the
        victim's.  The port opens a window of its own for the import and
        resolves the pending spills before the scatter."""
        self._check_migratable()
        now = self._resolve_now(now)
        skipped = 0
        cand = []
        for row in rows:
            key = row["key"]
            s = shard_of(key, self.num_shards)
            t = self.tables[s]
            if t.is_pending(key):
                skipped += 1
                continue
            cand.append((key, s, t.peek(key), row))
        # one gather for every already-resident key's device expire
        resident = [(i, s, slot) for i, (_, s, slot, _) in enumerate(cand)
                    if slot is not None]
        dev_expire = {}
        if resident:
            exp = self._gather_rows([(s, slot) for _, s, slot in resident])[4]
            dev_expire = {i: int(exp[j]) for j, (i, _, _) in
                          enumerate(resident)}
        winners = []
        for i, (key, s, _slot, row) in enumerate(cand):
            if i in dev_expire and dev_expire[i] >= row["expire"]:
                skipped += 1
                continue
            winners.append((key, s, row))
        if not winners:
            return 0, skipped
        # the import is a window of its own: a key the last window touched
        # is committed on the device, so it may spill as any other victim
        for t in self.tables:
            t.begin_window()
        where = [(s, self.tables[s].upsert(key, now, row["expire"]))
                 for key, s, row in winners]
        if self._tiers is not None and self._tiers.pending_spills:
            self._tier_fence(now)
        self._scatter_rows(where, np.asarray(
            [[row[f] for _, _, row in winners] for f in ARENA_FIELDS],
            np.int64))
        return len(winners), skipped

    def export_global_rows(self, keys: Sequence[str]) -> List[dict]:
        """GLOBAL rows (the replica's state and the registration config)
        for re-registration on a new owner.  A registered key whose state
        row was never written still exports (expire 0): its config must
        move for the new owner to serve it."""
        picks = []
        for key in keys:
            slot = self.gtable.peek(key)
            if slot is None or self.gtable.is_pending(key):
                continue
            picks.append((key, slot))
        if not picks:
            return []
        vals = self._gather_planes((*self.gstate, *self.gcfg),
                                   [slot for _, slot in picks])
        names = ARENA_FIELDS + tuple(f"cfg_{f}" for f in GlobalConfig._fields)
        rows = []
        for (key, _slot), v in zip(picks, vals.T.tolist()):
            row = dict(zip(names, v))
            row["key"] = key
            rows.append(row)
        return rows

    def import_global_rows(self, rows: Sequence[dict],
                           now: Optional[int] = None) -> tuple:
        """Register and install migrated GLOBAL rows.  Returns (imported,
        skipped_stale), by import_rows' rule, except that a row with
        expire 0 over a resident expire 0 imports: such a row registers
        its config only (its state row stays dead until traffic
        initializes it).  The resident keys' device expires come from one
        gather (the JAX engine reads the device once a key)."""
        now = self._resolve_now(now)
        skipped = 0
        cand = []
        for row in rows:
            key = row["key"]
            if self.gtable.is_pending(key):
                skipped += 1
                continue
            cand.append((row, self.gtable.peek(key)))
        resident = [(i, slot) for i, (_, slot) in enumerate(cand)
                    if slot is not None]
        dev_expire = {}
        if resident:
            exp = self._gather_planes((self.gstate.expire,),
                                      [slot for _, slot in resident])[0]
            dev_expire = {i: int(exp[j]) for j, (i, _) in
                          enumerate(resident)}
        winners = []
        for i, (row, _slot) in enumerate(cand):
            dev = dev_expire.get(i)
            if (dev is not None and dev >= row["expire"]
                    and not (dev == 0 and row["expire"] == 0)):
                skipped += 1
                continue
            winners.append(row)
        if not winners:
            return 0, skipped
        self.gtable.begin_window()  # a window of its own, as import_rows
        slots = []
        for row in winners:
            est = row["expire"] if row["expire"] else now + row["cfg_duration"]
            slots.append(self.gtable.upsert(row["key"], now, est))
        fields = ARENA_FIELDS + tuple(f"cfg_{f}" for f in GlobalConfig._fields)
        self._scatter_planes((*self.gstate, *self.gcfg), slots, np.asarray(
            [[row[f] for row in winners] for f in fields], np.int64))
        return len(winners), skipped

    def remove_keys(self, keys: Sequence[str]) -> int:
        """Drop regular keys from the tables after they migrated away.
        Their device rows become dead tenants: a reuse of the slot
        initializes it again, and routing no longer sends these keys
        here."""
        self._check_migratable()
        removed = 0
        for key in keys:
            s = shard_of(key, self.num_shards)
            if key in self.tables[s]:
                self.tables[s].remove(key)
                removed += 1
        return removed

    # --------------------------------------------------------- tiered state
    #
    # The warm tier (state/tiers.py): the fixed arena becomes a managed
    # cache over an unbounded key space.  Demotion rides SlotTable._reclaim
    # through the spill hook, promotion happens in _stage_requests, and both
    # resolve in ONE gather and ONE scatter at the fence before each
    # dispatch: torch indexing on the device's planes (the JAX engine's
    # _gather_rows_jit / _scatter_rows_jit), never a host copy of the arena.
    # All of it runs on the dispatch thread.  A moved row is expired when the
    # kernels read it so, expire < now; the JAX tier also drops expire ==
    # now, which a later window at the same clock then starts cold (ROADMAP
    # Queue 3), so the port departs from it there.

    def enable_tiers(self, conf, analytics=None,
                     epoch: Optional[int] = None):
        """Install the warm tier (JAX engine.py:2268).  It needs the Python
        routing tables (the native router keeps fingerprints, not key
        strings) and warm capacity.  `epoch` anchors the store's compact32
        rebase (default: now)."""
        if self.native is not None:
            raise RuntimeError(
                "native router does not retain key strings; the warm tier "
                "needs the Python tables (EngineConfig use_native=False)")
        if conf.warm_rows <= 0:
            raise ValueError(
                "enable_tiers needs warm capacity (GUBER_TIER_WARM > 0); "
                "warm_rows=0 means tiers stay off")
        t = TierManager(conf, epoch=self._resolve_now(epoch),
                        analytics=analytics)
        self._tiers = t
        for s, table in enumerate(self.tables):
            table.spill_cb = (
                lambda key, slot, expire, stale, _s=s:
                t.on_spill(_s, key, slot, expire, stale))
            table.heat_fn = t.heat
            table.victim_sample = conf.victim_sample
        return t

    def tier_stats(self) -> Optional[dict]:
        """The tier counters and warm occupancy, or None when tiers are
        off."""
        return None if self._tiers is None else self._tiers.stats()

    def _gather_rows(self, where: List[tuple]) -> np.ndarray:
        """Rows (shard, slot) of the regular arena as host int64 [6, n]
        (BucketState order): one gather on the device, padded to a power
        of two, and one copy to the host."""
        C = self.capacity_per_shard
        return self._gather_planes(self.state,
                                   [s * C + sl for s, sl in where])

    def _scatter_rows(self, where: List[tuple], vals: np.ndarray) -> None:
        """Write host rows vals int64 [6, n] (BucketState order) into
        (shard, slot) of the regular arena, in place."""
        C = self.capacity_per_shard
        self._scatter_planes(self.state, [s * C + sl for s, sl in where],
                             vals)

    def _gather_planes(self, planes, flat: List[int]) -> np.ndarray:
        """Rows at flat indices of same-shaped planes as host int64
        [len(planes), n]: one index_select a plane on the device, padded to
        a power of two (pads read row 0, dropped), and one copy to the
        host."""
        n = len(flat)
        idx = np.zeros(_pad_pow2(n), np.int64)
        idx[:n] = flat
        dev = self._staging.array("rows.gather", idx)
        got = torch.stack([p.reshape(-1).index_select(0, dev).to(torch.int64)
                           for p in planes])
        return got.cpu().numpy()[:, :n]

    def _scatter_planes(self, planes, flat: List[int],
                        vals: np.ndarray) -> None:
        """Write host rows vals int64 [len(planes), n] at flat indices of
        same-shaped planes, in place: one copy to the device, padded to a
        power of two (pads repeat the first row, so a pad writes what the
        first row writes), and one index_put_ a plane."""
        n = len(flat)
        m = _pad_pow2(n)
        block = np.empty((len(planes) + 1, m), np.int64)
        block[0, :n] = flat
        block[0, n:] = flat[0]
        block[1:, :n] = vals
        block[1:, n:] = np.asarray(vals)[:, :1]
        dev = self._staging.array("rows.scatter", block)
        for f, plane in enumerate(planes):
            plane.view(-1).index_put_((dev[0],), dev[f + 1].to(plane.dtype))

    def _tier_fence(self, now: int) -> None:
        """Resolve every demotion and promotion pending since the last
        dispatch (JAX engine.py:2297), before this window's dispatch: the
        victims' device rows are still intact, and the promoted rows are
        resident when the kernel reads them.  One gather and one scatter a
        window however many keys moved; a spill row found dead or expired
        on the device drops to cold (the kernel's lazy expiry reads it as
        a miss, so an arena that never evicts starts it over too)."""
        t = self._tiers
        t.fences += 1
        if t.analytics is not None and t.fences % 256 == 0:
            t.refresh_heat()
        spills, promos = t.drain_pending()
        if not spills and not promos:
            return
        # one gather covers the spills AND the from-spill promotion sources
        gather = [(sh, sl) for _, sh, sl in spills]
        src_ix = {}
        for key, p in promos:
            if p[3] is not None:
                src_ix[key] = len(gather)
                gather.append(tuple(p[3]))
        vals = self._gather_rows(gather) if gather else None
        puts = []
        for j, (key, _sh, _sl) in enumerate(spills):
            # expired by the kernels' rule (expire < now; 0 is dead): a row
            # with expire == now is live for a later window at this clock
            if vals[4, j] < now:
                t.counters["demote_dropped_expired"] += 1
                continue
            row = dict(zip(ROW_FIELDS, vals[:, j].tolist()))
            row["key"] = key
            puts.append(row)
        if puts:
            t.warm.put_batch(puts, now)
            t.counters["demotions"] += len(puts)
        if promos:
            rows = []
            for key, p in promos:
                if p[3] is not None:
                    row = dict(zip(ROW_FIELDS, vals[:, src_ix[key]].tolist()))
                    row["rel"] = False
                else:
                    row = p[2]
                rows.append(row)
            t.decode_rows(rows)
            self._scatter_rows(
                [(p[0], p[1]) for _, p in promos],
                np.asarray([[r[f] for r in rows] for f in ROW_FIELDS],
                           np.int64))
            t.counters["promotions"] += len(rows)

    def tier_maintain(self, now: Optional[int] = None) -> int:
        """Demotion ahead of need, between windows (JAX engine.py:2371):
        shards above the demote watermark spill their coldest committed
        entries to warm in one batch, so staging into a full arena pays
        spills at the fence instead of forced evictions a lookup.  Also
        refreshes the heat map.  Returns the entries demoted or dropped."""
        if self._tiers is None:
            return 0
        t = self._tiers
        now = self._resolve_now(now)
        t.refresh_heat()
        if t.pending_spills or t.pending_promos:
            # a staging pass ended before its dispatch: resolve what it
            # left first (those device rows are still the pre-dispatch ones)
            self._tier_fence(now)
        hi = int(t.conf.demote_watermark * self.capacity_per_shard)
        picks = []
        for s, table in enumerate(self.tables):
            excess = len(table) - hi
            if excess <= 0:
                continue
            take = min(excess, t.conf.demote_batch)
            scanned = 0
            for key in table.keys():              # LRU order, oldest first
                if take <= 0 or scanned >= 4 * t.conf.demote_batch:
                    break
                scanned += 1
                if table.is_pending(key) or t.heat(key) > 0.0:
                    continue                      # hot by analytics: kept
                picks.append((key, s, table.peek(key)))
                take -= 1
        if not picks:
            return 0
        vals = self._gather_rows([(s, slot) for _, s, slot in picks])
        puts = []
        for j, (key, s, _slot) in enumerate(picks):
            self.tables[s].remove(key)
            if vals[4, j] < now:
                t.counters["demote_dropped_expired"] += 1
                continue
            row = dict(zip(ROW_FIELDS, vals[:, j].tolist()))
            row["key"] = key
            puts.append(row)
        if puts:
            t.warm.put_batch(puts, now)
            t.counters["demotions"] += len(puts)
        return len(picks)


def _table_columns(table: SlotTable) -> tuple:
    """A SlotTable's committed entries, oldest first, as (keys, slot
    i32[n], expire i64[n])."""
    ents = table.export_entries()
    return ([e[0] for e in ents], np.asarray([e[1] for e in ents], np.int32),
            np.asarray([e[2] for e in ents], np.int64))


def _pad_pow2(n: int) -> int:
    """The tier fence's index vectors padded to a power of two (>= 8), as
    the JAX engine pads its gather and scatter."""
    return max(8, 1 << (n - 1).bit_length())


def _fnv1a64(data: bytes) -> int:
    """FNV-1a 64 over key bytes, bit-identical to host_router.cc fnv1a64
    (the router's literal seed, not the textbook offset basis), for
    restoring a Python-table snapshot into the router.  0 maps to 1 (0
    marks an empty table cell)."""
    h = 1469598103934665603
    for b in data:
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h if h else 1
