"""The rate-limit engine: host routing + one kernel launch per window.

The one-shard serving subset of `gubernator_tpu/core/engine.py`
(RateLimitEngine) on PyTorch.  The host maps each key to a slot of the
arena (state/arena.py SlotTable, the JAX engine's use_native=False path)
and stages the window's lanes; the device applies the whole window with
one launch of the window-drain kernel (ops/drain_kernel.py):

  * windows inside the compact caps travel as two i64 words per lane and
    come back as one response word plus the stored limit (drain_compact);
  * windows outside them take the full int64 columns (window_full), and an
    out-of-range limit or duration switches compact dispatch off for the
    engine's life, exactly like the JAX engine's `_compact_sound` latch, so
    both engines choose the same path for the same stream;
  * `pipeline_dispatch` runs K pre-packed windows in one launch.

The arena is int64 tensors [S=1, C] (algo int32) on the engine's device.
GLOBAL behavior is not served by this slice: GLOBAL requests raise, as the
JAX engine does when configured skip_global=True.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.api.types import (
    Behavior,
    RateLimitReq,
    RateLimitResp,
    millisecond_now,
)
from gubernator_tpu_torch.ops import drain_kernel, kernel
from gubernator_tpu_torch.ops.kernel import BucketState, WindowBatch, WindowOutput
from gubernator_tpu_torch.state.arena import SlotTable


# planes of the arena, in BucketState order
ARENA_FIELDS = BucketState._fields


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "torch versions of the kernels")
    return dev


class _PackedWindow:
    """Host-side staging buffers for one window (numpy, reused per step)."""

    def __init__(self, S: int, B: int):
        self.slot = np.full((S, B), kernel.PAD_SLOT, dtype=np.int32)
        self.hits = np.zeros((S, B), dtype=np.int64)
        self.limit = np.zeros((S, B), dtype=np.int64)
        self.duration = np.zeros((S, B), dtype=np.int64)
        self.algo = np.zeros((S, B), dtype=np.int32)
        self.is_init = np.zeros((S, B), dtype=bool)

    def reset(self):
        self.slot.fill(kernel.PAD_SLOT)


class RateLimitEngine:
    """Dense rate-limit state on one device + one kernel launch per window.

    capacity_per_shard: slots in the arena.
    batch_per_shard: max request lanes per window.
    replay_cap: max lanes of a non-uniform duplicate-key run per window
        (0 disables).  The kernel walks a slot's run serially and has no
        replay rounds to bound; the cap only mirrors the JAX engine's
        window cuts, so the differential tests see the same windows.  It
        can go once parity no longer depends on it.
    device: where the arena lives and the kernel runs (default `cuda`).
    """

    num_shards = 1
    num_local_shards = 1

    def __init__(
        self,
        capacity_per_shard: int = 65536,
        batch_per_shard: int = 1024,
        replay_cap: Optional[int] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.capacity_per_shard = capacity_per_shard
        self.batch_per_shard = batch_per_shard
        S, C = self.num_shards, capacity_per_shard
        z = lambda dt: torch.zeros((S, C), dtype=dt, device=self.device)  # noqa: E731
        self.state = BucketState(z(torch.int64), z(torch.int64),
                                 z(torch.int64), z(torch.int64),
                                 z(torch.int64), z(torch.int32))
        self.tables = [SlotTable(C) for _ in range(self.num_local_shards)]
        self._buf = _PackedWindow(self.num_local_shards, batch_per_shard)
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
        B = batch_per_shard
        self._lane_bucket_list = sorted(
            {b for b in (max(64, B // 16), max(64, B // 4)) if b < B} | {B})
        self.replay_cap = 128 if replay_cap is None else replay_cap

    # ------------------------------------------------------------ serving

    def _arena(self) -> BucketState:
        """The shard's arena planes as [C] views (what the kernel takes)."""
        return BucketState(*[p[0] for p in self.state])

    def step(self, requests: Sequence[RateLimitReq],
             now: Optional[int] = None) -> List[RateLimitResp]:
        """Process one window of requests synchronously.  The caller must
        respect the window cap (<= batch_per_shard lanes); `process`
        chunks automatically."""
        now = self._resolve_now(now)
        buf = self._buf
        buf.reset()
        # init-pending protocol (state/arena.py): fresh allocations keep
        # reporting is_init until the dispatch below commits this window
        for t in self.tables:
            t.begin_window()
        lanes, max_fill = self._stage_requests(buf, requests, now)
        out = self._dispatch(now, reg_fill=max_fill)
        for t in self.tables:
            t.commit_window()
        self.decisions_processed += len(requests)
        return [RateLimitResp(status=int(out.status[s, lane]),
                              limit=int(out.limit[s, lane]),
                              remaining=int(out.remaining[s, lane]),
                              reset_time=int(out.reset_time[s, lane]))
                for s, lane in lanes]

    def _stage_requests(self, buf, requests, now):
        """Stage one window's requests into `buf`.  Returns (lanes,
        max_fill) with lanes [(shard, lane)] per request for demux."""
        for r in requests:
            if r.behavior == Behavior.GLOBAL:
                raise ValueError(
                    "GLOBAL behavior is not served by this engine "
                    f"(key {r.hash_key()!r})")
        fill = 0
        lanes = []
        table = self.tables[0]
        for r in requests:
            slot, is_init = table.lookup(r.hash_key(), now, r.duration)
            buf.slot[0, fill] = slot
            buf.hits[0, fill] = r.hits
            buf.limit[0, fill] = r.limit
            buf.duration[0, fill] = r.duration
            buf.algo[0, fill] = r.algorithm
            buf.is_init[0, fill] = is_init
            lanes.append((0, fill))
            fill += 1
        return lanes, fill

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

    def _dispatch(self, now: int, reg_fill: Optional[int] = None) -> WindowOutput:
        """Run the staged window through the kernel; returns host copies of
        the responses as [S, lanes] numpy arrays.  Compact-eligible windows
        are sliced to the occupied-prefix bucket and travel as wire words;
        the rest take the full int64 columns at full width."""
        buf = self._buf
        compact = self._compact_eligible(buf)
        lanes = (self._lane_bucket(reg_fill)
                 if compact and reg_fill is not None
                 else self.batch_per_shard)
        if compact:
            packed = kernel.encode_batch_host(
                buf.slot[:, :lanes], buf.hits[:, :lanes],
                buf.limit[:, :lanes], buf.duration[:, :lanes],
                buf.algo[:, :lanes], buf.is_init[:, :lanes])
            words, limits, _ = drain_kernel.drain_compact(
                self._arena(), torch.from_numpy(packed).to(self.device),
                torch.tensor([now], dtype=torch.int64, device=self.device))
            self.windows_processed += 1
            wire = torch.stack([words, limits], dim=-1).cpu().numpy()
            return kernel.decode_output_host(wire, now)
        batch = WindowBatch(*[
            torch.from_numpy(a[0, :lanes].copy()).to(self.device)
            for a in (buf.slot, buf.hits, buf.limit, buf.duration, buf.algo,
                      buf.is_init)])
        out = drain_kernel.window_full(self._arena(), batch, now)
        self.windows_processed += 1
        return WindowOutput(*[f.cpu().numpy()[None] for f in out])

    def pipeline_dispatch(self, packed, nows, n_windows: Optional[int] = None):
        """Dispatch a stacked compact drain WITHOUT fetching: K windows in
        one kernel launch.  packed: i64[K, S, B, 2] compact request stack
        (numpy or tensor); nows: i64[K] per-window timestamps.  Returns
        device tensors (words i64[K, S, B], limits i64[K, S, B],
        mism bool[K, S]).  The caller guarantees compact eligibility."""
        packed = torch.as_tensor(packed, dtype=torch.int64).to(self.device)
        nows = torch.as_tensor(nows, dtype=torch.int64).to(self.device)
        words, limits, mism = drain_kernel.drain_compact(
            self._arena(), packed[:, 0].contiguous(), nows)
        self.windows_processed += (int(packed.shape[0]) if n_windows is None
                                   else n_windows)
        return words[:, None], limits[:, None], mism[:, None]

    def warmup(self, now: Optional[int] = None) -> None:
        """Build the kernel and launch each serving shape once on an empty
        window: the full format at full width, every compact lane bucket,
        and a one-window stacked drain."""
        now = self._resolve_now(now)
        saved = self._compact_enabled
        self._compact_enabled = False
        self._buf.reset()
        self._dispatch(now)
        self._compact_enabled = saved
        if saved:
            for lanes in self._lane_bucket_list:
                self._buf.reset()
                self._dispatch(now, reg_fill=lanes)
        packed = np.zeros((1, self.num_shards, self.batch_per_shard, 2),
                          np.int64)
        _, _, mism = self.pipeline_dispatch(packed, np.full(1, now, np.int64),
                                            n_windows=0)
        mism.cpu()

    def process(self, requests: Sequence[RateLimitReq],
                now: Optional[int] = None) -> List[RateLimitResp]:
        """step() with automatic chunking when a window overflows the caps."""
        out: List[RateLimitResp] = []
        pos = 0
        while pos < len(requests):
            n = self.max_window_prefix(requests[pos:])
            out.extend(self.step(requests[pos:pos + n], now))
            pos += n
        return out

    def routing_error(self, r: RateLimitReq) -> Optional[str]:
        """Why this request cannot be served by THIS engine, or None."""
        if r.behavior == Behavior.GLOBAL:
            return ("GLOBAL behavior is not served by this engine "
                    f"(key {r.hash_key()!r})")
        return None

    def max_window_prefix(self, requests: Sequence[RateLimitReq]) -> int:
        """How many leading requests fit in ONE step() window (>= 1 when any
        are given): the lane cap, and the replay-bound guard that cuts a
        NON-uniform duplicate-key run longer than replay_cap lanes."""
        fill = 0
        cap = self.replay_cap
        runs: dict = {}  # key -> [first (h,l,d,a), lanes, nonuniform]
        for i, r in enumerate(requests):
            if fill + 1 > self.batch_per_shard:
                return max(i, 1)
            if cap:
                key = r.hash_key()
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
            fill += 1
        return len(requests)

    # ------------------------------------------------------------ metrics

    @property
    def cache_size(self) -> int:
        return sum(len(t) for t in self.tables)

    @property
    def cache_hits(self) -> int:
        return sum(t.hits for t in self.tables)

    @property
    def cache_misses(self) -> int:
        return sum(t.misses for t in self.tables)

    def cache_stats(self, now: Optional[int] = None) -> dict:
        """Hit/miss counters plus free/live/expired slot occupancy (by the
        host expiry estimates) of the key tables."""
        now = int(now) if now is not None else millisecond_now()
        live = expired = free = 0
        for t in self.tables:
            st = t.stats(now)
            free += st["free"]
            live += st["live"]
            expired += st["expired"]
        return {
            "size": self.cache_size,
            "capacity": self.num_local_shards * self.capacity_per_shard,
            "hits": self.cache_hits,
            "misses": self.cache_misses,
            "free": free,
            "live": live,
            "expired": expired,
        }

    # ------------------------------------------------------- state transfer

    def import_arena(self, planes: Dict[str, np.ndarray]) -> None:
        """Overwrite the arena with [S, C] planes named as BucketState's
        fields (int64; algo int32) - the JAX engine's
        `np.asarray(eng.state.<field>)`."""
        for name, dst in zip(ARENA_FIELDS, self.state):
            src = np.asarray(planes[name])
            if src.shape != tuple(dst.shape):
                raise ValueError(f"plane {name}: want {tuple(dst.shape)}, "
                                 f"got {src.shape}")
            dt = np.int32 if name == "algo" else np.int64
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src, dtype=dt)))

    def export_arena(self) -> Dict[str, np.ndarray]:
        """The arena as host [S, C] planes keyed by BucketState field."""
        return {name: t.cpu().numpy().copy()
                for name, t in zip(ARENA_FIELDS, self.state)}
