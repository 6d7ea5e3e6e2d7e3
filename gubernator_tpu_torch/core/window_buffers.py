"""Preallocated drain staging arenas + columnar request accumulators.

The serving pipeline (core/pipeline.py) keeps up to `depth` drains in
flight.  Each drain stages its K-window compact stack on the host, and the
copy that carries it to the device may still be reading that memory after
the dispatch returns; the drain's responses come back into host memory the
same way.  This module holds that staging in a ring of reusable arenas
(the JAX package's core/window_buffers.py):

  * `WindowArena`: one drain's packed stack i64[K, S, B, 2], its per-(k,
    shard) fills and per-shard window cursors (the C router's outputs),
    the windows' timestamps, the host buffers the drain's response words
    and mismatch flags are fetched into, and a pool of per-job demux
    scratch blocks, with ctypes pointers derived once.  On a CUDA engine
    every buffer the device reads or writes is pinned host memory
    (`torch.empty(..., pin_memory=True)`, used through `.numpy()` views so
    the pointers stay fixed), so the copies are truly asynchronous; on a
    CPU engine they are plain host tensors.  Recycling zeroes only the
    lanes the previous drain occupied.
  * `WindowArenaRing`: the free list.  An arena is acquired on the engine
    thread at drain start and released only on CLEAN completion: the
    drain's fetch waited for an event recorded after its response copies,
    which come after the drain's kernel, which comes after the copy that
    read the stack, all on one stream; so the device is done with every
    buffer of the arena.  Error paths drop the arena instead (the caching
    host allocator keeps a pinned block that a queued copy still uses out
    of reuse until that copy has run).
  * `RequestColumns`: columnar accumulation of single-request submits, so
    a drain takes window columns as array slices instead of walking
    request objects.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from gubernator_tpu_torch.config import MAX_BATCH_SIZE


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class JobScratch:
    """One job's demux staging (row/lane/pos per item, plus the raw-RPC
    lane's limit/offset/length planes), sized to the 1000-item RPC cap
    with ctypes pointers cached at allocation.  A block is valid for
    exactly one drain."""

    __slots__ = ("row", "lane", "pos", "limit", "off", "mlen",
                 "p_row", "p_lane", "p_pos", "p_limit", "p_off", "p_mlen")

    def __init__(self):
        self.row = np.empty(MAX_BATCH_SIZE, np.int32)
        self.lane = np.empty(MAX_BATCH_SIZE, np.int32)
        self.pos = np.empty(MAX_BATCH_SIZE, np.int32)
        self.limit = np.empty(MAX_BATCH_SIZE, np.int64)
        self.off = np.empty(MAX_BATCH_SIZE, np.int64)
        self.mlen = np.empty(MAX_BATCH_SIZE, np.int32)
        self.p_row = _ptr(self.row, ctypes.c_int32)
        self.p_lane = _ptr(self.lane, ctypes.c_int32)
        self.p_pos = _ptr(self.pos, ctypes.c_int32)
        self.p_limit = _ptr(self.limit, ctypes.c_int64)
        self.p_off = _ptr(self.off, ctypes.c_int64)
        self.p_mlen = _ptr(self.mlen, ctypes.c_int32)


class WindowArena:
    """One drain's staging: the K-window packed stack, per-(k, shard)
    fills, per-shard window cursors, the windows' timestamps, the fetch
    buffers and a scratch-block pool.  `packed_t`, `nows_t`, `words_t`
    and `mism_t` are the host tensors (pinned when `pinned`); `packed`,
    `fills` and `kcur` are numpy views the C router writes through."""

    __slots__ = ("K", "S", "B", "pinned", "packed_t", "fills_t", "kcur_t",
                 "nows_t", "words_t", "mism_t", "packed", "fills", "kcur",
                 "p_packed", "p_fills", "p_kcur", "_extra",
                 "_scratch", "_scratch_idx", "scratch_allocs", "dirty")

    def __init__(self, K: int, S: int, B: int, pinned: bool = False):
        self.K = K
        self.S = S
        self.B = B
        self.pinned = pinned
        self.packed_t = self._zeros((K, S, B, 2), torch.int64)
        self.fills_t = self._zeros((K, S), torch.int32)
        self.kcur_t = self._zeros((S,), torch.int32)
        self.nows_t = self._zeros((K,), torch.int64)
        self.words_t = self._zeros((K, S, B), torch.int64)
        self.mism_t = self._zeros((K, S), torch.bool)
        self.packed = self.packed_t.numpy()
        self.fills = self.fills_t.numpy()
        self.kcur = self.kcur_t.numpy()
        self.p_packed = _ptr(self.packed, ctypes.c_int64)
        self.p_fills = _ptr(self.fills, ctypes.c_int32)
        self.p_kcur = _ptr(self.kcur, ctypes.c_int32)
        self._extra: Dict[str, torch.Tensor] = {}
        self._scratch: List[JobScratch] = []
        self._scratch_idx = 0
        self.scratch_allocs = 0
        # has this arena staged anything since its last recycle?
        self.dirty = False

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self.pinned)

    def host(self, name: str, shape, dtype) -> torch.Tensor:
        """A further host buffer of this arena (pinned when the arena is),
        made on first use and kept with the arena: the drain's tenant
        lanes, its stats.  Its contents are the caller's."""
        t = self._extra.get(name)
        if t is None or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            t = self._extra[name] = self._zeros(shape, dtype)
        return t

    def acquire_scratch(self) -> JobScratch:
        """Next scratch block for one job of the current drain (engine
        thread only)."""
        if self._scratch_idx < len(self._scratch):
            scr = self._scratch[self._scratch_idx]
        else:
            scr = JobScratch()
            self._scratch.append(scr)
            self.scratch_allocs += 1
        self._scratch_idx += 1
        return scr

    def recycle(self) -> None:
        """Make the arena ready for its next drain: zero exactly the lanes
        the previous drain occupied (per-(k, shard) fill prefixes) and
        reset the cursors and the scratch pool."""
        if self.dirty:
            fills = self.fills
            packed = self.packed
            for k, s in zip(*np.nonzero(fills)):
                packed[k, s, : fills[k, s]] = 0
            fills.fill(0)
            self.kcur.fill(0)
            self.dirty = False
        self._scratch_idx = 0


class WindowArenaRing:
    """Free list of WindowArenas keyed by stack shape.  Acquire happens on
    the engine thread, release on the event loop (drain completion), so
    the list sits behind a lock.  `pinned`: make pinned arenas (a CUDA
    engine's).  `metrics`: an observability Metrics whose
    guber_tpu_window_buffer_reuse_total{event=reuse|alloc} counts each
    acquire, or None."""

    def __init__(self, pinned: bool = False, max_free: int = 8,
                 metrics=None):
        self._free: List[WindowArena] = []
        self._lock = threading.Lock()
        self._max_free = max_free
        self.pinned = pinned
        self.metrics = metrics
        self.reuse_events = 0
        self.alloc_events = 0

    def acquire(self, K: int, S: int, B: int) -> WindowArena:
        arena = None
        with self._lock:
            for i, a in enumerate(self._free):
                if a.K >= K and a.S == S and a.B == B:
                    arena = self._free.pop(i)
                    break
        event = "reuse" if arena is not None else "alloc"
        if arena is not None:
            self.reuse_events += 1
        else:
            self.alloc_events += 1
            arena = WindowArena(K, S, B, pinned=self.pinned)
        if self.metrics is not None:
            self.metrics.window_buffer_reuse.labels(event=event).inc()
        return arena

    def release(self, arena: Optional[WindowArena]) -> None:
        """Return a CLEANLY completed drain's arena (its fetch event has
        passed, so the device is done with its buffers).  Error paths must
        NOT call this: dropping the arena keeps a buffer a queued copy may
        still use out of the pool."""
        if arena is None:
            return
        arena.recycle()
        with self._lock:
            if len(self._free) < self._max_free:
                self._free.append(arena)


class RequestColumns:
    """Columnar accumulator for single-request submits (the pipeline's
    singles lane and the batcher's classic pending window).

    `append` writes the request's numeric fields into preallocated numpy
    columns and stashes the encoded hash key, so draining N singles costs
    column slices, never a per-field walk over request objects."""

    __slots__ = ("hits", "limit", "duration", "algo", "keys", "klen", "n")

    def __init__(self, cap: int = 1024):
        self.hits = np.empty(cap, np.int64)
        self.limit = np.empty(cap, np.int64)
        self.duration = np.empty(cap, np.int64)
        self.algo = np.empty(cap, np.int32)
        self.klen = np.empty(cap, np.int64)
        self.keys: List[bytes] = []
        self.n = 0

    def _grow(self) -> None:
        cap = len(self.hits) * 2
        for name in ("hits", "limit", "duration", "algo", "klen"):
            old = getattr(self, name)
            arr = np.empty(cap, old.dtype)
            arr[: self.n] = old[: self.n]
            setattr(self, name, arr)

    def append(self, req) -> int:
        """Accumulate one request; returns its column index."""
        i = self.n
        if i == len(self.hits):
            self._grow()
        self.hits[i] = req.hits
        self.limit[i] = req.limit
        self.duration[i] = req.duration
        self.algo[i] = req.algorithm
        key = req.hash_key().encode("utf-8")
        self.keys.append(key)
        self.klen[i] = len(key)
        self.n = i + 1
        return i

    def extend_from(self, src: "RequestColumns", idx) -> int:
        """Append the requests src holds at the indices `idx`, in that
        order, in one gather per column; returns the first new index."""
        sel = np.asarray(idx, np.int64)
        first, m = self.n, len(sel)
        while self.n + m > len(self.hits):
            self._grow()
        for name in ("hits", "limit", "duration", "algo", "klen"):
            getattr(self, name)[first:first + m] = getattr(src, name)[sel]
        self.keys.extend(src.keys[i] for i in sel)
        self.n = first + m
        return first

    def reset(self) -> None:
        self.n = 0
        self.keys.clear()

    def take(self, start: int, stop: int, idx=None):
        """The native-router columns of the requests appended in [start,
        stop): (key_bytes, key_ends, hits, limit, duration, algo), the
        numeric columns as zero-copy slices.  With `idx` (a drain's
        tenant-fair or budget-cut permutation) the chunk gathers the
        requests idx[start:stop] instead."""
        if idx is not None:
            sel = np.asarray(idx[start:stop], np.int64)
            ends = np.cumsum(self.klen[sel])
            return (np.frombuffer(b"".join([self.keys[i] for i in sel]),
                                  dtype=np.uint8), ends,
                    self.hits[sel], self.limit[sel],
                    self.duration[sel], self.algo[sel])
        keys = self.keys[start:stop]
        ends = np.cumsum(self.klen[start:stop])
        return (np.frombuffer(b"".join(keys), dtype=np.uint8), ends,
                self.hits[start:stop], self.limit[start:stop],
                self.duration[start:stop], self.algo[start:stop])
