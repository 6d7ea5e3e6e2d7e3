"""Native host router: ctypes bindings for the C++ window router.

`host_router.cc` (plain C++17, no device code) resolves a whole window of
keys to (shard, slot) in one call: crc32 shard routing, a per-shard
open-addressing table of 64-bit key fingerprints with LRU eviction and a
lazy expiry heap, and the packing of each request into the compact wire
words of a K-window stack (ops/kernel.py), folding uniform hits=1 runs of
one key into one aggregated lane (AGG_SLOT_BIT).

The library is compiled at first use with `g++ -O2 -shared -fPIC
-std=c++17` into the package's gitignored `build/` directory
(`build/libhost_router.so`), never beside the source; the compile writes a
file named after the process and renames it into place, so processes that
race to build it each see a whole library.  It is rebuilt when the source
is newer.  Without a toolchain `available()` is False and the build's error
is kept in `build_error()`; the engine then uses its Python slot tables,
or raises when the router was asked for (`use_native="on"`).

The front door's worker processes (frontdoor.py) call two of its functions
that hold no router state, `frontdoor_parse_req` and
`frontdoor_encode_resp`.  A worker calls `prebuilt_only()` first: it then
loads the library the engine process built before spawning it and never
runs g++ itself, so no two workers race a build into the same output.

The router's own clocks: `fastpath_parse_stack`, `fastpath_encode_w` and
`fastpath_encode_parts` read CLOCK_MONOTONIC at entry and exit and hand
back the nanoseconds of their C work through an out-slot; the binding
reads `time.monotonic_ns()` around its own call.  A caller that passes
a `RouterClock` (`clock=`) has both summed into it; without one nothing
is read (a null out-slot).  The binding's wall minus the C time is the
ctypes marshalling plus the wait to take the interpreter lock back, which
the C parse and encode run without.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("gubernator.native")

SOURCE = Path(__file__).resolve().parent / "host_router.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
LIBRARY = BUILD_DIR / "libhost_router.so"

_lib = None
_lib_lock = threading.Lock()
_error: Optional[str] = None
# False in a front-door worker: load what the engine built, never build
_build_allowed = True


def prebuilt_only() -> None:
    """Never build in this process: load the library as it stands (a
    missing or stale one makes available() False)."""
    global _build_allowed
    _build_allowed = False


def _build() -> None:
    """Compile the router into build/, atomically (a per-process temp name
    renamed over the library).  Raises RuntimeError with g++'s output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp),
           str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++: {e}") from None
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}) building "
                           f"{SOURCE.name}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, LIBRARY)


def _stale() -> bool:
    return (not LIBRARY.exists()
            or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime)


def _bind(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.router_new_mesh.restype = ctypes.c_void_p
    lib.router_new_mesh.argtypes = [ctypes.c_int32] * 4
    lib.router_free.argtypes = [ctypes.c_void_p]
    for fn in ("router_pack", "router_pack_window"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, u8p, i64p, ctypes.c_int64,
            i64p, i64p, i64p, i32p, ctypes.c_int64, ctypes.c_int32,
            i32p, i64p, i64p, i64p, i32p, u8p, i32p, i32p, i32p,
        ]
    for fn in ("router_size", "router_hits", "router_misses"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.router_heap_size.restype = ctypes.c_int64
    lib.router_heap_size.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for fn in ("router_commit", "router_drain_begin", "router_abort",
               "router_set_exact"):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.router_set_replay_cap.restype = None
    lib.router_set_replay_cap.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.fastpath_parse_stack.restype = ctypes.c_int64
    lib.fastpath_parse_stack.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        i64p, i32p, i32p, i32p, i32p, i32p, i64p, i64p, i32p, i64p,
    ]
    lib.fastpath_encode_parts.restype = ctypes.c_int64
    lib.fastpath_encode_parts.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        i32p, i32p, i32p, i64p, u8p, ctypes.c_int64, i64p, i32p, i64p,
    ]
    lib.router_set_ring.restype = None
    lib.router_set_ring.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), i32p,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.router_pack_stack.restype = ctypes.c_int64
    lib.router_pack_stack.argtypes = [
        ctypes.c_void_p, u8p, i64p, ctypes.c_int64,
        i64p, i64p, i64p, i32p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, i64p, i32p, i32p, i32p, i32p, i32p,
    ]
    lib.fastpath_encode_w.restype = ctypes.c_int64
    lib.fastpath_encode_w.argtypes = [
        i64p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        i32p, i32p, i32p, i64p, u8p, ctypes.c_int64, i64p,
    ]
    lib.router_export_keys.restype = ctypes.c_int64
    lib.router_export_keys.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, u64p, i32p, i64p,
    ]
    lib.router_import_keys.restype = ctypes.c_int64
    lib.router_import_keys.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, u64p, i32p, i64p, ctypes.c_int64,
    ]
    lib.router_occupancy.restype = None
    lib.router_occupancy.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, i64p, i64p, i64p,
    ]
    lib.frontdoor_parse_req.restype = ctypes.c_int64
    lib.frontdoor_parse_req.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u8p, i64p, i64p, i64p, i64p, i32p, i32p,
    ]
    lib.frontdoor_encode_resp.restype = ctypes.c_int64
    lib.frontdoor_encode_resp.argtypes = [
        i64p, i64p, i64p, i64p, i32p, ctypes.c_int64, u8p, ctypes.c_int64,
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lib_lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            if _stale():
                if not _build_allowed:
                    raise RuntimeError(
                        f"{LIBRARY} is missing or older than its source, "
                        "and this process does not build it")
                _build()
            lib = ctypes.CDLL(str(LIBRARY))
            _bind(lib)
        except Exception as e:
            _error = str(e)
            log.warning("native router unavailable (%s); using the Python "
                        "slot tables", _error)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """Does the router library build and load here?"""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library did not build or load (g++'s output), or None."""
    _load()
    return _error


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def frontdoor_parse_req(data: bytes, key_bytes: np.ndarray,
                        key_ends: np.ndarray, hits: np.ndarray,
                        limits: np.ndarray, durations: np.ndarray,
                        algos: np.ndarray, name_lens: np.ndarray,
                        max_items: int) -> int:
    """Stateless worker-side parse: serialized GetRateLimitsReq -> request
    columns in caller-owned buffers (a front-door worker writes straight
    into its shared-memory slab, core/shm_ring.py).  It applies the
    acceptance rules of the router's fastpath_parse_stack.  Returns n >= 0
    (requests parsed) or a negative fallback code (the worker then ships
    the raw bytes); -1 also when the library is unavailable."""
    lib = _load()
    if lib is None:
        return -1
    buf = ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))
    return lib.frontdoor_parse_req(
        buf, len(data), max_items, key_bytes.nbytes,
        _ptr(key_bytes, ctypes.c_uint8), _ptr(key_ends, ctypes.c_int64),
        _ptr(hits, ctypes.c_int64), _ptr(limits, ctypes.c_int64),
        _ptr(durations, ctypes.c_int64), _ptr(algos, ctypes.c_int32),
        _ptr(name_lens, ctypes.c_int32))


def frontdoor_encode_resp(status: np.ndarray, limit: np.ndarray,
                          remaining: np.ndarray, reset: np.ndarray,
                          flags, n: int, out: np.ndarray) -> int:
    """Stateless worker-side encode: decision columns (from the
    completion-ring slab) -> serialized GetRateLimitsResp bytes in `out`.
    flags is an int32 column (0 = plain decision, 1..5 = a shed reason,
    shm_ring.SHED_REASON_CODES) or None.  Returns the byte length, or -1
    (out too small, or no library) / -2 (unknown shed code): the caller
    then encodes with protobuf."""
    lib = _load()
    if lib is None:
        return -1
    fl = _ptr(flags, ctypes.c_int32) if flags is not None else None
    return lib.frontdoor_encode_resp(
        _ptr(status, ctypes.c_int64), _ptr(limit, ctypes.c_int64),
        _ptr(remaining, ctypes.c_int64), _ptr(reset, ctypes.c_int64),
        fl, n, _ptr(out, ctypes.c_uint8), out.nbytes)


class RouterClock:
    """A caller's sums of the router's timed calls, in nanoseconds: the C
    parse's and the C encodes' own clocks (`*_c`) and the binding's wall
    around each call (`*_wall`).  The caller passes it to the calls it
    wants timed (`clock=`; one thread at a time); `ptr` points at the
    out-slot those calls pass to C."""

    __slots__ = ("slot", "ptr", "parse_c", "parse_wall", "encode_c",
                 "encode_wall")

    def __init__(self):
        self.slot = ctypes.c_int64(0)
        self.ptr = ctypes.pointer(self.slot)
        self.parse_c = self.parse_wall = 0
        self.encode_c = self.encode_wall = 0


class NativeRouter:
    """Batch key -> (shard, slot) resolution + window packing in one C call."""

    def __init__(self, num_shards: int, capacity_per_shard: int,
                 num_global_shards: Optional[int] = None,
                 shard_offset: int = 0):
        """num_shards: the shards this router stages.  Keys hash over
        num_global_shards (default num_shards); a key whose shard falls
        outside [shard_offset, shard_offset + num_shards) comes back with
        out_shard == -1."""
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native router library unavailable: {_error}")
        self._lib = lib
        if num_global_shards is None:
            num_global_shards = num_shards
        self._handle = lib.router_new_mesh(
            num_global_shards, shard_offset, num_shards, capacity_per_shard)
        self.num_shards = num_shards
        self.capacity_per_shard = capacity_per_shard
        self.exact = False

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.router_free(handle)
            self._handle = None

    def pack(
        self,
        key_bytes: np.ndarray,   # uint8 concatenated keys
        key_ends: np.ndarray,    # int64 exclusive end offsets
        hits: np.ndarray, limits: np.ndarray, durations: np.ndarray,
        algos: np.ndarray, now: int, lanes: int,
        out_slot: np.ndarray, out_hits: np.ndarray, out_limit: np.ndarray,
        out_duration: np.ndarray, out_algo: np.ndarray,
        out_is_init: np.ndarray,
        out_shard: np.ndarray, out_lane: np.ndarray,
        shard_fill: np.ndarray,
    ) -> int:
        """Stage n requests into one window's full-format [S, lanes]
        columns.  Returns how many were packed (< n on lane overflow; ship
        the window and repack the remainder)."""
        return self._pack_impl(self._lib.router_pack, key_bytes, key_ends,
                               hits, limits, durations, algos, now, lanes,
                               out_slot, out_hits, out_limit, out_duration,
                               out_algo, out_is_init, out_shard, out_lane,
                               shard_fill)

    def pack_window(self, *args) -> int:
        """router_pack under an open drain (shared pack sequence,
        accumulating commits): one caller-delimited window of a stacked
        dispatch.  Same arguments and return as pack()."""
        return self._pack_impl(self._lib.router_pack_window, *args)

    def _pack_impl(self, fn, key_bytes, key_ends, hits, limits, durations,
                   algos, now, lanes, out_slot, out_hits, out_limit,
                   out_duration, out_algo, out_is_init, out_shard, out_lane,
                   shard_fill) -> int:
        return fn(
            self._handle,
            _ptr(key_bytes, ctypes.c_uint8), _ptr(key_ends, ctypes.c_int64),
            len(key_ends),
            _ptr(hits, ctypes.c_int64), _ptr(limits, ctypes.c_int64),
            _ptr(durations, ctypes.c_int64), _ptr(algos, ctypes.c_int32),
            now, lanes,
            _ptr(out_slot, ctypes.c_int32), _ptr(out_hits, ctypes.c_int64),
            _ptr(out_limit, ctypes.c_int64),
            _ptr(out_duration, ctypes.c_int64),
            _ptr(out_algo, ctypes.c_int32), _ptr(out_is_init, ctypes.c_uint8),
            _ptr(out_shard, ctypes.c_int32), _ptr(out_lane, ctypes.c_int32),
            _ptr(shard_fill, ctypes.c_int32),
        )

    def commit(self) -> None:
        """Confirm the window(s) staged since the last drain_begin / pack
        were dispatched (clears their entries' init-pending flags)."""
        self._lib.router_commit(self._handle)

    def drain_begin(self) -> None:
        """Open a drain: one pack sequence shared by the following
        parse_stack/pack_stack calls, committed or aborted as a unit."""
        self._lib.router_drain_begin(self._handle)

    def abort(self) -> None:
        """The drain's dispatch failed: keep its fresh allocations pending
        so their next touch re-initializes the (never-written) slots."""
        self._lib.router_abort(self._handle)

    def set_exact_keys(self) -> None:
        """Opt-in exact-key collision guard (stores full keys; a 64-bit
        fingerprint collision then probes onward instead of merging two
        keys' counters).  Call before any key is inserted."""
        self._lib.router_set_exact(self._handle)
        self.exact = True

    def set_replay_cap(self, cap: int) -> None:
        """Bound on a NON-uniform duplicate-key run per device window:
        when one key accumulates `cap` mixed-config or zero-hit lanes in a
        window, its next lane opens a fresh window of the stack.  Uniform
        hot-key duplicates are unaffected (closed form).  0 disables."""
        self._lib.router_set_replay_cap(self._handle, int(cap))

    def fastpath_parse_stack(self, data: bytes, now: int, lanes: int,
                             K: int, max_items: int, packed: np.ndarray,
                             kcur: np.ndarray, shard_fill: np.ndarray,
                             out_row: np.ndarray, out_lane: np.ndarray,
                             out_pos: np.ndarray,
                             out_limit: np.ndarray, out_off: np.ndarray,
                             out_mlen: np.ndarray,
                             use_ring: bool = True,
                             clock: Optional[RouterClock] = None) -> int:
        """Serialized GetRateLimitsReq -> lanes staged across a K-window
        compact stack.  Returns n >= 0 (requests parsed; ring-remote items
        are NOT staged and come back as out_row < -1 markers with their
        message byte ranges in out_off/out_mlen) or a negative fallback
        code; see host_router.cc.  use_ring=False treats every item as
        local."""
        t0 = time.monotonic_ns() if clock is not None else 0
        buf = ctypes.cast(ctypes.c_char_p(data),
                          ctypes.POINTER(ctypes.c_uint8))
        n = self._lib.fastpath_parse_stack(
            self._handle, buf, len(data), now, lanes, K, max_items,
            1 if use_ring else 0,
            _ptr(packed, ctypes.c_int64), _ptr(kcur, ctypes.c_int32),
            _ptr(shard_fill, ctypes.c_int32),
            _ptr(out_row, ctypes.c_int32), _ptr(out_lane, ctypes.c_int32),
            _ptr(out_pos, ctypes.c_int32),
            _ptr(out_limit, ctypes.c_int64), _ptr(out_off, ctypes.c_int64),
            _ptr(out_mlen, ctypes.c_int32),
            None if clock is None else clock.ptr,
        )
        if clock is not None:
            clock.parse_wall += time.monotonic_ns() - t0
            clock.parse_c += clock.slot.value
        return n

    def parse_stack_fast(self, data: bytes, now: int, lanes: int,
                         K: int, max_items: int, arena, scr,
                         use_ring: bool = True,
                         clock: Optional[RouterClock] = None) -> int:
        """fastpath_parse_stack against a WindowArena + JobScratch
        (core/window_buffers.py), whose pointers were derived once."""
        t0 = time.monotonic_ns() if clock is not None else 0
        buf = ctypes.cast(ctypes.c_char_p(data),
                          ctypes.POINTER(ctypes.c_uint8))
        n = self._lib.fastpath_parse_stack(
            self._handle, buf, len(data), now, lanes, K, max_items,
            1 if use_ring else 0,
            arena.p_packed, arena.p_kcur, arena.p_fills,
            scr.p_row, scr.p_lane, scr.p_pos,
            scr.p_limit, scr.p_off, scr.p_mlen,
            None if clock is None else clock.ptr,
        )
        if clock is not None:
            clock.parse_wall += time.monotonic_ns() - t0
            clock.parse_c += clock.slot.value
        return n

    def pack_stack_fast(self, key_bytes: np.ndarray, key_ends: np.ndarray,
                        hits: np.ndarray, limits: np.ndarray,
                        durations: np.ndarray, algos: np.ndarray, now: int,
                        lanes: int, K: int, arena, scr) -> int:
        """router_pack_stack against a WindowArena + JobScratch (cached
        stack and demux pointers; the request columns derive theirs per
        call)."""
        return self._lib.router_pack_stack(
            self._handle,
            _ptr(key_bytes, ctypes.c_uint8), _ptr(key_ends, ctypes.c_int64),
            len(key_ends),
            _ptr(hits, ctypes.c_int64), _ptr(limits, ctypes.c_int64),
            _ptr(durations, ctypes.c_int64), _ptr(algos, ctypes.c_int32),
            now, lanes, K,
            arena.p_packed, arena.p_kcur, arena.p_fills,
            scr.p_row, scr.p_lane, scr.p_pos,
        )

    def fastpath_encode_parts(self, w0: np.ndarray, item_limit: np.ndarray,
                              now: int, lanes: int, n: int,
                              out_row: np.ndarray, out_lane: np.ndarray,
                              out_pos: np.ndarray,
                              resp_buf: np.ndarray, item_off: np.ndarray,
                              item_len: np.ndarray,
                              climit: Optional[np.ndarray] = None,
                              clock: Optional[RouterClock] = None) -> int:
        """Per-item framed response segments for splicing with forwarded
        peers' bytes (mixed-ownership RPCs); see host_router.cc."""
        t0 = time.monotonic_ns() if clock is not None else 0
        cl = _ptr(climit, ctypes.c_int64) if climit is not None else None
        m = self._lib.fastpath_encode_parts(
            _ptr(w0, ctypes.c_int64), _ptr(item_limit, ctypes.c_int64),
            now, lanes, n,
            _ptr(out_row, ctypes.c_int32), _ptr(out_lane, ctypes.c_int32),
            _ptr(out_pos, ctypes.c_int32),
            cl, _ptr(resp_buf, ctypes.c_uint8), resp_buf.nbytes,
            _ptr(item_off, ctypes.c_int64), _ptr(item_len, ctypes.c_int32),
            None if clock is None else clock.ptr,
        )
        if clock is not None:
            clock.encode_wall += time.monotonic_ns() - t0
            clock.encode_c += clock.slot.value
        if m < 0:
            raise RuntimeError("fastpath_encode_parts: buffer too small")
        return m

    def set_ring(self, points: np.ndarray, peer_of: np.ndarray,
                 self_idx: int) -> None:
        """Install (or clear, with empty points) the cluster
        consistent-hash ring the RPC parser classifies items with."""
        n = len(points)
        self._lib.router_set_ring(
            self._handle,
            points.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            _ptr(peer_of, ctypes.c_int32), n, self_idx,
        )

    def pack_stack(self, key_bytes: np.ndarray, key_ends: np.ndarray,
                   hits: np.ndarray, limits: np.ndarray,
                   durations: np.ndarray, algos: np.ndarray, now: int,
                   lanes: int, K: int, packed: np.ndarray,
                   kcur: np.ndarray, shard_fill: np.ndarray,
                   out_row: np.ndarray, out_lane: np.ndarray,
                   out_pos: np.ndarray) -> int:
        """Columnar request list -> lanes staged across the K-window stack
        packed i64[K, S, B, 2] under an open drain.  Returns n, or a
        negative code: -2 a request outside the compact ranges, -3 more
        than the stack's item cap, -5 a key of another process's shard,
        -6 the stack is full (nothing was staged)."""
        return self._lib.router_pack_stack(
            self._handle,
            _ptr(key_bytes, ctypes.c_uint8), _ptr(key_ends, ctypes.c_int64),
            len(key_ends),
            _ptr(hits, ctypes.c_int64), _ptr(limits, ctypes.c_int64),
            _ptr(durations, ctypes.c_int64), _ptr(algos, ctypes.c_int32),
            now, lanes, K,
            _ptr(packed, ctypes.c_int64), _ptr(kcur, ctypes.c_int32),
            _ptr(shard_fill, ctypes.c_int32),
            _ptr(out_row, ctypes.c_int32), _ptr(out_lane, ctypes.c_int32),
            _ptr(out_pos, ctypes.c_int32),
        )

    def fastpath_encode_w(self, w0: np.ndarray, item_limit: np.ndarray,
                          now: int, lanes: int, n: int,
                          out_row: np.ndarray, out_lane: np.ndarray,
                          out_pos: np.ndarray, resp_buf: np.ndarray,
                          climit: Optional[np.ndarray] = None,
                          clock: Optional[RouterClock] = None) -> int:
        """Fetched response-word plane -> serialized GetRateLimitsResp bytes
        (returns the length written into resp_buf).  climit: the device's
        limit plane, passed only when a stored-limit mismatch was flagged.
        out_pos: per-item synthesis info (aggregated runs), -1 = plain."""
        t0 = time.monotonic_ns() if clock is not None else 0
        cl = _ptr(climit, ctypes.c_int64) if climit is not None else None
        m = self._lib.fastpath_encode_w(
            _ptr(w0, ctypes.c_int64), _ptr(item_limit, ctypes.c_int64),
            now, lanes, n,
            _ptr(out_row, ctypes.c_int32), _ptr(out_lane, ctypes.c_int32),
            _ptr(out_pos, ctypes.c_int32),
            cl, _ptr(resp_buf, ctypes.c_uint8), resp_buf.nbytes,
            None if clock is None else clock.ptr,
        )
        if clock is not None:
            clock.encode_wall += time.monotonic_ns() - t0
            clock.encode_c += clock.slot.value
        if m < 0:
            raise RuntimeError("fastpath_encode_w: response buffer too small")
        return m

    def export_keys(self, shard: int):
        """One shard's resident committed entries, oldest first:
        (fp uint64[n], slot int32[n], expire int64[n]); entry index ==
        device slot."""
        cap = self.capacity_per_shard
        fp = np.empty(cap, np.uint64)
        slot = np.empty(cap, np.int32)
        expire = np.empty(cap, np.int64)
        n = self._lib.router_export_keys(
            self._handle, shard, _ptr(fp, ctypes.c_uint64),
            _ptr(slot, ctypes.c_int32), _ptr(expire, ctypes.c_int64))
        return fp[:n].copy(), slot[:n].copy(), expire[:n].copy()

    def import_keys(self, shard: int, fp: np.ndarray, slot: np.ndarray,
                    expire: np.ndarray) -> None:
        """Rebuild one shard from export_keys output (oldest first).
        Raises on invalid slots or when the exact-key guard is active
        (exports carry no key bytes)."""
        fp = np.ascontiguousarray(fp, np.uint64)
        slot = np.ascontiguousarray(slot, np.int32)
        expire = np.ascontiguousarray(expire, np.int64)
        rc = self._lib.router_import_keys(
            self._handle, shard, _ptr(fp, ctypes.c_uint64),
            _ptr(slot, ctypes.c_int32), _ptr(expire, ctypes.c_int64),
            len(fp))
        if rc == -2:
            raise RuntimeError(
                "exact-keys native router cannot import a fingerprint-only "
                "snapshot")
        if rc != 0:
            raise ValueError("invalid or duplicate slot in key-map import")

    def occupancy(self, now: int):
        """(live, expired, free) slot counts over all shards, judged by
        the host expiry estimate (engine.cache_stats)."""
        live = np.zeros(1, np.int64)
        expired = np.zeros(1, np.int64)
        free_slots = np.zeros(1, np.int64)
        self._lib.router_occupancy(
            self._handle, now, _ptr(live, ctypes.c_int64),
            _ptr(expired, ctypes.c_int64), _ptr(free_slots, ctypes.c_int64))
        return int(live[0]), int(expired[0]), int(free_slots[0])

    def heap_size(self, shard: int = 0) -> int:
        """Expiry-heap nodes (live + draining) of one shard."""
        return self._lib.router_heap_size(self._handle, shard)

    @property
    def size(self) -> int:
        return self._lib.router_size(self._handle)

    @property
    def hits(self) -> int:
        return self._lib.router_hits(self._handle)

    @property
    def misses(self) -> int:
        return self._lib.router_misses(self._handle)
