"""Wrappers for the window-drain kernel (ops/csrc/window_drain.cu).

Three entry points share the kernel's per-window device code, all over an
arena of S shards (planes [S, C]; P x S CTAs, CTA (p, s) owning the rows
of shard s that hash to partition p, with P chosen for the card):

  * `drain_compact(arena, packed, nows)` - K windows of compact request
    words in one launch (the JAX package's window_drain_fused_planes and,
    at K=1, window_step_fused_planes).  Returns response words, stored
    limits and per-window, per-shard limit-mismatch flags.
  * `drain_compact_stats(arena, packed, nows, tenants, acc)` - the same
    drain, also adding every window's analytics sums into a
    StatsAccumulator (ops/stats_kernel.py): the TPU drain kernel's
    in-kernel stats fold (pallas_kernel.py:852).  A second entry point of
    the same source.
  * `window_full(arena, batch, now)` - one window of decoded int64 columns
    (the engine's full-format path for windows outside the compact caps).

All update the arena planes in place.  For CUDA tensors they launch the
kernel on the current stream (building it with nvcc on first use) or
raise; for CPU tensors they run the plain version, the int64 oracle of
ops/kernel.py, which chip_smoke.py and the tests hold the kernel against.
Pad lanes (slot < 0) answer 0 in every output field on both paths.

`launches` counts kernel launches and `plain_calls` counts plain-version
runs, per entry point, so a caller can prove which path served it.
`plan` says how a launch is laid out on the card (P, threads, shared
memory, workspace); `launch_compact`, `launch_compact_stats` and
`launch_full` are the uncounted launches behind the wrappers, at a P of the
caller's choosing, for checks that hold one P against another.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from gubernator_tpu_torch.ops import analytics, build, kernel
from gubernator_tpu_torch.ops.build import check_tensor
from gubernator_tpu_torch.ops.kernel import BucketState, WindowBatch, WindowOutput
from gubernator_tpu_torch.ops.stats_kernel import StatsAccumulator

SOURCE = "window_drain"

# lanes per window the kernel takes (window_drain.cu)
MAX_LANES = 16384
# dynamic shared memory the kernel lets a CTA take (window_drain.cu
# kSmemBudget): the staging double buffer of up to CHUNK_LANES 16 B lanes
# and, in the stats drain, three u64 tenant sums per tenant id must fit
MAX_SHARED_BYTES = 232448 - 4096
CHUNK_LANES = 1024
# guber_drain_plan's kinds
_KIND = {"drain_compact": 0, "drain_compact_stats": 1, "window_full": 2}

launches = {"drain_compact": 0, "drain_compact_stats": 0, "window_full": 0}
plain_calls = {"drain_compact": 0, "drain_compact_stats": 0,
               "window_full": 0}

_lock = threading.Lock()
_lib = None
_plans = {}


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


def load_library() -> ctypes.CDLL:
    """Build window_drain.cu for sm_90a (ops/build.py) and bind its C entry
    points with ctypes."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # each launch ends in (P, workspace, workspace bytes, stream)
        tail = [i, p, ll, p]
        lib.guber_drain_compact.argtypes = [p, p, i, i, i, p, p, p, p, p, p,
                                            ll, p, p, p] + tail
        lib.guber_drain_compact.restype = i
        lib.guber_drain_compact_stats.argtypes = (
            [p, p, i, i, i, p, p, p, p, p, p, ll, p, p, p, p, i, p, p, p, p,
             p, ll] + tail)
        lib.guber_drain_compact_stats.restype = i
        lib.guber_window_full.argtypes = [p, p, p, p, p, p, ll, i, i, p, p, p,
                                          p, p, p, ll, p, p, p, p] + tail
        lib.guber_window_full.restype = i
        lib.guber_drain_plan.argtypes = [i, i, i, i, i,
                                         ctypes.POINTER(ctypes.c_longlong)]
        lib.guber_drain_plan.restype = i
        lib.guber_error_string.argtypes = [i]
        lib.guber_error_string.restype = ctypes.c_char_p
        lib.guber_max_lanes.restype = i
        if lib.guber_max_lanes() != MAX_LANES:
            raise RuntimeError("window_drain.cu lane cap disagrees with "
                               "drain_kernel.MAX_LANES")
        _lib = lib
        return lib


def _check_arena(arena: BucketState, device) -> tuple:
    """(S, C) of an arena of S shards' [S, C] planes."""
    if arena.limit.dim() != 2:
        raise ValueError(f"arena.limit: want [S, C], got "
                         f"{tuple(arena.limit.shape)}")
    S, C = arena.limit.shape
    for name, t in zip(BucketState._fields, arena):
        dt = torch.int32 if name == "algo" else torch.int64
        check_tensor(t, f"arena.{name}", dt, (S, C), device)
    if S < 1 or C < 1:
        raise ValueError("arena has no slots")
    return S, C


def _check_lanes(B: int) -> None:
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"window of {B} lanes; the kernel takes 1..{MAX_LANES}")


def _ptrs(arena: BucketState):
    return [t.data_ptr() for t in arena]


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        msg = load_library().guber_error_string(rc).decode()
        raise RuntimeError(f"window_drain launch failed: {msg} ({rc})")


def _cuda_stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def plan(kind: str, B: int, S: int, T: int = 0, P: int = 0,
         device=None) -> dict:
    """The launch plan of entry point `kind` ("drain_compact",
    "drain_compact_stats" with T tenant rows, "window_full") for windows of
    B lanes over S shards on the current CUDA device: P (the partitions a
    shard's rows split into; with P = 0 the kernel's choice, about one wave
    of CTAs on the card), threads and dynamic shared memory per CTA, and
    the workspace bytes the launch needs (0 when its arrays fit in shared
    memory)."""
    dev = torch.device("cuda" if device is None else device)
    dev = torch.cuda.current_device() if dev.index is None else dev.index
    key = (kind, B, S, T, P, dev)
    got = _plans.get(key)
    if got is None:
        out = (ctypes.c_longlong * 4)()
        with torch.cuda.device(dev):
            _launch(load_library().guber_drain_plan, _KIND[kind], B, S, T, P,
                    out)
        got = _plans[key] = dict(P=out[0], threads=out[1], smem=out[2],
                                 workspace=out[3])
    return got


def _workspace(kind, B, S, T, P, dev):
    """(P asked for, workspace pointer, its bytes) for one launch."""
    nbytes = plan(kind, B, S, T, P, dev)["workspace"]
    if not nbytes:
        return P, None, 0, None
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    return P, ws.data_ptr(), nbytes, ws


def _aligned(packed: torch.Tensor) -> torch.Tensor:
    """packed, or a copy of it, on 16 B: the kernel stages 16 B lanes."""
    return packed if packed.data_ptr() % 16 == 0 else packed.clone()


def launch_compact(arena: BucketState, packed: torch.Tensor,
                   nows: torch.Tensor, P: int = 0):
    """guber_drain_compact on checked CUDA inputs at P partitions (0: the
    kernel's choice), uncounted: drain_compact launches through here, and
    a check may launch at another P (chip_smoke.py's P = 1)."""
    dev = packed.device
    K, S, B = packed.shape[:3]
    C = arena.limit.shape[1]
    lib = load_library()
    packed = _aligned(packed)
    words = torch.empty((K, S, B), dtype=torch.int64, device=dev)
    limits = torch.empty((K, S, B), dtype=torch.int64, device=dev)
    mism = torch.empty((K, S), dtype=torch.bool, device=dev)
    P, ws, nbytes, _keep = _workspace("drain_compact", B, S, 0, P, dev)
    _launch(lib.guber_drain_compact, packed.data_ptr(), nows.data_ptr(), K, S,
            B, *_ptrs(arena), C, words.data_ptr(), limits.data_ptr(),
            mism.data_ptr(), P, ws, nbytes, _cuda_stream(dev))
    return words, limits, mism


def launch_compact_stats(arena: BucketState, packed: torch.Tensor,
                         nows: torch.Tensor, tenants: torch.Tensor,
                         acc: StatsAccumulator, P: int = 0):
    """guber_drain_compact_stats on checked CUDA inputs at P partitions,
    uncounted (see launch_compact)."""
    dev = packed.device
    K, S, B = packed.shape[:3]
    C = arena.limit.shape[1]
    T = acc.shape[2]
    acc.reserve(K * B)
    lib = load_library()
    packed = _aligned(packed)
    words = torch.empty((K, S, B), dtype=torch.int64, device=dev)
    limits = torch.empty((K, S, B), dtype=torch.int64, device=dev)
    mism = torch.empty((K, S), dtype=torch.bool, device=dev)
    P, ws, nbytes, _keep = _workspace("drain_compact_stats", B, S, T, P, dev)
    _launch(lib.guber_drain_compact_stats, packed.data_ptr(), nows.data_ptr(),
            K, S, B, *_ptrs(arena), C, words.data_ptr(), limits.data_ptr(),
            mism.data_ptr(), tenants.data_ptr(), T, acc.index.data_ptr(),
            acc.entries.data_ptr(), acc.count.data_ptr(),
            acc.tenant.data_ptr(), acc.header.data_ptr(), acc.entry_capacity,
            P, ws, nbytes, _cuda_stream(dev))
    return words, limits, mism


def launch_full(arena: BucketState, batch: WindowBatch, now: int,
                P: int = 0) -> WindowOutput:
    """guber_window_full on checked CUDA inputs at P partitions, uncounted
    (see launch_compact)."""
    dev = batch.slot.device
    S, B = batch.slot.shape
    C = arena.limit.shape[1]
    lib = load_library()
    out = WindowOutput(
        status=torch.empty((S, B), dtype=torch.int32, device=dev),
        limit=torch.empty((S, B), dtype=torch.int64, device=dev),
        remaining=torch.empty((S, B), dtype=torch.int64, device=dev),
        reset_time=torch.empty((S, B), dtype=torch.int64, device=dev))
    P, ws, nbytes, _keep = _workspace("window_full", B, S, 0, P, dev)
    _launch(lib.guber_window_full, *[t.data_ptr() for t in batch], int(now),
            S, B, *_ptrs(arena), C, *[t.data_ptr() for t in out], P, ws,
            nbytes, _cuda_stream(dev))
    return out


def drain_compact(arena: BucketState, packed: torch.Tensor, nows: torch.Tensor):
    """Apply K compact windows, in order, to each shard of `arena` (updated
    in place; shard s takes lanes packed[:, s]).

    arena: [S, C] planes.  packed i64[K, S, B, 2] (kernel.encode_batch_host
    words), nows i64[K].  Returns (words i64[K, S, B], limits i64[K, S, B],
    mism bool[K, S]): words are kernel.encode_output_word of each lane's
    response, limits the responses' stored limits, mism whether any valid
    lane of that window and shard got a stored limit other than its
    request's."""
    dev = packed.device
    _check_drain(arena, packed, nows)
    if dev.type == "cpu":
        return drain_compact_plain(arena, packed, nows)
    if dev.type != "cuda":
        raise ValueError(f"drain_compact runs on cuda or cpu, not {dev}")
    out = launch_compact(arena, packed, nows)
    launches["drain_compact"] += 1
    return out


def drain_compact_plain(arena: BucketState, packed: torch.Tensor,
                        nows: torch.Tensor):
    """The plain version of drain_compact on any device: per shard and
    window, decode_batch -> window_step -> encode_output_word, pads
    zeroed."""
    plain_calls["drain_compact"] += 1
    return _drain_plain(arena, packed, nows)


def _drain_plain(arena: BucketState, packed: torch.Tensor,
                 nows: torch.Tensor):
    words, limits, mism = [], [], []
    for s in range(packed.shape[1]):
        st = BucketState(*[p[s] for p in arena])
        sw, sl, sm = [], [], []
        for k in range(packed.shape[0]):
            now = nows[k]
            bt = kernel.decode_batch(packed[k, s])
            st, out = kernel.window_step(st, bt, now)
            valid = bt.slot >= 0
            sw.append(torch.where(valid, kernel.encode_output_word(out, now),
                                  0))
            sl.append(torch.where(valid, out.limit, 0))
            sm.append(((out.limit != bt.limit) & valid).any())
        for dst, src in zip(arena, st):
            dst[s].copy_(src)
        words.append(torch.stack(sw))
        limits.append(torch.stack(sl))
        mism.append(torch.stack(sm))
    return (torch.stack(words, 1), torch.stack(limits, 1),
            torch.stack(mism, 1))


def _check_drain(arena: BucketState, packed: torch.Tensor,
                 nows: torch.Tensor) -> tuple:
    """(K, S, B, C) of a compact drain's inputs."""
    dev = packed.device
    if packed.dim() != 4:
        raise ValueError(f"packed: want [K, S, B, 2], got "
                         f"{tuple(packed.shape)}")
    K, S, B = packed.shape[0], packed.shape[1], packed.shape[2]
    if K < 1:
        raise ValueError("drain of zero windows")
    _check_lanes(B)
    check_tensor(packed, "packed", torch.int64, (K, S, B, 2), dev)
    check_tensor(nows, "nows", torch.int64, (K,), dev)
    S_arena, C = _check_arena(arena, dev)
    if S_arena != S:
        raise ValueError(f"packed has {S} shards, the arena {S_arena}")
    return K, S, B, C


def drain_compact_stats(arena: BucketState, packed: torch.Tensor,
                        nows: torch.Tensor, tenants: torch.Tensor,
                        acc: StatsAccumulator):
    """drain_compact, plus every window's analytics sums added into `acc`
    (ops/analytics.py semantics: rows clipped to C - 1, the raw 28-bit
    hits, the response's status bit, tenant ids clipped to [0, T - 1]).

    tenants i32[K, S, B]: each lane's tenant id.  Returns what
    drain_compact returns; ops/stats_kernel.py stats_finish turns `acc`
    into the stats vectors."""
    dev = packed.device
    K, S, B, C = _check_drain(arena, packed, nows)
    check_tensor(tenants, "tenants", torch.int32, (K, S, B), dev)
    S_acc, C_acc, T = acc.shape
    if (S_acc, C_acc) != (S, C) or acc.device != dev:
        raise ValueError(f"accumulator [{S_acc}, {C_acc}] on {acc.device}, "
                         f"arena [{S}, {C}] on {dev}")
    if C > 1 << 30:
        raise ValueError(f"the stats drain takes arenas of up to 2^30 rows "
                         f"per shard, not {C}")
    if 2 * min(B, CHUNK_LANES) * 16 + 3 * T * 8 > MAX_SHARED_BYTES:
        raise ValueError(f"{T} tenant rows beside {B} lanes exceed the "
                         f"kernel's shared memory")
    if dev.type == "cpu":
        return drain_compact_stats_plain(arena, packed, nows, tenants, acc)
    if dev.type != "cuda":
        raise ValueError(f"drain_compact_stats runs on cuda or cpu, not {dev}")
    out = launch_compact_stats(arena, packed, nows, tenants, acc)
    launches["drain_compact_stats"] += 1
    return out


def drain_compact_stats_plain(arena: BucketState, packed: torch.Tensor,
                              nows: torch.Tensor, tenants: torch.Tensor,
                              acc: StatsAccumulator):
    """The plain version of drain_compact_stats on any device:
    drain_compact_plain, then each shard's analytics.drain_stats added into
    `acc`."""
    plain_calls["drain_compact_stats"] += 1
    acc.reserve(packed.shape[0] * packed.shape[2])
    words, limits, mism = _drain_plain(arena, packed, nows)
    _, C, T = acc.shape
    for s in range(packed.shape[1]):
        acc.add(s, analytics.drain_stats(packed[:, s], words[:, s],
                                         tenants[:, s], C, T))
    return words, limits, mism


def window_full(arena: BucketState, batch: WindowBatch, now: int) -> WindowOutput:
    """Apply one window of decoded columns to each shard of `arena`
    (updated in place; shard s takes lanes batch.*[s]).

    arena: [S, C] planes.  batch: slot i32, hits/limit/duration i64, algo
    i32, is_init bool, all [S, B].  Returns the responses (status i32,
    limit/remaining/reset_time i64, [S, B]) in lane order."""
    dev = batch.slot.device
    if batch.slot.dim() != 2:
        raise ValueError(f"batch.slot: want [S, B], got "
                         f"{tuple(batch.slot.shape)}")
    S, B = batch.slot.shape
    _check_lanes(B)
    for name, t in zip(WindowBatch._fields, batch):
        dt = {"slot": torch.int32, "algo": torch.int32,
              "is_init": torch.bool}.get(name, torch.int64)
        check_tensor(t, f"batch.{name}", dt, (S, B), dev)
    S_arena, _ = _check_arena(arena, dev)
    if S_arena != S:
        raise ValueError(f"batch has {S} shards, the arena {S_arena}")
    if dev.type == "cpu":
        return window_full_plain(arena, batch, now)
    if dev.type != "cuda":
        raise ValueError(f"window_full runs on cuda or cpu, not {dev}")
    out = launch_full(arena, batch, now)
    launches["window_full"] += 1
    return out


def window_full_plain(arena: BucketState, batch: WindowBatch,
                      now: int) -> WindowOutput:
    """The plain version of window_full on any device: window_step per
    shard, pad lanes zeroed."""
    plain_calls["window_full"] += 1
    outs = []
    for s in range(batch.slot.shape[0]):
        st, out = kernel.window_step(BucketState(*[p[s] for p in arena]),
                                     WindowBatch(*[t[s] for t in batch]), now)
        for dst, src in zip(arena, st):
            dst[s].copy_(src)
        outs.append(out)
    valid = batch.slot >= 0
    return WindowOutput(*[torch.where(valid, torch.stack(f), 0)
                          for f in zip(*outs)])
