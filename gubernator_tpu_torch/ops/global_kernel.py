"""Wrappers for the GLOBAL window kernels (ops/csrc/global_window.cu and
ops/csrc/global_apply.cu) and the packed control block they read.

A GLOBAL window's control - its n = S x Bg lanes (slot, hits, limit,
duration, algo, is_init and the hits each contributes to its slot's sum,
`gacc`), its kg config-write and reset lanes (uslot, ulimit, uduration,
ualgo, rslot) and its ku upsert lanes (pslot, plimit, pduration,
premaining, ptstamp, pexpire, palgo: an owner's broadcast written into
this replica, JAX engine.py:2617 _apply_control) - crosses to the device
as one int64 block, laid out by `pack_control` (the one place that knows
the layout; csrc/global_phases.cuh reads it).  The arena (`gstate`, [G] planes) and its
config (`gcfg`) are updated in place, and the per-slot sums live in a
scratch i64[G] that the caller owns and keeps all zero between windows.

  * `global_window(gstate, gcfg, control, scratch, now)` - one GLOBAL
    window (the JAX engine's _apply_control and _global_window, with
    global_combined_staged): upserts, then config writes and resets, every lane's
    answer from the arena as the writes left it, then every touched
    slot's summed hits applied under its config.  Returns the read block
    i64[n, 4] = (status, limit, remaining, reset_time).
  * `global_stage(gstate, gcfg, control, scratch)` and
    `global_apply(gstate, gcfg, control, scratch, now)` - the per-op
    lowering's halves (GUBER_PALLAS=1, global_apply_pallas): the upserts,
    the config writes and the sums, then, after the caller's replica
    reads, the apply, which leaves the scratch all zero.

For CUDA tensors each launches its kernel on the current stream (building
it with nvcc on first use, ops/build.py) or raises; for CPU tensors it runs
its plain version: apply_control, kernel.global_accumulate and
kernel.global_combined / kernel.global_apply of ops/kernel.py, composed as
the engine composed them, which chip_smoke.py and the tests hold the
kernels against.  Pad lanes (slot < 0) answer 0 in every field on both
paths.

`launches` counts kernel launches and `plain_calls` plain-version runs.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from gubernator_tpu_torch.ops import build, kernel
from gubernator_tpu_torch.ops.build import check_tensor
from gubernator_tpu_torch.ops.kernel import BucketState, GlobalConfig, WindowBatch

SOURCE = "global_window"
APPLY_SOURCE = "global_apply"

# the block's fields in order: n lane fields, kg config-lane fields, then
# ku upsert-lane fields
LANE_FIELDS = WindowBatch._fields + ("gacc",)
UPD_FIELDS = ("uslot", "ulimit", "uduration", "ualgo", "rslot")
UPS_FIELDS = ("pslot", "plimit", "pduration", "premaining", "ptstamp",
              "pexpire", "palgo")
_I32_FIELDS = ("slot", "algo", "uslot", "ualgo", "rslot", "pslot", "palgo")

launches = build.CallCounts("global_window", "global_stage", "global_apply")
plain_calls = build.CallCounts("global_window", "global_stage",
                               "global_apply")

_lock = threading.Lock()
_lib = None
_apply_lib = None


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


# ------------------------------------------------------------ control block

class Control(NamedTuple):
    """A GLOBAL window's packed control: block
    i64[control_words(n, kg, ku)]."""

    block: torch.Tensor
    n: int
    kg: int
    ku: int = 0


def control_words(n: int, kg: int, ku: int = 0) -> int:
    return (len(LANE_FIELDS) * n + len(UPD_FIELDS) * kg
            + len(UPS_FIELDS) * ku)


def pack_control(dst, gbatch: WindowBatch, gacc, upd, ups=None) -> tuple:
    """Write a window's lanes (gbatch, gacc: [S, Bg] or [n]), config lanes
    (upd: 5 arrays of [kg]) and upsert lanes (ups: 7 arrays of [ku], or
    None for ku = 0) into the int64 array `dst` (numpy, at least
    control_words(n, kg, ku) long), casting each field to int64.
    Returns (n, kg)."""
    n, kg = int(np.size(gacc)), int(np.size(upd[0]))
    ku = 0 if ups is None else int(np.size(ups[0]))
    off = 0
    for cols, size in (((*gbatch, gacc), n), (upd, kg), (ups or (), ku)):
        for a in cols:
            dst[off:off + size] = np.asarray(a).reshape(-1)
            off += size
    return n, kg


def make_control(gbatch: WindowBatch, gacc, upd, device,
                 ups=None) -> Control:
    """The packed control of host arrays as a new tensor on `device`."""
    n, kg = int(np.size(gacc)), int(np.size(upd[0]))
    ku = 0 if ups is None else int(np.size(ups[0]))
    host = np.empty(control_words(n, kg, ku), np.int64)
    pack_control(host, gbatch, gacc, upd, ups)
    return Control(torch.from_numpy(host).to(device), n, kg, ku)


def unpack_control(control: Control) -> tuple:
    """(lanes WindowBatch [n], gacc i64[n], upd 5-tuple of [kg]) as views of
    the block, each field back at its own dtype (slot, algo and the
    config-lane slots int32, is_init bool)."""
    block, n, kg, _ = control
    out, off = {}, 0
    for name in LANE_FIELDS + UPD_FIELDS:
        size = n if name in LANE_FIELDS else kg
        t = block[off:off + size]
        off += size
        if name in _I32_FIELDS:
            t = t.to(torch.int32)
        elif name == "is_init":
            t = t != 0
        out[name] = t
    lanes = WindowBatch(*[out[f] for f in WindowBatch._fields])
    return lanes, out["gacc"], tuple(out[f] for f in UPD_FIELDS)


def unpack_upserts(control: Control) -> tuple:
    """The control's upsert lanes as views of the block: the 7-tuple
    (pslot, plimit, pduration, premaining, ptstamp, pexpire, palgo) of
    [ku], the slots and algorithms int32."""
    block, n, kg, ku = control
    off = len(LANE_FIELDS) * n + len(UPD_FIELDS) * kg
    out = []
    for name in UPS_FIELDS:
        t = block[off:off + ku]
        off += ku
        out.append(t.to(torch.int32) if name in _I32_FIELDS else t)
    return tuple(out)


# ------------------------------------------------------------ plain pieces

def apply_config(gstate: BucketState, gcfg: GlobalConfig, upd) -> None:
    """Host-issued GLOBAL slot (re)configuration, in place (JAX
    engine.py:2645 _apply_config): config writes refresh limit/duration/
    algorithm from a window's latest request per slot; state resets
    (expire = 0 reads as never initialized) hit only the slots the host
    just (re)allocated.  The JAX scatter's index rule (.at[idx].set(
    mode="drop")): an index in [-G, 0) writes row G + idx, one below -G or
    at G and above drops (the host pads with G).  Write slots are unique
    within a window: a scatter with duplicate indices has no order."""
    uslot, ulimit, uduration, ualgo, rslot = upd
    u, keep = _scatter_rows(uslot, gcfg.limit.shape[0])
    gcfg.limit[u] = ulimit[keep]
    gcfg.duration[u] = uduration[keep]
    gcfg.algo[u] = ualgo[keep].to(gcfg.algo.dtype)
    gstate.expire[_scatter_rows(rslot, gcfg.limit.shape[0])[0]] = 0


def _scatter_rows(idx, G: int):
    """The rows a JAX scatter with mode="drop" writes for indices idx
    ([-G, 0) wraps, the rest outside [0, G) drops), and the mask of the
    indices kept."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + G, idx)
    keep = (idx >= 0) & (idx < G)
    return idx[keep], keep


def apply_control(gstate: BucketState, gcfg: GlobalConfig, upd,
                  ups=None) -> None:
    """The host's control-plane writes of one GLOBAL window, in place (JAX
    engine.py:2617 _apply_control): the upsert lanes first, each writing
    its slot's limit, duration, remaining, tstamp, expire and algo into
    the arena and its limit, duration and algo into the config (an
    owner's broadcast, the reference's UpdatePeerGlobals -> Cache.Add,
    gubernator.go:199-207), then apply_config, whose config lane or reset
    on the same slot wins.  Upsert slots are unique within a window, like
    the config lanes'."""
    if ups is not None and len(ups[0]):
        pslot, plimit, pduration, premaining, ptstamp, pexpire, palgo = ups
        p, keep = _scatter_rows(pslot, gcfg.limit.shape[0])
        for plane, vals in ((gstate.limit, plimit),
                            (gstate.duration, pduration),
                            (gstate.remaining, premaining),
                            (gstate.tstamp, ptstamp),
                            (gstate.expire, pexpire),
                            (gstate.algo, palgo),
                            (gcfg.limit, plimit),
                            (gcfg.duration, pduration),
                            (gcfg.algo, palgo)):
            plane[p] = vals[keep].to(plane.dtype)
    apply_config(gstate, gcfg, upd)


def _read_block(out: kernel.WindowOutput, slot: torch.Tensor) -> torch.Tensor:
    """A WindowOutput as the read block i64[n, 4], pad lanes (slot < 0) 0."""
    read = torch.stack([out.status.to(torch.int64), out.limit, out.remaining,
                        out.reset_time], dim=-1)
    return torch.where((slot >= 0)[:, None], read, 0)


def global_read_block(gstate: BucketState, control: Control,
                      now) -> torch.Tensor:
    """The per-op lowering's replica reads in torch ops (kernel.global_read)
    on the control's lanes: the read block i64[n, 4], pad lanes 0."""
    lanes, _, _ = unpack_control(control)
    return _read_block(kernel.global_read(gstate, lanes, now), lanes.slot)


# ------------------------------------------------------------ kernels

def load_library() -> ctypes.CDLL:
    """Build global_window.cu for sm_90a (ops/build.py) and bind its C entry
    point with ctypes."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.guber_global_window.argtypes = (
            [p] * 9 + [ll, p, ll, ll, ll, p, ll, p, i, p, p])
        lib.guber_global_window.restype = i
        lib.guber_global_window_ctas.argtypes = [ll]
        lib.guber_global_window_ctas.restype = i
        lib.guber_global_error_string.argtypes = [i]
        lib.guber_global_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def load_apply_library() -> ctypes.CDLL:
    """Build global_apply.cu for sm_90a (ops/build.py) and bind its C entry
    points with ctypes."""
    global _apply_lib
    with _lock:
        if _apply_lib is not None:
            return _apply_lib
        lib = build.load(APPLY_SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.guber_global_stage.argtypes = [p] * 9 + [ll, p, ll, ll, ll, p, p]
        lib.guber_global_stage.restype = i
        lib.guber_global_apply.argtypes = ([p] * 9
                                           + [ll, p, ll, ll, ll, p, ll, p])
        lib.guber_global_apply.restype = i
        lib.guber_apply_error_string.argtypes = [i]
        lib.guber_apply_error_string.restype = ctypes.c_char_p
        _apply_lib = lib
        return lib


def _dtype(name: str):
    return torch.int32 if name == "algo" else torch.int64


def _check(gstate: BucketState, gcfg: GlobalConfig, control: Control,
           scratch: torch.Tensor, what: str) -> int:
    """G of a checked GLOBAL arena, config, control and scratch; raises
    unless they sit on one cuda or cpu device."""
    dev = scratch.device
    G = scratch.shape[0] if scratch.dim() == 1 else -1
    if G < 1:
        raise ValueError(f"scratch: want i64[G], got {tuple(scratch.shape)}")
    check_tensor(scratch, "scratch", torch.int64, (G,), dev)
    for name, t in zip(BucketState._fields, gstate):
        check_tensor(t, f"gstate.{name}", _dtype(name), (G,), dev)
    for name, t in zip(GlobalConfig._fields, gcfg):
        check_tensor(t, f"gcfg.{name}", _dtype(name), (G,), dev)
    block, n, kg, ku = control
    if n < 1 or kg < 0 or ku < 0:
        raise ValueError(f"control: want n >= 1 lanes and kg, ku >= 0 "
                         f"config and upsert lanes, got n={n}, kg={kg}, "
                         f"ku={ku}")
    check_tensor(block, "control.block", torch.int64,
                 (control_words(n, kg, ku),), dev)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    return G


def _ptrs(gstate: BucketState, gcfg: GlobalConfig):
    return [t.data_ptr() for t in gstate] + [t.data_ptr() for t in gcfg]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise(rc: int, what: str, err) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {err(rc).decode()} ({rc})")


def cluster_ctas(n: int) -> int:
    """The CTAs of the cluster global_window launches for n lanes on the
    current CUDA device."""
    return int(load_library().guber_global_window_ctas(n))


def launch_window(gstate: BucketState, gcfg: GlobalConfig, control: Control,
                  scratch: torch.Tensor, now: int, ctas: int = 0,
                  stamps: torch.Tensor = None) -> torch.Tensor:
    """guber_global_window on checked CUDA inputs in a cluster of `ctas`
    CTAs (0: the kernel's choice), uncounted: global_window launches through
    here, and a check may launch at another cluster size (chip_smoke.py's 8
    and 16) or with `stamps` (debug_stamps) taking each CTA's phase
    stamps."""
    lib = load_library()
    G = scratch.shape[0]
    read = torch.empty((control.n, 4), dtype=torch.int64,
                       device=scratch.device)
    rc = lib.guber_global_window(
        *_ptrs(gstate, gcfg), G, control.block.data_ptr(), control.n,
        control.kg, control.ku, scratch.data_ptr(), int(now), read.data_ptr(),
        int(ctas),
        None if stamps is None else stamps.data_ptr(), _stream(scratch))
    _raise(rc, "global_window", lib.guber_global_error_string)
    return read


# the debug stamps a CTA (global_window.cu kStamps): its start, the end of
# phase A, the exit from the first barrier, the end of phase B, the exit
# from the second barrier, its end
STAMPS = ("start", "phase A", "barrier 1", "phase B", "barrier 2", "end")


def debug_stamps(ctas: int, device) -> torch.Tensor:
    """A stamps buffer for launch_window at `ctas` CTAs: a row a CTA of
    len(STAMPS) globaltimer nanoseconds, then as many clock64 cycles."""
    return torch.zeros((ctas, 2, len(STAMPS)), dtype=torch.int64,
                       device=device)


def stamp_split(stamps: torch.Tensor) -> dict:
    """One launch's phases from its stamps: for each stamp after the start,
    the latest CTA's globaltimer time since the earliest CTA's start (us)
    and the mean over CTAs of its clock64 cycles since that CTA's own
    start; "start spread" is the latest CTA's start (us)."""
    v = stamps.cpu().numpy().astype(np.int64)
    ns, cyc = v[:, 0], v[:, 1]
    t0 = ns[:, 0].min()
    out = {"start spread us": float(ns[:, 0].max() - t0) / 1e3}
    for k, name in enumerate(STAMPS[1:], 1):
        out[f"{name} us"] = float(ns[:, k].max() - t0) / 1e3
        out[f"{name} cycles"] = float((cyc[:, k] - cyc[:, 0]).mean())
    return out


def global_window(gstate: BucketState, gcfg: GlobalConfig, control: Control,
                  scratch: torch.Tensor, now: int) -> torch.Tensor:
    """One GLOBAL window, the arena and config updated in place.

    gstate: the GLOBAL arena, [G] planes (algo i32, the rest i64); gcfg:
    its GlobalConfig, [G]; control: the window's packed control (n lanes,
    kg config lanes); scratch: i64[G], all zero, left all zero; now: the
    window's clock.  Returns the read block i64[n, 4] = (status, limit,
    remaining, reset_time) per lane, pad lanes 0."""
    _check(gstate, gcfg, control, scratch, "global_window")
    if scratch.device.type == "cpu":
        return global_window_plain(gstate, gcfg, control, scratch, now)
    read = launch_window(gstate, gcfg, control, scratch, now)
    launches["global_window"] += 1
    return read


def global_window_plain(gstate: BucketState, gcfg: GlobalConfig,
                        control: Control, scratch: torch.Tensor,
                        now: int) -> torch.Tensor:
    """The plain version of global_window on any device: apply_control,
    kernel.global_accumulate of the lanes' gacc, kernel.global_combined,
    its new arena copied into gstate and its reads stacked to [n, 4] with
    pad lanes zeroed.  The scratch is not used."""
    plain_calls["global_window"] += 1
    lanes, gacc, upd = unpack_control(control)
    apply_control(gstate, gcfg, upd, unpack_upserts(control))
    summed = kernel.global_accumulate(torch.zeros_like(scratch),
                                      lanes._replace(hits=gacc))
    new, out = kernel.global_combined(gstate, gcfg, lanes, summed, now)
    for dst, src in zip(gstate, new):
        dst.copy_(src)
    return _read_block(out, lanes.slot)


def global_stage(gstate: BucketState, gcfg: GlobalConfig, control: Control,
                 scratch: torch.Tensor) -> None:
    """Phase A of a GLOBAL window (the per-op lowering's first half): the
    control's upserts, config writes and resets into gcfg and gstate, in
    place, and
    its lanes' gacc added per slot into scratch (i64[G], all zero before)."""
    G = _check(gstate, gcfg, control, scratch, "global_stage")
    if scratch.device.type == "cpu":
        return global_stage_plain(gstate, gcfg, control, scratch)
    lib = load_apply_library()
    rc = lib.guber_global_stage(
        *_ptrs(gstate, gcfg), G, control.block.data_ptr(), control.n,
        control.kg, control.ku, scratch.data_ptr(), _stream(scratch))
    _raise(rc, "global_stage", lib.guber_apply_error_string)
    launches["global_stage"] += 1


def global_stage_plain(gstate: BucketState, gcfg: GlobalConfig,
                       control: Control, scratch: torch.Tensor) -> None:
    """The plain version of global_stage on any device: apply_control, then
    kernel.global_accumulate of the lanes' gacc into scratch."""
    plain_calls["global_stage"] += 1
    lanes, gacc, upd = unpack_control(control)
    apply_control(gstate, gcfg, upd, unpack_upserts(control))
    scratch.copy_(kernel.global_accumulate(scratch,
                                           lanes._replace(hits=gacc)))


def global_apply(gstate: BucketState, gcfg: GlobalConfig, control: Control,
                 scratch: torch.Tensor, now: int) -> None:
    """Phase C of a GLOBAL window (the per-op lowering's second half), after
    global_stage on the same control and scratch: each touched slot's sum
    applied to its row under its config, merged only where the sum is
    nonzero (kernel.global_apply), in place; the scratch is left all
    zero."""
    G = _check(gstate, gcfg, control, scratch, "global_apply")
    if scratch.device.type == "cpu":
        return global_apply_plain(gstate, gcfg, control, scratch, now)
    lib = load_apply_library()
    rc = lib.guber_global_apply(
        *_ptrs(gstate, gcfg), G, control.block.data_ptr(), control.n,
        control.kg, control.ku, scratch.data_ptr(), int(now),
        _stream(scratch))
    _raise(rc, "global_apply", lib.guber_apply_error_string)
    launches["global_apply"] += 1


def global_apply_plain(gstate: BucketState, gcfg: GlobalConfig,
                       control: Control, scratch: torch.Tensor,
                       now: int) -> None:
    """The plain version of global_apply on any device: kernel.global_apply
    of the scratch's sums over the whole arena, copied into gstate, and the
    scratch zeroed."""
    plain_calls["global_apply"] += 1
    new = kernel.global_apply(gstate, gcfg, scratch, now)
    for dst, src in zip(gstate, new):
        dst.copy_(src)
    scratch.zero_()
