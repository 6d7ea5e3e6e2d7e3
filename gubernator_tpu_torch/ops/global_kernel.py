"""Wrappers for the GLOBAL sub-window kernels (ops/csrc/global_window.cu and
ops/csrc/global_apply.cu).

`global_combined(state, cfg, batch, summed, now)` is the JAX package's
global_combined_staged (one Pallas kernel for the GLOBAL window's replica
reads and its apply of the summed hits): every read lane answers from the
arena as it was before the window, and every arena row takes its summed
hits under its config.  The new arena comes back as new planes (the kernel
writes out of place, so no read sees an applied row); the caller swaps
them in.

`global_apply(state, cfg, summed, now)` is the JAX package's
global_apply_pallas, the GUBER_PALLAS=1 lowering of the apply half alone:
every arena row takes its summed hits under its config, and the new arena
comes back as new planes.  The per-op engine runs it after the replica
reads (kernel.global_read, torch ops) in stream order.

For CUDA tensors each launches its kernel on the current stream (building
it with nvcc on first use, ops/build.py) or raises; for CPU tensors it runs
its plain version, kernel.global_combined / kernel.global_apply of
ops/kernel.py, which chip_smoke.py and the tests hold the kernels against.
Pad lanes (slot < 0) answer 0 in every field on both paths.

`launches` counts kernel launches and `plain_calls` plain-version runs.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from gubernator_tpu_torch.ops import build, kernel
from gubernator_tpu_torch.ops.build import check_tensor
from gubernator_tpu_torch.ops.kernel import BucketState, GlobalConfig, WindowBatch

SOURCE = "global_window"
APPLY_SOURCE = "global_apply"

launches = {"global_combined": 0, "global_apply": 0}
plain_calls = {"global_combined": 0, "global_apply": 0}

_lock = threading.Lock()
_lib = None
_apply_lib = None


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


def load_library() -> ctypes.CDLL:
    """Build global_window.cu for sm_90a (ops/build.py) and bind its C entry
    point with ctypes."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.guber_global_combined.argtypes = (
            [p] * 9 + [ll] + [p] * 6 + [ll, p, ll] + [p] * 8)
        lib.guber_global_combined.restype = i
        lib.guber_global_error_string.argtypes = [i]
        lib.guber_global_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def load_apply_library() -> ctypes.CDLL:
    """Build global_apply.cu for sm_90a (ops/build.py) and bind its C entry
    point with ctypes."""
    global _apply_lib
    with _lock:
        if _apply_lib is not None:
            return _apply_lib
        lib = build.load(APPLY_SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.guber_global_apply.argtypes = [p] * 10 + [ll, ll] + [p] * 7
        lib.guber_global_apply.restype = i
        lib.guber_apply_error_string.argtypes = [i]
        lib.guber_apply_error_string.restype = ctypes.c_char_p
        _apply_lib = lib
        return lib


def _dtype(name: str):
    return {"algo": torch.int32, "slot": torch.int32,
            "is_init": torch.bool}.get(name, torch.int64)


def _check_arena(state: BucketState, cfg: GlobalConfig,
                 summed: torch.Tensor) -> tuple:
    """(device, G) of a GLOBAL arena, its config and its summed hits."""
    dev = summed.device
    G = summed.shape[0] if summed.dim() == 1 else -1
    if G < 1:
        raise ValueError(f"summed: want i64[G], got {tuple(summed.shape)}")
    check_tensor(summed, "summed", torch.int64, (G,), dev)
    for name, t in zip(BucketState._fields, state):
        check_tensor(t, f"state.{name}", _dtype(name), (G,), dev)
    for name, t in zip(GlobalConfig._fields, cfg):
        check_tensor(t, f"cfg.{name}", _dtype(name), (G,), dev)
    return dev, G


def global_combined(state: BucketState, cfg: GlobalConfig, batch: WindowBatch,
                    summed: torch.Tensor, now: int):
    """One GLOBAL sub-window.

    state: the GLOBAL arena, [G] planes (algo i32, the rest i64); cfg: its
    GlobalConfig, [G]; batch: n read lanes (slot i32, hits/limit/duration
    i64, algo i32, is_init bool, all [n]); summed: i64[G], every shard's
    hits per slot.  Returns (new_state, read) with new_state new [G] planes
    and read i64[n, 4] = (status, limit, remaining, reset_time) per lane."""
    dev, G = _check_arena(state, cfg, summed)
    n = batch.slot.shape[0] if batch.slot.dim() == 1 else -1
    if n < 0:
        raise ValueError(f"batch.slot: want [n], got {tuple(batch.slot.shape)}")
    for name, t in zip(WindowBatch._fields, batch):
        check_tensor(t, f"batch.{name}", _dtype(name), (n,), dev)
    if dev.type == "cpu":
        return global_combined_plain(state, cfg, batch, summed, now)
    if dev.type != "cuda":
        raise ValueError(f"global_combined runs on cuda or cpu, not {dev}")
    lib = load_library()
    new = BucketState(*[torch.empty_like(t) for t in state])
    read = torch.empty((n, 4), dtype=torch.int64, device=dev)
    rc = lib.guber_global_combined(
        *[t.data_ptr() for t in state], *[t.data_ptr() for t in cfg], G,
        *[t.data_ptr() for t in batch], n, summed.data_ptr(), int(now),
        *[t.data_ptr() for t in new], read.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.guber_global_error_string(rc).decode()
        raise RuntimeError(f"global_window launch failed: {msg} ({rc})")
    launches["global_combined"] += 1
    return new, read


def global_combined_plain(state: BucketState, cfg: GlobalConfig,
                          batch: WindowBatch, summed: torch.Tensor, now: int):
    """The plain version of global_combined on any device:
    kernel.global_combined, its read half stacked to [n, 4] with pad lanes
    zeroed."""
    plain_calls["global_combined"] += 1
    new, out = kernel.global_combined(state, cfg, batch, summed, now)
    read = torch.stack([out.status.to(torch.int64), out.limit, out.remaining,
                        out.reset_time], dim=-1)
    return new, torch.where((batch.slot >= 0)[:, None], read, 0)


def global_apply(state: BucketState, cfg: GlobalConfig, summed: torch.Tensor,
                 now: int) -> BucketState:
    """The apply half of a GLOBAL window: every row of the arena takes its
    summed hits under its config, merged only where the sum is nonzero
    (kernel.global_apply).

    state: the GLOBAL arena, [G] planes (algo i32, the rest i64); cfg: its
    GlobalConfig, [G]; summed: i64[G].  Returns new [G] planes; the input
    arena is not written."""
    dev, G = _check_arena(state, cfg, summed)
    if dev.type == "cpu":
        return global_apply_plain(state, cfg, summed, now)
    if dev.type != "cuda":
        raise ValueError(f"global_apply runs on cuda or cpu, not {dev}")
    lib = load_apply_library()
    new = BucketState(*[torch.empty_like(t) for t in state])
    rc = lib.guber_global_apply(
        *[t.data_ptr() for t in state], *[t.data_ptr() for t in cfg],
        summed.data_ptr(), G, int(now), *[t.data_ptr() for t in new],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.guber_apply_error_string(rc).decode()
        raise RuntimeError(f"global_apply launch failed: {msg} ({rc})")
    launches["global_apply"] += 1
    return new


def global_apply_plain(state: BucketState, cfg: GlobalConfig,
                       summed: torch.Tensor, now: int) -> BucketState:
    """The plain version of global_apply on any device: kernel.global_apply."""
    plain_calls["global_apply"] += 1
    return kernel.global_apply(state, cfg, summed, now)
