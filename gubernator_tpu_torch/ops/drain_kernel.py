"""Wrappers for the window-drain kernel (ops/csrc/window_drain.cu).

Two entry points share the kernel's per-window device code:

  * `drain_compact(arena, packed, nows)` - K windows of compact request
    words in one launch (the JAX package's window_drain_fused_planes and,
    at K=1, window_step_fused_planes).  Returns response words, stored
    limits and per-window limit-mismatch flags.
  * `window_full(arena, batch, now)` - one window of decoded int64 columns
    (the engine's full-format path for windows outside the compact caps).

Both update the arena planes in place.  For CUDA tensors they launch the
kernel on the current stream (building it with nvcc on first use) or
raise; for CPU tensors they run the plain version, the int64 oracle of
ops/kernel.py, which chip_smoke.py and the tests hold the kernel against.
Pad lanes (slot < 0) answer 0 in every output field on both paths.

`launches` counts kernel launches and `plain_calls` counts plain-version
runs, per entry point, so a caller can prove which path served it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

from gubernator_tpu_torch.ops import kernel
from gubernator_tpu_torch.ops.kernel import BucketState, WindowBatch, WindowOutput

_SRC = Path(__file__).resolve().parent / "csrc" / "window_drain.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
_LIB_NAME = "libwindow_drain.so"

# lanes per window the kernel's shared-memory sort takes (window_drain.cu)
MAX_LANES = 16384

launches = {"drain_compact": 0, "window_full": 0}
plain_calls = {"drain_compact": 0, "window_full": 0}

_lock = threading.Lock()
_lib = None
# (seconds, nvcc output) of this process's kernel build; None until built
build_info = None


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def load_library() -> ctypes.CDLL:
    """Build window_drain.cu for sm_90a (once per source change) and bind its
    C entry points with ctypes."""
    global _lib, build_info
    with _lock:
        if _lib is not None:
            return _lib
        so = BUILD_DIR / _LIB_NAME
        if not so.exists() or so.stat().st_mtime < _SRC.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", str(tmp), str(_SRC)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}) building {_SRC.name}:\n"
                    f"{res.stdout}{res.stderr}")
            os.replace(tmp, so)
            build_info = (time.perf_counter() - t0, res.stdout + res.stderr)
        lib = ctypes.CDLL(str(so))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.guber_drain_compact.argtypes = [p, p, i, i, p, p, p, p, p, p, ll,
                                            p, p, p, p]
        lib.guber_drain_compact.restype = i
        lib.guber_window_full.argtypes = [p, p, p, p, p, p, ll, i, p, p, p, p,
                                          p, p, ll, p, p, p, p, p]
        lib.guber_window_full.restype = i
        lib.guber_error_string.argtypes = [i]
        lib.guber_error_string.restype = ctypes.c_char_p
        lib.guber_max_lanes.restype = i
        if lib.guber_max_lanes() != MAX_LANES:
            raise RuntimeError("window_drain.cu lane cap disagrees with "
                               "drain_kernel.MAX_LANES")
        _lib = lib
        return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_arena(arena: BucketState, device) -> int:
    C = arena.limit.shape[0]
    for name, t in zip(BucketState._fields, arena):
        dt = torch.int32 if name == "algo" else torch.int64
        _check(t, f"arena.{name}", dt, (C,), device)
    if C < 1:
        raise ValueError("arena has no slots")
    return C


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


def drain_compact(arena: BucketState, packed: torch.Tensor, nows: torch.Tensor):
    """Apply K compact windows, in order, to `arena` (updated in place).

    packed i64[K, B, 2] (kernel.encode_batch_host words), nows i64[K].
    Returns (words i64[K, B], limits i64[K, B], mism bool[K]): words are
    kernel.encode_output_word of each lane's response, limits the responses'
    stored limits, mism whether any valid lane's stored limit differs from
    its request's."""
    dev = packed.device
    if packed.dim() != 3:
        raise ValueError(f"packed: want [K, B, 2], got {tuple(packed.shape)}")
    K, B = packed.shape[0], packed.shape[1]
    if K < 1:
        raise ValueError("drain of zero windows")
    _check_lanes(B)
    _check(packed, "packed", torch.int64, (K, B, 2), dev)
    _check(nows, "nows", torch.int64, (K,), dev)
    C = _check_arena(arena, dev)
    if dev.type == "cpu":
        return drain_compact_plain(arena, packed, nows)
    if dev.type != "cuda":
        raise ValueError(f"drain_compact runs on cuda or cpu, not {dev}")
    lib = load_library()
    words = torch.empty((K, B), dtype=torch.int64, device=dev)
    limits = torch.empty((K, B), dtype=torch.int64, device=dev)
    mism = torch.empty((K,), dtype=torch.bool, device=dev)
    _launch(lib.guber_drain_compact, packed.data_ptr(), nows.data_ptr(), K, B,
            *_ptrs(arena), C, words.data_ptr(), limits.data_ptr(),
            mism.data_ptr(), _cuda_stream(dev))
    launches["drain_compact"] += 1
    return words, limits, mism


def drain_compact_plain(arena: BucketState, packed: torch.Tensor,
                        nows: torch.Tensor):
    """The plain version of drain_compact on any device: per window,
    decode_batch -> window_step -> encode_output_word, pads zeroed."""
    plain_calls["drain_compact"] += 1
    st = BucketState(*arena)
    words, limits, mism = [], [], []
    for k in range(packed.shape[0]):
        now = nows[k]
        bt = kernel.decode_batch(packed[k])
        st, out = kernel.window_step(st, bt, now)
        valid = bt.slot >= 0
        words.append(torch.where(valid, kernel.encode_output_word(out, now), 0))
        limits.append(torch.where(valid, out.limit, 0))
        mism.append(((out.limit != bt.limit) & valid).any())
    for dst, src in zip(arena, st):
        dst.copy_(src)
    return torch.stack(words), torch.stack(limits), torch.stack(mism)


def window_full(arena: BucketState, batch: WindowBatch, now: int) -> WindowOutput:
    """Apply one window of decoded columns to `arena` (updated in place).

    batch: slot i32, hits/limit/duration i64, algo i32, is_init bool, all
    [B].  Returns the responses (status i32, limit/remaining/reset_time
    i64, [B]) in lane order."""
    dev = batch.slot.device
    B = batch.slot.shape[0]
    _check_lanes(B)
    for name, t in zip(WindowBatch._fields, batch):
        dt = {"slot": torch.int32, "algo": torch.int32,
              "is_init": torch.bool}.get(name, torch.int64)
        _check(t, f"batch.{name}", dt, (B,), dev)
    C = _check_arena(arena, dev)
    if dev.type == "cpu":
        return window_full_plain(arena, batch, now)
    if dev.type != "cuda":
        raise ValueError(f"window_full runs on cuda or cpu, not {dev}")
    lib = load_library()
    out = WindowOutput(
        status=torch.empty((B,), dtype=torch.int32, device=dev),
        limit=torch.empty((B,), dtype=torch.int64, device=dev),
        remaining=torch.empty((B,), dtype=torch.int64, device=dev),
        reset_time=torch.empty((B,), dtype=torch.int64, device=dev))
    _launch(lib.guber_window_full, *[t.data_ptr() for t in batch], int(now),
            B, *_ptrs(arena), C, *[t.data_ptr() for t in out],
            _cuda_stream(dev))
    launches["window_full"] += 1
    return out


def window_full_plain(arena: BucketState, batch: WindowBatch,
                      now: int) -> WindowOutput:
    """The plain version of window_full on any device: window_step with
    pad lanes zeroed."""
    plain_calls["window_full"] += 1
    st, out = kernel.window_step(BucketState(*arena), batch, now)
    for dst, src in zip(arena, st):
        dst.copy_(src)
    valid = batch.slot >= 0
    return WindowOutput(*[torch.where(valid, f, 0) for f in out])
