"""The per-op window step: torch prep, the window-math kernel
(ops/csrc/window_math.cu), torch commit.

The JAX package's GUBER_PALLAS=1 lowering of a window step is
window_step_pallas (pallas_kernel.py:239): the sort by slot, the segment
structure, the arena gather and the fold classification run in XLA
(kernel.window_prep), only kernel.window_math runs in the Pallas kernel,
and the scatter back to the arena and the un-sort run in XLA again
(kernel.window_commit).  This module is that split on PyTorch:

  * `window_math(now, max_pos, <19 sorted-lane tensors>, reg)` - the
    kernel, over one window's [B] sorted lanes in CTAs of
    `default_tile()` lanes, returning (out_sorted, fin) equal to
    kernel.window_math at every valid lane; invalid lanes answer 0 and
    carry their gathered register as fin (`launch_math` launches it at
    another tile width, uncounted);
  * `window_step_per_op(state, batch, now, in_place=False)` - one
    shard's window:
    kernel.window_prep, window_math, kernel.window_commit.  It is the
    counterpart of window_step_pallas(compact32=False) and returns what
    kernel.window_step returns, with pad lanes answering 0.

The kernel is int64 throughout; the TPU kernel's compact32 form (int32
times rebased to the window's now, a Mosaic workaround) is not ported.
For CUDA tensors `window_math` launches the kernel on the current stream
(building it with nvcc on first use, ops/build.py) or raises; for CPU
tensors it runs the plain version, kernel.window_math of ops/kernel.py,
which chip_smoke.py and the tests hold the kernel against.

`launches` counts kernel launches and `plain_calls` plain-version runs.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from gubernator_tpu_torch.ops import build, kernel
from gubernator_tpu_torch.ops.build import check_tensor
from gubernator_tpu_torch.ops.kernel import (
    BucketState,
    WindowBatch,
    WindowOutput,
    _Reg,
)

SOURCE = "window_math"

# the sorted-lane inputs, in window_step_pallas's order, and their types
LANE_FIELDS = ("s_valid", "s_hits", "s_limit", "s_duration", "s_algo",
               "s_init", "s_agg", "pos", "seg_len", "seg_start_idx",
               "seg_fold", "h0", "l0", "d0", "a0", "fresh_seg", "nz",
               "n_lead", "hstar")
_B, _I32, _I64 = torch.bool, torch.int32, torch.int64
LANE_DTYPES = (_B, _I64, _I64, _I64, _I32, _B, _B, _I32, _I32, _I32, _B,
               _I64, _I64, _I64, _I32, _B, _I32, _I32, _I64)

launches = {"window_math": 0}
plain_calls = {"window_math": 0}

_lock = threading.Lock()
_lib = None


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


def load_library() -> ctypes.CDLL:
    """Build window_math.cu for sm_90a (ops/build.py) and bind its C entry
    point with ctypes."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build.load(SOURCE)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.guber_window_math.argtypes = [ll, ll, i, i] + [p] * 36
        lib.guber_window_math.restype = i
        lib.guber_math_default_tile.argtypes = []
        lib.guber_math_default_tile.restype = i
        lib.guber_math_error_string.argtypes = [i]
        lib.guber_math_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def default_tile() -> int:
    """The lanes a CTA window_math launches with."""
    return load_library().guber_math_default_tile()


def window_math(now, max_pos, s_valid, s_hits, s_limit, s_duration, s_algo,
                s_init, s_agg, pos, seg_len, seg_start_idx, seg_fold, h0, l0,
                d0, a0, fresh_seg, nz, n_lead, hstar, reg: _Reg):
    """kernel.window_math over sorted lanes (kernel.window_prep's outputs).

    now, max_pos: ints.  The 19 lane tensors (types in LANE_DTYPES) and
    the six planes of `reg` (the gathered registers; algo i32, the rest
    i64) are all [B].  Returns (out_sorted, fin): WindowOutput (status
    i32, limit, remaining, reset_time i64) and _Reg, [B] in sorted
    order."""
    lanes = (s_valid, s_hits, s_limit, s_duration, s_algo, s_init, s_agg,
             pos, seg_len, seg_start_idx, seg_fold, h0, l0, d0, a0,
             fresh_seg, nz, n_lead, hstar)
    dev = s_valid.device
    shape = tuple(s_valid.shape)
    if len(shape) != 1 or shape[0] < 1:
        raise ValueError(f"s_valid: want [B], got {shape}")
    for name, dt, t in zip(LANE_FIELDS, LANE_DTYPES, lanes):
        check_tensor(t, name, dt, shape, dev)
    for name, t in zip(_Reg._fields, reg):
        check_tensor(t, f"reg.{name}", _I32 if name == "algo" else _I64,
                     shape, dev)
    if dev.type == "cpu":
        return window_math_plain(now, max_pos, *lanes, reg)
    if dev.type != "cuda":
        raise ValueError(f"window_math runs on cuda or cpu, not {dev}")
    got = launch_math(now, max_pos, *lanes, reg)
    launches["window_math"] += 1
    return got


def launch_math(now, max_pos, *args, tile: int = 0):
    """guber_window_math on checked CUDA inputs (window_math's arguments
    after max_pos) in CTAs of `tile` lanes (0: the kernel's default),
    uncounted: window_math launches through here, and a check may launch
    at another tile width (chip_smoke.py)."""
    *lanes, reg = args
    dev = lanes[0].device
    shape = tuple(lanes[0].shape)
    lib = load_library()
    tile = tile or default_tile()
    out = WindowOutput(torch.empty(shape, dtype=_I32, device=dev),
                       *[torch.empty(shape, dtype=_I64, device=dev)
                         for _ in range(3)])
    fin = _Reg(*[torch.empty_like(t) for t in reg])
    rc = lib.guber_window_math(
        int(now), int(max_pos), shape[0], int(tile),
        *[t.data_ptr() for t in lanes], *[t.data_ptr() for t in reg],
        *[t.data_ptr() for t in out], *[t.data_ptr() for t in fin],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.guber_math_error_string(rc).decode()
        raise RuntimeError(f"window_math launch failed: {msg} ({rc})")
    return out, fin


def window_math_plain(now, max_pos, s_valid, s_hits, s_limit, s_duration,
                      s_algo, s_init, s_agg, pos, seg_len, seg_start_idx,
                      seg_fold, h0, l0, d0, a0, fresh_seg, nz, n_lead, hstar,
                      reg: _Reg):
    """The plain version of window_math on any device: kernel.window_math,
    invalid lanes answering 0 with their gathered register as fin."""
    plain_calls["window_math"] += 1
    out, fin = kernel.window_math(
        torch.as_tensor(now, dtype=_I64, device=s_valid.device), max_pos,
        s_valid, s_hits, s_limit, s_duration, s_algo, s_agg, pos, seg_len,
        seg_start_idx, seg_fold, h0, l0, d0, a0, fresh_seg, reg, nz, n_lead,
        hstar)
    return (WindowOutput(*[torch.where(s_valid, o, 0) for o in out]),
            _Reg(*[torch.where(s_valid, f, r) for f, r in zip(fin, reg)]))


def window_step_per_op(state: BucketState, batch: WindowBatch, now,
                       in_place: bool = False
                       ) -> tuple[BucketState, WindowOutput]:
    """One window applied to one shard's arena: kernel.window_prep (torch
    ops), window_math (the kernel), kernel.window_commit (torch ops).

    state: [C] planes; batch: [B] lanes; now: int.  Returns (new_state,
    responses in lane order) as kernel.window_step does, pad lanes
    answering 0.  `state` is not written unless `in_place`, when the
    touched rows are scattered into its planes and new_state is `state`
    (the donated update of the JAX engine)."""
    now_t = torch.as_tensor(now, dtype=_I64, device=batch.slot.device)
    prep = kernel.window_prep(state, batch, now_t)
    out_sorted, fin = window_math(
        int(now), prep.max_pos, prep.s_valid, prep.s_hits, prep.s_limit,
        prep.s_duration, prep.s_algo, prep.s_init, prep.s_agg, prep.pos,
        prep.seg_len, prep.seg_start_idx, prep.seg_fold, prep.h0, prep.l0,
        prep.d0, prep.a0, prep.fresh_seg, prep.nz, prep.n_lead, prep.hstar,
        prep.cur)
    return kernel.window_commit(state, prep, fin, out_sorted, in_place)
