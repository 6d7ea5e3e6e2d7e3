"""Build the port's CUDA sources with nvcc and load them with ctypes, and
the argument check the kernel wrappers share.

Each kernel source `ops/csrc/<name>.cu` becomes one shared library with a
plain C interface, `build/lib<name>.so` (gitignored), compiled for sm_90a
at first use.  A library is rebuilt when any file under `csrc/` is newer
than it, since the sources share headers (ladder.cuh).  `build` starts one
nvcc per stale source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

# source name -> (seconds, nvcc output) of this process's build of it
build_info: Dict[str, Tuple[float, str]] = {}

_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(so: Path) -> bool:
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir() if p.is_file())
    return so.stat().st_mtime < newest


def build(names: Sequence[str]) -> None:
    """Compile every stale source of `names` (e.g. "window_drain"), one nvcc
    process each, all started together.  Raises with nvcc's output if any
    fails."""
    with _lock:
        jobs = []
        for name in names:
            so = library_path(name)
            if not _stale(so):
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            logf = open(so.with_name(f"{so.name}.{os.getpid()}.log"), "w+")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT)
            jobs.append((name, so, tmp, logf, proc, time.perf_counter()))
        failed = []
        for name, so, tmp, logf, proc, t0 in jobs:
            rc = proc.wait()
            seconds = time.perf_counter() - t0
            logf.seek(0)
            out = logf.read()
            logf.close()
            os.unlink(logf.name)
            if rc != 0:
                failed.append(f"nvcc failed ({rc}) building {name}.cu:\n{out}")
                continue
            os.replace(tmp, so)
            build_info[name] = (seconds, out)
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library of `csrc/<name>.cu`, built first if it is stale."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless `t` has the dtype, shape and device a kernel takes and
    is contiguous."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
