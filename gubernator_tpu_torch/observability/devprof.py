"""Device-time flight recorder: measured kernel attribution for the
serving window.

The port of `gubernator_tpu/observability/devprof.py` on `torch.profiler`
(CUPTI on a card, the profiler's own op events on the CPU):

  * `find_trace_files` / `load_trace_events` / `parse_run_dir`: read the
    chrome traces a `torch.profiler` capture exports (`*.pt.trace.json`,
    plain or gzip) into complete events;
  * `self_times`: per-(pid, tid) interval nesting turns the events into
    per-kernel SELF time and attributes each kernel to a serving arm by the
    `guber_*` annotations the engine puts around its per-drain calls
    (core/engine.py, `torch.profiler.record_function`).  A capture with
    device events (a card) reads those: kernels, copies and sets.  A CPU
    capture has none, and its device work is the profiler's CPU ops;
  * `KernelTable`: a rolling fold of those rows, normalized to ms/window,
    keyed by arm and kernel name;
  * `WindowClock`: the always-on dispatch -> fetch-ready clock the pipeline
    feeds per drain (EWMA, the `guber_tpu_device_window_ms{arm}`
    histogram), with a bounded ring of slow windows carrying the trace IDs
    of the requests that rode them;
  * `DevprofController`: `GUBER_DEVPROF=periodic`, a shedding background
    thread that arms an N-drain capture, folds it and discards its trace;
  * `build_census_arms` / `measure_census_arms` / `census_table`: the
    serving arms as runnable specs on a small engine, so an arm's census
    and its measured ms/window come from the same program.

The arm join.  A launch is asynchronous, so a kernel can run after the
annotation around its launch closed, and time containment on the host
clock (the JAX module's join) is not sound.  A kernel joins its arm
instead through (1) the `gpu_user_annotation` ranges the profiler puts on
the device's own track around the work an annotation launched, then
(2) its launch: the runtime or driver call with the same `correlation`,
inside a `guber_*` annotation on the launching thread.  (A kernel's
`External id` names the op that launched it, on the same thread at the
same time as that launch, so it could join nothing the correlation does
not.)  Device work under no annotation is
`torch_shoulder` (the port's own torch ops between the drains).  On the
CPU the ops run where they are called, so containment in the annotation
on the same thread is sound there.  The profiler keeps only the device
events its clock places inside its window, and it can place them with an
offset from the host's clock that drifts as the process ages, so every
capture runs a roll before its first counted drain (or call) and after
its last, and only the work launched inside its CAPTURE_SPAN annotation
is read.  The roll adapts to the drift the captures show (`ROLL`, a
CaptureRoll): a capture whose counted work lost a hand-kernel event is
not folded and doubles it, and one that kept every hand kernel its
thread launched, the first after the profiler's start included, halves
it.

Arms (the JAX names where the port runs the counterpart path):
`fused_window` (engine.process's compact window: drain_compact at K = 1),
`int64_full` (its full-format window, window_full: the JAX `int64_xla`),
`composed_drain` (the pipeline's K-window drain), `composed_mixed_algos`
(the same drain with all five algorithms in one window),
`composed_analytics` (drain_compact_stats and stats_finish), `fetch` (the
drains' device-to-host copies).  The JAX `compact32_xla` has no arm: its
math was a Mosaic workaround the port does not carry.

The census of an arm is the hand-kernel launches a window that the
kernel wrappers count for one run of it (`launches` on a card,
`plain_calls` on the CPU: the same number, a property of the program).

Malformed or empty traces degrade to a logged no-op: a broken capture
never fails a request.  This module imports no torch at its top (the
front door's workers never import it anyway): the capture and the census
import it where they run.
"""

from __future__ import annotations

import gzip
import json
import logging
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from gubernator_tpu_torch.config import env_float, env_int

log = logging.getLogger("gubernator.devprof")

ARM_DRAIN = "composed_drain"
ARM_ANALYTICS = "composed_analytics"
ARM_FUSED = "fused_window"
ARM_FULL = "int64_full"
ARM_FETCH = "fetch"
ARM_OTHER = "torch_shoulder"

# annotation name -> arm, most specific first (core/engine.py puts these
# around its per-drain calls)
ANNOTATION_ARMS: Tuple[Tuple[str, str], ...] = (
    ("guber_analytics", ARM_ANALYTICS),
    ("guber_fetch", ARM_FETCH),
    ("guber_drain", ARM_DRAIN),
    ("guber_window_full", ARM_FULL),
    ("guber_window", ARM_FUSED),
)

# the annotation around a capture's counted drains or calls: only device
# work launched inside it is read (self_times)
CAPTURE_SPAN = "guber_capture"
# seconds a process's first capture on a card runs before its first
# counted drain and after its last: the profiler keeps only the device
# events its clock places inside its window, and can place them with an
# offset from the host's clock that drifts as the process ages (PERF.md
# section 6: on an H100 host a capture lost its first drains, more of them
# the older the process, and nine minutes in a capture with half a second
# of roll held no device event); later captures run ROLL's adapted value,
# at most ROLL_MAX_S
ROLL_S = 2.0
ROLL_MAX_S = 16.0

# the port's hand-written kernels (ops/csrc/*.cu), by their entry names
HAND_KERNELS = frozenset((
    "drain_compact_kernel", "drain_compact_stats_kernel",
    "window_full_kernel", "global_window_kernel", "stats_finish_kernel",
    "window_math_kernel", "global_stage_kernel", "global_apply_kernel",
    "global_upsert_kernel", "global_stage_read_kernel",
    "global_apply_rows_kernel"))

# chrome-trace categories: the card's own work, its annotation ranges, the
# host calls that launch work, the CPU's ops
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_OP_CATS = ("cpu_op", None)


def _annotation_arm(name: str) -> Optional[str]:
    for prefix, arm in ANNOTATION_ARMS:
        if name.startswith(prefix):
            return arm
    return None


def kernel_base(name: str) -> str:
    """A demangled kernel's entry name, without its return type,
    namespaces, template and parameters: `(anonymous
    namespace)::drain_compact_kernel(long const*, ...)` and `void
    at::native::f<4>(int)` -> `drain_compact_kernel`, `f`."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for sep in ("(", "<"):
        i = name.find(sep)
        if i >= 0:
            name = name[:i]
    return name.rsplit("::", 1)[-1].strip()


def is_hand_kernel(name: str) -> bool:
    return kernel_base(name) in HAND_KERNELS


# ------------------------------------------------------------------ parsing


def find_trace_files(run_dir: str) -> List[str]:
    """Every chrome trace a torch.profiler capture left under `run_dir`
    (`*.trace.json`, `*.trace.json.gz`; the profiler names its exports
    `<host>_<pid>.<ts>.pt.trace.json`)."""
    out: List[str] = []
    for root, _dirs, files in os.walk(run_dir):
        for f in files:
            if f.endswith((".trace.json", ".trace.json.gz")):
                out.append(os.path.join(root, f))
    return sorted(out)


def load_trace_events(path: str) -> List[dict]:
    """Chrome-trace complete events (ph == "X", positive duration) of one
    trace file, plain or gzip; malformed input degrades to a logged empty
    list."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
        if raw[:2] == b"\x1f\x8b":
            raw = gzip.decompress(raw)
        data = json.loads(raw.decode("utf-8", errors="replace"))
        events = data.get("traceEvents") if isinstance(data, dict) else None
        if not isinstance(events, list):
            log.warning("devprof: %s has no traceEvents list", path)
            return []
        return [e for e in events
                if isinstance(e, dict) and e.get("ph") == "X"
                and isinstance(e.get("dur"), (int, float)) and e["dur"] > 0
                and isinstance(e.get("ts"), (int, float))
                and isinstance(e.get("name"), str)]
    except (OSError, ValueError, EOFError) as e:
        log.warning("devprof: unreadable trace %s: %s", path, e)
        return []


def parse_run_dir(run_dir: str) -> List[dict]:
    """All complete events of every trace file under `run_dir` (empty and
    logged when the capture left nothing parseable)."""
    events: List[dict] = []
    files = find_trace_files(run_dir)
    if not files:
        log.warning("devprof: no trace file under %s", run_dir)
        return events
    for path in files:
        events.extend(load_trace_events(path))
    return events


def _args(e: dict) -> dict:
    a = e.get("args")
    return a if isinstance(a, dict) else {}


class _Spans:
    """The `guber_*` annotation intervals of each track, for the narrowest
    one covering a point."""

    def __init__(self):
        self._by_track: Dict[tuple, List[Tuple[float, float, str]]] = {}

    def __bool__(self) -> bool:
        return bool(self._by_track)

    def add(self, e: dict, arm: str) -> None:
        self._by_track.setdefault((e.get("pid"), e.get("tid")), []).append(
            (e["ts"], e["ts"] + e["dur"], arm))

    def holds(self, track: tuple) -> bool:
        return track in self._by_track

    def arm_at(self, track: tuple, t: float) -> Optional[str]:
        best = best_len = None
        for s0, s1, arm in self._by_track.get(track, ()):
            if s0 <= t <= s1 and (best_len is None or s1 - s0 < best_len):
                best, best_len = arm, s1 - s0
        return best


def self_times(events: List[dict], arm_hint: Optional[str] = None,
               span: str = CAPTURE_SPAN) -> List[Tuple[str, float, str]]:
    """(kernel name, self-time ms, arm) rows from raw trace events.

    With device events (a card's capture) the rows are the kernels, copies
    and sets on the device's tracks; without (a CPU capture) they are the
    CPU ops; with a `span` annotation (a capture's counted drains or
    calls, `guber_capture` by default) only the device work launched
    inside it, or the ops inside it.  Self time is a row's duration less its same-track nested
    children.  The arm is `arm_hint` when the whole capture is arm-scoped
    (the measured pass), else the join the module docstring describes;
    unattributed rows are ARM_OTHER."""
    device = any(e.get("cat") in _DEVICE_CATS for e in events)
    host_spans, gpu_spans, counted = _Spans(), _Spans(), _Spans()
    launch_at: Dict[object, tuple] = {}     # correlation -> (track, ts)
    for e in events:
        cat = e.get("cat")
        if e["name"] == span and cat in ("user_annotation", None):
            counted.add(e, span)
            continue
        arm = _annotation_arm(e["name"])
        if arm is not None and cat in ("gpu_user_annotation",):
            gpu_spans.add(e, arm)
            continue
        if arm is not None and cat in ("user_annotation", None):
            host_spans.add(e, arm)
        track = (e.get("pid"), e.get("tid"))
        a = _args(e)
        if cat in _LAUNCH_CATS and "correlation" in a:
            launch_at[a["correlation"]] = (track, e["ts"])

    def arm_of(e: dict) -> str:
        if arm_hint:
            return arm_hint
        track = (e.get("pid"), e.get("tid"))
        mid = e["ts"] + e["dur"] / 2.0
        if not device:
            return host_spans.arm_at(track, mid) or ARM_OTHER
        arm = gpu_spans.arm_at(track, mid)
        if arm is not None:
            return arm
        hit = launch_at.get(_args(e).get("correlation"))
        if hit is not None:
            arm = host_spans.arm_at(*hit)
            if arm is not None:
                return arm
        return ARM_OTHER

    def in_counted(e: dict) -> bool:
        """Inside the capture's counted span, when it has one: device
        work by its launch, an op by its midpoint."""
        if not counted:
            return True
        if device:
            hit = launch_at.get(_args(e).get("correlation"))
            return hit is not None and counted.arm_at(*hit) is not None
        return counted.arm_at((e.get("pid"), e.get("tid")),
                              e["ts"] + e["dur"] / 2.0) is not None

    tracks: Dict[tuple, List[dict]] = {}
    for e in events:
        cat = e.get("cat")
        if device:
            if cat not in _DEVICE_CATS:
                continue
        elif cat not in _HOST_OP_CATS or _annotation_arm(e["name"]):
            continue
        if in_counted(e):
            tracks.setdefault((e.get("pid"), e.get("tid")), []).append(e)

    rows: List[Tuple[str, float, str]] = []

    def flush(done: list) -> None:
        ev = done[2]
        self_us = max(0.0, ev["dur"] - done[1])
        rows.append((ev["name"], self_us / 1000.0, arm_of(ev)))

    for track in tracks.values():
        track.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[list] = []  # [end_us, child_sum_us, event]
        for e in track:
            ts, dur = e["ts"], e["dur"]
            while stack and stack[-1][0] <= ts:
                flush(stack.pop())
            if stack:
                stack[-1][1] += dur
            stack.append([ts + dur, 0.0, e])
        while stack:
            flush(stack.pop())
    return rows


def hand_kernel_events(events: List[dict],
                       span: str = CAPTURE_SPAN) -> Tuple[int, int]:
    """(hand-kernel device events launched inside the capture's counted
    spans, those launched anywhere on the threads that hold the spans).  A
    counted span is `span` or `span:<name>` (the measured pass's)."""
    spans = _Spans()
    launch_at: Dict[object, tuple] = {}
    for e in events:
        cat, a = e.get("cat"), _args(e)
        if cat in ("user_annotation", None) and (
                e["name"] == span or e["name"].startswith(span + ":")):
            spans.add(e, span)
        elif cat in _LAUNCH_CATS and "correlation" in a:
            launch_at[a["correlation"]] = ((e.get("pid"), e.get("tid")),
                                           e["ts"])
    inside = anywhere = 0
    for e in events:
        if e.get("cat") != "kernel" or not is_hand_kernel(e["name"]):
            continue
        hit = launch_at.get(_args(e).get("correlation"))
        if hit is None or not spans.holds(hit[0]):
            continue
        anywhere += 1
        inside += spans.arm_at(*hit) is not None
    return inside, anywhere


class CaptureRoll:
    """The process's capture roll on a card, adapted to the drift its
    captures show.  `judge` reads a parsed capture beside the hand-kernel
    launches its thread counted: a capture that lost one launched inside
    its counted spans doubles the roll (at least 0.25 s, at most
    ROLL_MAX_S) and is incomplete; one that kept every launch of its
    thread from the profiler's start to its stop, so that even the first
    one after the start lay inside the profiler's window, halves it
    (below 10 ms: 0).  The drift is the process's, so one roll serves
    every capture."""

    def __init__(self, seconds: float = ROLL_S) -> None:
        self.seconds = seconds
        self.lost = 0
        self._lock = threading.Lock()

    def judge(self, events: List[dict], counted: Optional[int],
              launched: Optional[int] = None,
              span: str = CAPTURE_SPAN) -> bool:
        """True unless the capture lost a hand kernel of its counted
        spans.  `counted`: the hand-kernel launches inside them (None: not
        counted, e.g. a CPU capture, which has no device events to lose);
        `launched`: the thread's from the profiler's start to its stop
        (None: unknown, the roll does not shrink)."""
        if counted is None:
            return True
        seen, seen_all = hand_kernel_events(events, span)
        with self._lock:
            if seen < counted:
                self.lost += 1
                self.seconds = min(ROLL_MAX_S, max(0.25, 2 * self.seconds))
                log.warning("devprof: a capture kept %d of %d counted hand "
                            "kernels; roll now %.3f s", seen, counted,
                            self.seconds)
                return False
            if launched and seen_all >= launched:
                half = self.seconds / 2
                self.seconds = half if half >= 0.01 else 0.0
        return True


ROLL = CaptureRoll()


# -------------------------------------------------------------- kernel table


class KernelTable:
    """Rolling per-kernel attribution: (arm, name) -> {count, total_ms},
    normalized to ms/window by the windows each fold covered.  Thread-safe
    (the periodic controller folds from its own thread while the admin
    plane reads)."""

    def __init__(self) -> None:
        self._rows: Dict[Tuple[str, str], dict] = {}
        self._windows = 0.0
        self._folds = 0
        self._lock = threading.Lock()

    def fold(self, events: List[dict], windows: float = 1.0,
             arm_hint: Optional[str] = None, span: str = CAPTURE_SPAN) -> int:
        """Fold one parsed capture covering `windows` request windows (the
        work of its `span`, when it has one; self_times); returns the rows
        folded (0: the capture was empty or malformed, a logged no-op)."""
        rows = self_times(events, arm_hint=arm_hint, span=span)
        if not rows:
            log.warning("devprof: capture folded 0 kernel rows "
                        "(empty or unclassifiable trace)")
            return 0
        with self._lock:
            self._windows += max(1.0, float(windows))
            self._folds += 1
            for name, ms, arm in rows:
                row = self._rows.get((arm, name))
                if row is None:
                    row = self._rows[(arm, name)] = {
                        "count": 0, "total_ms": 0.0}
                row["count"] += 1
                row["total_ms"] += ms
        return len(rows)

    def ms_per_window(self) -> Dict[str, float]:
        """Measured ms/window per arm."""
        with self._lock:
            if not self._windows:
                return {}
            out: Dict[str, float] = {}
            for (arm, _name), row in self._rows.items():
                out[arm] = out.get(arm, 0.0) + row["total_ms"]
            return {arm: ms / self._windows for arm, ms in out.items()}

    def snapshot(self, top: int = 50) -> dict:
        with self._lock:
            windows = self._windows
            rows = sorted(self._rows.items(),
                          key=lambda kv: -kv[1]["total_ms"])[:top]
            table = [{"kernel": name, "arm": arm, "count": r["count"],
                      "total_ms": round(r["total_ms"], 4),
                      "ms_per_window":
                          round(r["total_ms"] / windows, 5) if windows
                          else 0.0}
                     for (arm, name), r in rows]
            folds = self._folds
        return {"windows": windows, "folds": folds, "rows": table,
                "ms_per_window": {a: round(v, 5)
                                  for a, v in self.ms_per_window().items()}}


# -------------------------------------------------------------- window clock


class WindowClock:
    """Always-on per-arm window clock: the pipeline feeds one dispatch ->
    fetch-ready observation per drain.  Keeps a per-arm EWMA, feeds the
    `guber_tpu_device_window_ms{arm}` histogram when it has metrics, and
    records slow windows into a bounded ring with the trace IDs of the
    requests that rode them."""

    ALPHA = 0.2

    def __init__(self, metrics=None, ring: Optional[int] = None,
                 slow_ms: Optional[float] = None) -> None:
        self.metrics = metrics
        self.slow_ms = (env_float("GUBER_DEVPROF_SLOW_MS", 50.0)
                        if slow_ms is None else float(slow_ms))
        n = env_int("GUBER_DEVPROF_RING", 64) if ring is None else int(ring)
        self._slow: List[dict] = []
        self._slow_cap = max(1, n)
        self._ewma: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._lock = threading.Lock()

    def observe(self, arm: str, seconds: float,
                trace_ids: Optional[Callable[[], List[str]]] = None,
                windows: int = 1) -> bool:
        """One drain's dispatch -> fetch-ready duration.  `trace_ids` is a
        thunk called only for a slow window.  Returns True when the window
        was recorded as a slow exemplar."""
        ms = max(0.0, seconds) * 1000.0
        m = self.metrics
        if m is not None:
            m.device_window_ms.labels(arm=arm).observe(ms)
        with self._lock:
            prev = self._ewma.get(arm)
            ew = ms if prev is None else prev + self.ALPHA * (ms - prev)
            self._ewma[arm] = ew
            self._count[arm] = self._count.get(arm, 0) + 1
        if m is not None:
            m.device_window_ewma.labels(arm=arm).set(ew)
        # slow: past the absolute floor and well past this arm's norm
        if ms < self.slow_ms or ms < 3.0 * ew:
            return False
        rec = {"arm": arm, "ms": round(ms, 3), "windows": windows,
               "at": time.time(),
               "trace_ids": (trace_ids() if trace_ids is not None else [])}
        with self._lock:
            self._slow.append(rec)
            if len(self._slow) > self._slow_cap:
                del self._slow[0]
        return True

    def total(self) -> int:
        """Drains observed, every arm."""
        with self._lock:
            return sum(self._count.values())

    def snapshot(self) -> dict:
        with self._lock:
            arms = {arm: {"ewma_ms": round(ew, 4),
                          "count": self._count.get(arm, 0)}
                    for arm, ew in self._ewma.items()}
            slow = list(self._slow[-16:])
        return {"arms": arms, "slow_windows": slow}


# ------------------------------------------------------- continuous profiling


class DevprofController:
    """`GUBER_DEVPROF=periodic`: every `interval` seconds, arm an N-drain
    capture through the Instance's ProfileCapture, wait for it, fold its
    trace into the rolling KernelTable and delete the trace directory.
    Sheds the cycle (counted) while a capture is armed, so an operator's
    capture wins, cancels a capture the traffic never completed, and
    folds no capture that lost counted kernels (ROLL.judge; counted
    `incomplete`)."""

    def __init__(self, profile, table: KernelTable,
                 interval: Optional[float] = None,
                 drains: Optional[int] = None,
                 metrics=None,
                 windows_fn: Optional[Callable[[], int]] = None) -> None:
        self.profile = profile
        self.table = table
        self.metrics = metrics
        self.interval = (env_float("GUBER_DEVPROF_INTERVAL_S", 30.0,
                                   minimum=0.05)
                         if interval is None else max(0.05, float(interval)))
        self.drains = (env_int("GUBER_DEVPROF_DRAINS", 8)
                       if drains is None else max(1, int(drains)))
        self.windows_fn = windows_fn
        self.cycles = 0
        self.sheds = 0
        self.incomplete = 0
        self.kernel_rows = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._tmp: Optional[str] = None

    def run_once(self, capture_timeout: Optional[float] = None) -> bool:
        """One cycle (tests drive it without the thread): True when it
        folded at least one row."""
        if self.profile is None or self.profile.armed:
            self.sheds += 1
            self._count("shed")
            return False
        tmp = self._tmp = tempfile.mkdtemp(prefix="guber-devprof-")
        try:
            w0 = self.windows_fn() if self.windows_fn is not None else 0
            out = self.profile.arm(self.drains, tmp)
            if not out.get("armed"):
                self.sheds += 1
                self._count("shed")
                return False
            budget = (self.interval if capture_timeout is None
                      else capture_timeout)
            deadline = time.monotonic() + budget
            while (self.profile.armed and time.monotonic() < deadline
                   and not self._stop.is_set()):
                time.sleep(0.02)
            if self.profile.armed:
                # traffic too idle for N drains in the budget: stop the
                # capture and fold what it caught
                self.profile.cancel()
            # the counted drains' windows when the capture recorded them
            w1 = self.windows_fn() if self.windows_fn is not None else 0
            windows = self.profile.last.get("windows")
            if not windows:
                windows = (max(1, w1 - w0) if self.windows_fn
                           else self.drains)
            # the capture's trace is written before `armed` drops
            events = parse_run_dir(tmp)
            last = self.profile.last
            if not ROLL.judge(events, last.get("launches"),
                              last.get("thread_launches")):
                # a capture that lost counted kernels would read low
                self.cycles += 1
                self.incomplete += 1
                self._count("incomplete")
                return False
            folded = self.table.fold(events, windows=windows)
            self.kernel_rows += folded
            self.cycles += 1
            self._count("folded" if folded else "empty")
            return folded > 0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            self._tmp = None

    def _count(self, status: str) -> None:
        if self.metrics is not None:
            self.metrics.devprof_captures.labels(status=status).inc()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 - profiling never kills serving
                log.exception("devprof: periodic capture cycle failed")

    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="guber-devprof", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        # a join that timed out mid-cycle left its directory: reap it
        tmp = self._tmp
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
            self._tmp = None

    def status(self) -> dict:
        return {"interval_s": self.interval, "drains": self.drains,
                "cycles": self.cycles, "sheds": self.sheds,
                "incomplete": self.incomplete,
                "kernel_rows": self.kernel_rows,
                "roll_s": ROLL.seconds,
                "running": self._thread is not None}


class Devprof:
    """The Instance's facade: the rolling kernel table, the pipeline's
    window clock (core/service.py wires it) and the optional periodic
    controller."""

    def __init__(self, mode: str = "", metrics=None, profile=None,
                 windows_fn: Optional[Callable[[], int]] = None,
                 interval: Optional[float] = None,
                 drains: Optional[int] = None) -> None:
        self.mode = mode or "off"
        self.table = KernelTable()
        self.clock: Optional[WindowClock] = None
        self.controller: Optional[DevprofController] = None
        if mode == "periodic" and profile is not None:
            self.controller = DevprofController(
                profile, self.table, interval=interval, drains=drains,
                metrics=metrics, windows_fn=windows_fn)

    def start(self) -> None:
        if self.controller is not None:
            self.controller.start()

    def close(self) -> None:
        if self.controller is not None:
            self.controller.stop()

    def status(self) -> dict:
        snap = self.table.snapshot(top=0)
        out = {"mode": self.mode,
               "table": {"windows": snap["windows"],
                         "folds": snap["folds"],
                         "ms_per_window": snap["ms_per_window"]}}
        if self.clock is not None:
            out["clock"] = self.clock.snapshot()
        if self.controller is not None:
            out["controller"] = self.controller.status()
        return out

    def kernels_snapshot(self, census: Optional[dict] = None,
                         top: int = 50) -> dict:
        """The `/v1/admin/kernels` payload: census and measured ms/window
        side by side per arm, the rolling kernel table, the window clock."""
        table = self.table.snapshot(top=top)
        measured = table["ms_per_window"]
        arms = {}
        for arm in sorted(set(list(measured) + list(census or {}))):
            arms[arm] = {
                "census_kernels_per_window":
                    (census or {}).get(arm),
                "measured_ms_per_window": measured.get(arm),
            }
        out = {"arms": arms, "table": table["rows"],
               "windows": table["windows"]}
        if self.clock is not None:
            out["clock"] = self.clock.snapshot()
        if self.controller is not None:
            out["controller"] = self.controller.status()
        return out


# ------------------------------------------------- census arms, measured pass


def wrapper_calls(device_type: str) -> int:
    """The calling thread's hand-kernel wrapper calls so far, every
    kernel: their launches on a card, their plain-version runs on the CPU
    (the ops/*_kernel.py counts; another thread's calls, another engine's
    drains, never land in it)."""
    from gubernator_tpu_torch.ops import (
        drain_kernel,
        global_kernel,
        stats_kernel,
        window_math_kernel,
    )
    attr = "launches" if device_type == "cuda" else "plain_calls"
    return sum(getattr(m, attr).thread_total()
               for m in (drain_kernel, global_kernel, stats_kernel,
                         window_math_kernel))


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_census_arms(k: int = 8, device=None, capacity_per_shard: int = 256,
                      batch_per_shard: int = 64, num_shards: int = 1):
    """The serving arms as runnable specs over an engine on `device`
    (default `cuda`; by default a small one-shard one, the census's: the
    count is the same at every shape): [{name, fn, windows, device}].
    Each `fn` runs the arm once through the engine's entry points or the
    kernel wrappers, as serving does, without a fetch, on inputs already
    on the device (a serving drain's stack crosses from the host first:
    15a's table holds that copy, not this one)."""
    import numpy as np
    import torch

    from gubernator_tpu_torch.config import AnalyticsConfig
    from gubernator_tpu_torch.core.engine import RateLimitEngine
    from gubernator_tpu_torch.ops import drain_kernel, kernel

    t0 = 1_700_000_000_000
    shape = dict(capacity_per_shard=capacity_per_shard,
                 batch_per_shard=batch_per_shard, num_shards=num_shards,
                 global_capacity=32, global_batch_per_shard=8,
                 max_global_updates=8, device=device)
    eng = RateLimitEngine(**shape)
    an = RateLimitEngine(**shape)
    an.enable_analytics(AnalyticsConfig())
    s, b, c = eng.num_shards, eng.batch_per_shard, eng.capacity_per_shard
    dev = eng.device
    lane = np.arange(b, dtype=np.int64)

    def stack(algos) -> np.ndarray:
        one = kernel.encode_batch_host(
            lane % c, np.ones(b, np.int64), np.full(b, 100, np.int64),
            np.full(b, 60_000, np.int64), algos, np.zeros(b, bool))
        return np.broadcast_to(one, (k, s, b, 2)).copy()

    packed = torch.from_numpy(stack(np.zeros(b, np.int64))).to(dev)
    # every wire algorithm (token, leaky, GCRA, sliding window,
    # concurrency) live in one window's lanes: the algorithm rides the
    # ladder, not extra kernels
    packed_mix = torch.from_numpy(stack(lane % 5)).to(dev)
    # the GLOBAL-composed call reads its clock on the host
    nows_host = np.full(k, t0, np.int64)
    nows = torch.from_numpy(nows_host).to(dev)
    packed1, nows1 = packed[:1].contiguous(), nows[:1].contiguous()
    full = kernel.WindowBatch(
        slot=torch.from_numpy(np.broadcast_to(
            (lane % c).astype(np.int32), (s, b)).copy()).to(dev),
        hits=torch.ones((s, b), dtype=torch.int64, device=dev),
        limit=torch.full((s, b), 1 << 40, dtype=torch.int64, device=dev),
        duration=torch.full((s, b), 60_000, dtype=torch.int64, device=dev),
        algo=torch.zeros((s, b), dtype=torch.int32, device=dev),
        is_init=torch.zeros((s, b), dtype=torch.bool, device=dev))
    tenants = torch.zeros((k, s, b), dtype=torch.int32, device=dev)
    control = an.empty_drain_control()

    def int64_full():
        drain_kernel.window_full(eng.state, full, t0)

    def fused_window():
        drain_kernel.drain_compact(eng.state, packed1, nows1)

    def composed_drain():
        eng.pipeline_dispatch(packed, nows, n_windows=k)

    def composed_mixed_algos():
        eng.pipeline_dispatch(packed_mix, nows, n_windows=k)

    def composed_analytics():
        an.pipeline_dispatch_global(packed, nows_host, *control, n_windows=k,
                                    analytics_args=(tenants, 0))

    return [{"name": fn.__name__, "fn": fn, "windows": w, "device": dev}
            for fn, w in ((int64_full, 1), (fused_window, 1),
                          (composed_drain, k), (composed_mixed_algos, k),
                          (composed_analytics, k))]


def census_of(spec) -> float:
    """Hand-kernel launches a window of one run of the arm."""
    before = wrapper_calls(spec["device"].type)
    spec["fn"]()
    _sync(spec["device"])
    return (wrapper_calls(spec["device"].type) - before) / spec["windows"]


def new_profiler():
    """A torch.profiler.profile of CPU and, where the build has it, CUDA
    activity (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity

    return torch.profiler.profile(activities=[
        a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
        if a in torch.profiler.supported_activities()])


def on_card() -> bool:
    """Whether this process's captures trace a card."""
    import torch
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def capture_roll() -> float:
    """ROLL's seconds where the profiler traces a card, else 0 (the
    CPU's ops and the window share one clock)."""
    return ROLL.seconds if on_card() else 0.0


def trace_file(trace_dir: str) -> str:
    """Where a capture's chrome trace goes: torch.profiler's own naming,
    `<host>_<pid>.<ns>.pt.trace.json`."""
    return os.path.join(trace_dir, f"{os.uname().nodename}_{os.getpid()}."
                        f"{time.time_ns()}.pt.trace.json")


def capture(spans, trace_dir: str, prime=None) -> None:
    """Run each (span name, fn) of `spans` in turn inside its counted span
    of one new_profiler() capture, a roll after its start and before its
    stop, and export the trace into `trace_dir`.  `prime` runs first, in
    the roll, outside every span: a card's capture can lose the first
    device work after it starts (a serving capture's roll drains stand in
    for it)."""
    from torch.profiler import record_function

    roll = capture_roll()
    with new_profiler() as prof:
        if prime is not None:
            prime()
        time.sleep(roll)
        for name, fn in spans:
            with record_function(name):
                fn()
        time.sleep(roll)
    prof.export_chrome_trace(trace_file(trace_dir))


def measure_census_arms(arms=None, iters: int = 2,
                        table: Optional[KernelTable] = None,
                        device=None) -> dict:
    """Run every arm once to warm it, then each `iters` times inside its
    own counted span (`guber_capture:<arm>`) of one capture, and parse the
    trace into measured ms/window per arm (the join key is the arm's
    name); a capture that lost counted kernels (ROLL.judge) is taken once
    more, and folds nothing if it lost them again.  Returns {"arms":
    {name: {...}}, "complete", "roll_s", "kernel_table": snapshot},
    each arm with its measured ms/window, its device (or CPU-op) rows a
    window, its hand-kernel events a window and the wrapper calls a window
    of the same counted runs (its census); folds into `table` when given
    (the Instance's).  Other threads may launch meanwhile (a serving
    engine thread): the counts are the calling thread's, and the rows
    only the work launched inside the counted spans.  A serving Instance's
    caller holds its ProfileCapture (hold / release) around the call, the
    process's one profiler."""
    if arms is None:
        arms = build_census_arms(device=device)
    if table is None:
        table = KernelTable()
    iters = max(1, iters)
    calls: Dict[str, int] = {}

    def prime():
        for spec in arms:
            spec["fn"]()
            _sync(spec["device"])

    def counted(spec):
        def run():
            d = spec["device"]
            before = wrapper_calls(d.type)
            for _ in range(iters):
                spec["fn"]()
            _sync(d)
            calls[spec["name"]] = wrapper_calls(d.type) - before
        return run

    prime()
    card = arms[0]["device"].type == "cuda"
    # a capture that lost counted kernels grew the roll: one more try
    for _attempt in range(2):
        tmp = tempfile.mkdtemp(prefix="guber-measure-")
        try:
            before = wrapper_calls("cuda") if card else 0
            capture([(f"{CAPTURE_SPAN}:{spec['name']}", counted(spec))
                     for spec in arms], tmp, prime=prime)
            launched = wrapper_calls("cuda") - before if card else None
            events = parse_run_dir(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        complete = ROLL.judge(events, sum(calls.values()) if card else None,
                              launched)
        if complete:
            break
    measured: Dict[str, dict] = {}
    for spec in arms:
        name = spec["name"]
        span = f"{CAPTURE_SPAN}:{name}"
        rows = self_times(events, arm_hint=name, span=span)
        n = spec["windows"] * iters
        if complete:
            table.fold(events, windows=n, arm_hint=name, span=span)
        measured[name] = {
            "measured_ms_per_window":
                round(sum(ms for _n, ms, _a in rows) / n, 6),
            "kernel_events": len(rows),
            "hand_kernel_events_per_window":
                sum(1 for r in rows if is_hand_kernel(r[0])) / n,
            "census_kernels_per_window": calls[name] / n,
        }
    return {"arms": measured, "complete": complete, "roll_s": ROLL.seconds,
            "kernel_table": table.snapshot()}


_census_cache: Dict[str, Dict[str, float]] = {}
_census_lock = threading.Lock()


def census_table(refresh: bool = False, device=None) -> Dict[str, float]:
    """Per-arm hand-kernel launches a window on `device` (default `cuda`),
    counted from one run of each arm and cached per device type (the
    census changes only when the program does)."""
    from gubernator_tpu_torch.core.engine import resolve_device

    key = resolve_device(device).type
    with _census_lock:
        if key in _census_cache and not refresh:
            return _census_cache[key]
        out = {spec["name"]: round(census_of(spec), 4)
               for spec in build_census_arms(device=device)}
        _census_cache[key] = out
        return out
