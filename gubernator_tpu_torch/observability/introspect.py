"""Runtime introspection: the debug snapshot and on-demand device capture.

`build_debug_snapshot` (JAX `observability/introspect.py`) assembles the
one-read operator view served by `GET /v1/admin/debug`
(api/http_gateway.py) and `cli debug` (cmd/cli.py): arena occupancy, the
admission queue, the congestion window, per-peer breaker states, the
GLOBAL plane's errors and hints, the failure detector, the front door, the
fault rules, the serving pipeline, traffic analytics, the warm tier, the
SLO burn rates, per-stage latency quantiles, recent traces, the capture's
state and the device profiler's.  Every number comes from the accessor the
control loops read, so what the operator sees is what the controllers saw.

`ProfileCapture` wraps the next N drains of the engine thread in a
`torch.profiler` capture (CPU and CUDA activity: CUPTI on a card), armed
at runtime by `POST /v1/admin/profile` and by the periodic controller
(observability/devprof.py), and writes its chrome trace under the armed
directory (GUBER_PROFILE by default).  The armed check runs on the engine
thread around each drain, so when disarmed the hot path reads one int.
The profiler records the CPU ops of the thread that started it, so the
capture starts and stops on the engine thread: `cancel` from another
thread hands the stop to the engine thread's executor when it has one.
Before the last drain's capture stops, the device is synchronised, so its
kernels are in the trace.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time

from gubernator_tpu_torch.observability.devprof import (
    CAPTURE_SPAN,
    capture_roll,
    new_profiler,
    on_card,
    trace_file,
    wrapper_calls,
)

log = logging.getLogger("gubernator.introspect")


class ProfileCapture:
    """Arm-and-forget device profiler: `arm(n, dir)` from the admin plane,
    `before_drain()` / `after_drain()` from the engine thread around each
    drain.  Every transition happens under the lock, but the disarmed fast
    path reads the plain int `_remaining` first: a stale read only delays
    a capture by one drain.

    The profiler keeps only the device events its own clock places inside
    its window, and on a card it places them with an offset that drifts
    (devprof.ROLL), so a capture runs the roll before its first
    counted drain and after its last: it starts on the first armed drain,
    counts the armed drains that begin a roll later inside a
    `guber_capture` annotation (what devprof.self_times reads), and stops
    a roll after the last of them, on the engine thread.  `executor`: the
    engine thread's executor (set by the batcher), where the delayed stop
    and `cancel` run.  `windows_fn`: the engine's window count, to record
    the counted drains' windows.  `last` holds the last capture's trace
    file, its counted drains and windows, and the milliseconds its
    profiler took to start (the first start initialises CUPTI) and to
    stop and write, and on a card the roll it ran, the hand-kernel
    launches of its counted drains (`launches`) and of its thread from the
    profiler's start to its stop (`thread_launches`), which
    devprof.ROLL.judge reads beside the trace."""

    def __init__(self):
        self._lock = threading.Lock()
        self._remaining = 0
        self._dir = ""
        self._active = False
        self._held = False
        self._prof = None
        self._t0 = 0.0
        self._roll = 0.0
        self._span = None
        self._w0 = 0
        # the capturing thread, and its hand-kernel launches when the
        # profiler started and when the counted span opened (a card)
        self._tid = None
        self._l0 = self._s0 = None
        self.executor = None
        self.windows_fn = None
        self.last: dict = {}

    @property
    def armed(self) -> bool:
        return self._remaining > 0 or self._active or self._held

    def hold(self) -> bool:
        """Take the process's one profiler for a capture that runs off
        the engine thread (the measured pass, devprof.measure_census_arms):
        False while a capture is armed, running or held.  Until release(),
        arm() refuses and the periodic controller sheds."""
        with self._lock:
            if self._active or self._remaining > 0 or self._held:
                return False
            self._held = True
            return True

    def release(self) -> None:
        with self._lock:
            self._held = False

    def arm(self, drains: int, trace_dir: str = "") -> dict:
        """Schedule a capture of the next `drains` drains.  The default
        directory is GUBER_PROFILE, else a timestamped one under the
        temporary directory."""
        trace_dir = (trace_dir or os.environ.get("GUBER_PROFILE", "")
                     or os.path.join(tempfile.gettempdir(),
                                     f"guber-profile-{int(time.time())}"))
        with self._lock:
            if self._active or self._remaining > 0 or self._held:
                return {"armed": False, "error": "capture already in "
                        "progress", "dir": self._dir}
            self._remaining = max(1, int(drains))
            self._dir = trace_dir
        return {"armed": True, "drains": self._remaining, "dir": trace_dir}

    # ------------------------------------------------- engine-thread hooks

    def before_drain(self) -> None:
        """Engine thread, just before a drain: start the profiler on the
        first armed drain; open the counted span on the first drain a
        roll after the start."""
        with self._lock:
            start = not self._active and self._remaining > 0
            if start:
                self._active = True
        if start:
            try:
                t0 = time.perf_counter()
                self._tid = threading.get_ident()
                self._l0 = self._launches()
                prof = new_profiler()
                prof.start()
                self._prof = prof
                self._t0 = time.monotonic()
                self._roll = capture_roll()
                self.last = {"start_ms": (time.perf_counter() - t0) * 1000.0,
                             "drains": 0, "roll_s": self._roll}
                log.info("profile capture started -> %s (%d drains)",
                         self._dir, self._remaining)
            except Exception:
                log.exception("profile capture failed to start")
                with self._lock:
                    self._active = False
                    self._remaining = 0
                return
        if (self._span is None and self._prof is not None
                and self._remaining > 0
                and time.monotonic() - self._t0 >= self._roll):
            from torch.profiler import record_function
            self._span = record_function(CAPTURE_SPAN)
            self._span.__enter__()
            self._w0 = self.windows_fn() if self.windows_fn else 0
            self._s0 = self._launches()

    def after_drain(self) -> None:
        """Engine thread, after a drain: count it when it is inside the
        counted span; after the last, close the span and stop a roll
        later."""
        if self._span is None:
            return
        self.last["drains"] += 1
        with self._lock:
            self._remaining -= 1
            done = self._remaining <= 0
        if not done:
            return
        self._close_span()
        if self.executor is None or self._roll <= 0:
            self._stop("stopped")
            return

        def stop():
            try:
                self.executor.submit(self._stop_if_active)
            except RuntimeError:  # the engine thread is gone (closed)
                log.warning("profile capture: no engine thread to stop on")

        timer = threading.Timer(self._roll, stop)
        timer.daemon = True
        timer.start()

    def _launches(self):
        """The capturing thread's hand-kernel launches so far, on a card
        (None elsewhere, or on another thread)."""
        if threading.get_ident() != self._tid or not on_card():
            return None
        return wrapper_calls("cuda")

    def _close_span(self) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
            if self.windows_fn is not None:
                self.last["windows"] = self.windows_fn() - self._w0
            s1 = self._launches()
            if s1 is not None and self._s0 is not None:
                self.last["launches"] = s1 - self._s0

    def _stop(self, how: str) -> None:
        """Synchronise the device (the last drain's kernels finish inside
        the capture), stop the profiler, write its trace, then disarm
        (engine thread)."""
        prof, self._prof = self._prof, None
        try:
            self._close_span()
            l1 = self._launches()
            if l1 is not None and self._l0 is not None:
                self.last["thread_launches"] = l1 - self._l0
            if prof is not None:
                import torch
                t0 = time.perf_counter()
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                prof.stop()
                os.makedirs(self._dir, exist_ok=True)
                path = trace_file(self._dir)
                prof.export_chrome_trace(path)
                self.last.update(
                    stop_ms=(time.perf_counter() - t0) * 1000.0, file=path)
                log.info("profile capture %s -> %s", how, path)
        except Exception:
            log.exception("profile capture failed to stop")
        finally:
            with self._lock:
                self._active = False
                self._remaining = 0

    def cancel(self) -> None:
        """Disarm: drop the armed drains that have not started and stop a
        capture that has, writing what it caught (the periodic
        controller's recovery when traffic never completes the count).
        The stop runs on the engine thread when the executor is known."""
        with self._lock:
            self._remaining = 0
            if not self._active:
                return
        if self.executor is None:
            self._stop("cancelled")
            return
        try:
            self.executor.submit(self._stop_if_active).result(timeout=30.0)
        except Exception:
            log.exception("profile capture failed to cancel")

    def _stop_if_active(self) -> None:
        if self._active:
            self._stop("stopped" if self.last.get("drains") else "cancelled")

    def status(self) -> dict:
        with self._lock:
            # a held profiler (the measured pass) reads as active
            return {"active": self._active or self._held,
                    "remaining": self._remaining, "dir": self._dir}


def _jsonable(d: dict) -> dict:
    """Coerce numpy scalars (engine counters) to plain Python types so the
    snapshot always survives json.dumps."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = _jsonable(v)
        elif isinstance(v, (bool, int, float, str)) or v is None:
            out[k] = v
        elif hasattr(v, "item"):
            out[k] = v.item()
        else:
            out[k] = str(v)
    return out


def build_debug_snapshot(instance) -> dict:
    """One coherent operator view of a core.service.Instance."""
    out: dict = {
        "address": instance.advertise_address,
        "mesh_mode": instance.mesh_mode,
        "standalone": instance.standalone,
        "engine": _jsonable(instance.engine.cache_stats()),
    }
    if instance.qos is not None:
        adm = instance.qos.admission
        cong = instance.qos.congestion
        out["admission"] = {
            "pending": adm.pending,
            "pending_peak": adm.pending_peak,
            "max_pending": adm.max_pending,
            "saturated": adm.saturated,
            "inflight_windows": adm.inflight_windows,
            "shed_counts": dict(adm.shed_counts),
        }
        out["congestion"] = {
            "effective_window": cong.effective_window(),
            "latency_ewma_ms": cong.latency_ewma * 1000.0,
            "depth_ewma": cong.depth_ewma,
            "congested": cong.congested,
            "increases": cong.increases,
            "decreases": cong.decreases,
            "stage_ewma_ms": {k: v * 1000.0
                              for k, v in cong.stage_ewma.items()},
        }
    out["peers"] = [
        {"host": p.host, "is_owner": p.is_owner,
         "breaker": p.breaker.state}
        for p in instance.peer_list()
    ]
    gm = instance.global_mgr
    out["global_sync"] = {
        "send_errors": dict(gm.send_errors),
        "broadcast_errors": dict(gm.broadcast_errors),
        "hints": gm.hints.snapshot(),
    }
    if instance.monitor is not None:
        out["health"] = instance.monitor.snapshot()
    if instance.frontdoor is not None:
        out["frontdoor"] = _jsonable(instance.frontdoor.debug_snapshot())
    from gubernator_tpu_torch.net.faults import FAULTS
    if FAULTS.enabled:
        out["faults"] = FAULTS.describe()
    pipe = instance.batcher.pipeline
    if pipe is not None:
        out["pipeline"] = {
            "in_flight": pipe._in_flight,
            "rpc_staged": pipe.rpc_staged,
            "rpc_leftover": pipe.rpc_leftover,
            "rpc_refused": pipe.rpc_refused,
            "decisions_staged": pipe.decisions_staged,
            "lanes_staged": pipe.lanes_staged,
            "drains": pipe.drains,
            "depth": pipe.depth,
            "overlap": pipe.overlap_snapshot(),
        }
    if instance.analytics is not None:
        snap = instance.analytics.snapshot()
        out["analytics"] = {
            "totals": snap["totals"],
            "occupancy": snap["occupancy"],
            "tenants": snap["tenants"],
            "topk": snap["topk"][:10],  # the full table lives at /topk
        }
    tiers = instance.engine.tier_stats()
    if tiers is not None:
        out["tiers"] = tiers
    if instance.slo is not None:
        out["slo"] = instance.slo.snapshot()
    out["stages"] = (instance.metrics.stage_snapshot()
                     if instance.metrics is not None else {})
    if instance.tracer is not None:
        out["tracing"] = {
            "sample": instance.tracer.sample,
            "recent_traces": instance.tracer.recent_traces(),
        }
    out["profile"] = instance.batcher.profile.status()
    out["devprof"] = instance.devprof.status()
    return out
