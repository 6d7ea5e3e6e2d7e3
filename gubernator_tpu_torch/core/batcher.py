"""Window batcher: accumulates decisions into device windows.

The single-node window paths of `gubernator_tpu/core/batcher.py` (the
analog of the reference's per-peer batching loop, peers.go:143-172):

  * the pipelined lane (core/pipeline.py), built when the engine has the
    native router: token and leaky requests in the compact ranges, not
    GLOBAL, ride stacked compact drains (`submit` sends them to
    `pipeline.submit_one`, `submit_now` whole lists to
    `pipeline.submit_many`);
  * the classic lane for everything else: requests queue until
    `batch_limit` items or `batch_wait` elapses, then the whole window
    ships as one `engine.process` call, followed, when the engine has the
    warm tier, by its `tier_maintain` on the same thread.

`submit_rpc` hands whole serialized RPCs to the pipeline's raw-RPC lane,
`submit_cols` a front-door worker's parsed columns to its column lane,
and `apply_upserts` writes an owner's GLOBAL broadcast into the replica
arena (engine.step([], upserts=...) in chunks, on the engine thread).

With a QoS manager (qos/, JAX batcher.py:382-409) every `submit` first
passes admission control: a full bounded queue, an unserviceable deadline
or a draining node answers in-band (`shed_response`) without queueing, and
an admitted request holds its slot until its decision resolves.  The
classic window is interleaved across tenants (fair slotting) and cut to
the congestion window, whose controller observes each window's wall time.

An `engine_dispatch` fault rule (net/faults.py) fails a classic window's
engine call on the engine thread: that window's waiters get the error,
and the next window serves.

`profile` (observability/introspect.py ProfileCapture, armed by POST
/v1/admin/profile) wraps the engine thread's drains and classic windows
in a torch.profiler capture, as the JAX batcher does (batcher.py:481-500);
with `metrics` each classic window counts as a device window and its wall
as the device_dispatch stage (one engine.process call covers dispatch
through fetch), and the pipeline shares the metrics and the tracer.

Responses resolve back to awaiting callers by position.  The engine is not
thread-safe, so all device work funnels through a single-thread executor
that the pipeline shares; NO_BATCHING requests jump the window (submit_now)
but share that serialization.
"""

from __future__ import annotations

import asyncio
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

from gubernator_tpu_torch.api.types import RateLimitReq, RateLimitResp
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.core.interval import ArmedInterval
from gubernator_tpu_torch.core.pipeline import DispatchPipeline
from gubernator_tpu_torch.net.faults import FAULTS, SEAM_ENGINE_DISPATCH
from gubernator_tpu_torch.observability.introspect import ProfileCapture
from gubernator_tpu_torch.qos import interleave_by_tenant, shed_response
from gubernator_tpu_torch.qos.fairness import tenant_of

log = logging.getLogger("gubernator.batcher")


class WindowBatcher:
    def __init__(self, engine: RateLimitEngine,
                 behaviors: Optional[BehaviorConfig] = None,
                 analytics=None, slo=None, qos=None, metrics=None,
                 tracer=None):
        """analytics / slo: the TrafficAnalytics and SLOEngine the
        pipeline feeds each drain's stats and wall time to, or None.
        qos: the QoSManager shared with the pipeline, or None.  metrics /
        tracer: the observability Metrics and Tracer, or None."""
        self.engine = engine
        self.behaviors = behaviors or BehaviorConfig()
        self.qos = qos
        self.metrics = metrics
        # the armable capture (POST /v1/admin/profile), checked on the
        # engine thread around each drain and window
        self.profile = ProfileCapture()
        self._pending: List[tuple] = []  # (req, accumulate, future)
        self._interval: Optional[ArmedInterval] = None
        self._waiter: Optional[asyncio.Task] = None
        self._windows: set = set()  # in-flight window tasks (strong refs)
        # one thread == one device stream; serializes all engine access
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="guber-device")
        self.profile.executor = self._executor
        # Injectable clock (ms epoch) for the classic lane; None = wall
        # time.  Tests pin it beside pipeline.now_fn.
        self.now_fn = None
        self.pipeline: Optional[DispatchPipeline] = DispatchPipeline(
            engine, self._executor, qos=qos, analytics=analytics, slo=slo,
            metrics=metrics, tracer=tracer, profile=self.profile)
        if not self.pipeline.enabled:
            self.pipeline = None
        else:
            # the submit-side coalescing window is the configured BatchWait
            self.pipeline.coalesce_wait = self.behaviors.batch_wait

    async def _legacy_process(self, reqs: Sequence[RateLimitReq]
                              ) -> List[RateLimitResp]:
        """One engine.process call on the engine thread, on the batcher's
        clock."""
        loop = asyncio.get_running_loop()
        now = self.now_fn() if self.now_fn is not None else None
        return await loop.run_in_executor(
            self._executor, lambda: self.engine.process(reqs, now))

    def _window_limit(self) -> int:
        """Flush threshold: batch_limit, capped by the congestion window
        when QoS is on."""
        limit = self.behaviors.batch_limit
        if self.qos is not None:
            limit = min(limit, self.qos.congestion.effective_window())
        return max(1, limit)

    async def submit(self, req: RateLimitReq, accumulate: bool = True,
                     deadline: Optional[float] = None,
                     admit: bool = True) -> RateLimitResp:
        """Queue into the current window; resolves when the window executes.
        accumulate=False keeps a GLOBAL request's hits out of the window's
        per-slot sum (engine.step).  With QoS the request first passes
        admission (`deadline`: absolute monotonic seconds, see
        QoSManager.deadline_from_timeout); a shed is answered in-band.
        admit=False queues it past admission, which cannot shed it."""
        adm = self.qos.admission if (self.qos is not None and admit) else None
        if adm is not None:
            reason = adm.try_admit(1, deadline=deadline)
            if reason is not None:
                return shed_response(req, reason)
        # an admitted request holds its slot until its decision resolves
        try:
            if (self.pipeline is not None and accumulate
                    and self.pipeline.eligible(req)):
                return await self.pipeline.submit_one(req)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._pending.append((req, accumulate, fut))
            if len(self._pending) >= self._window_limit():
                self._flush()
            elif len(self._pending) == 1:
                self._arm()
            return await fut
        finally:
            if adm is not None:
                adm.release(1)

    def _arm(self) -> None:
        if self._interval is None:
            self._interval = ArmedInterval(self.behaviors.batch_wait)
        self._interval.arm()
        if self._waiter is None or self._waiter.done():
            self._waiter = asyncio.create_task(self._wait_interval())

    async def _wait_interval(self) -> None:
        await self._interval.wait()
        # a flush the congestion window cuts re-arms the interval, but
        # from inside this task no new waiter starts, so this one waits
        # for the re-armed tick and flushes the rest (the JAX batcher
        # returns here and strands the rest until the window fills again)
        while self._pending:
            self._flush()
            if not self._pending:
                break
            await self._interval.wait()

    def _flush(self) -> None:
        window, self._pending = self._pending, []
        if self.qos is not None:
            if self.qos.fair_slotting:
                window = interleave_by_tenant(window,
                                              lambda t: tenant_of(t[0]))
            # the congestion window caps decisions a dispatch: the rest
            # stays queued for the next window, with the timer re-armed
            limit = self._window_limit()
            if len(window) > limit:
                window, self._pending = window[:limit], window[limit:]
                self._arm()
        task = asyncio.create_task(self._run_window(window))
        self._windows.add(task)
        task.add_done_callback(self._windows.discard)

    async def _run_window(self, window: List[tuple]) -> None:
        reqs = [w[0] for w in window]
        accumulate = [w[1] for w in window]
        loop = asyncio.get_running_loop()
        start = time.monotonic()

        def run():
            if FAULTS.enabled:
                FAULTS.on_sync(SEAM_ENGINE_DISPATCH, "window")
            prof = self.profile
            profiling = prof.armed
            if profiling:
                prof.before_drain()
            try:
                now = self.now_fn() if self.now_fn is not None else None
                resps = self.engine.process(reqs, now, accumulate)
                self._tier_maintain(now)
                return resps
            finally:
                if profiling:
                    prof.after_drain()

        try:
            resps = await loop.run_in_executor(self._executor, run)
        except Exception as e:  # resolve every waiter with the failure
            for _, _, fut in window:
                if not fut.done():
                    fut.set_exception(e)
            return
        wall = time.monotonic() - start
        if self.qos is not None:
            self.qos.congestion.observe_drain(wall)
        if self.metrics is not None:
            self.metrics.window_count.inc()
            self.metrics.window_occupancy.observe(len(reqs))
            self.metrics.window_duration.observe(wall)
            self.metrics.observe_stage("device_dispatch", wall)
        for (_, _, fut), resp in zip(window, resps):
            if not fut.done():
                fut.set_result(resp)

    def _tier_maintain(self, now) -> None:
        """Warm-tier demotion between windows (state/tiers.py; JAX
        batcher.py:365), on the engine thread right after a window, where
        the device rows are current; an attribute check when tiers are off.
        It never fails the window: forced eviction inside staging keeps
        the counts exact without it."""
        if self.engine._tiers is None:
            return
        try:
            self.engine.tier_maintain(now)
        except Exception:
            log.exception("warm-tier maintenance failed; continuing")

    async def submit_now(self, reqs: Sequence[RateLimitReq]
                         ) -> List[RateLimitResp]:
        """Run a ready-made window immediately (the NO_BATCHING lane): as
        one pipeline job when every request is eligible, else one
        engine.process call."""
        if (self.pipeline is not None and reqs
                and all(self.pipeline.eligible(r) for r in reqs)):
            return await self.pipeline.submit_many(reqs)
        return await self._legacy_process(reqs)

    async def submit_rpc(self, data: bytes, peer_mode: bool = False):
        """Serve a whole serialized GetRateLimitsReq (or, with peer_mode,
        an authoritative GetPeerRateLimitsReq) through the pipeline's
        raw-RPC lane; None means the caller must take the protobuf path
        (always so without a pipeline)."""
        if self.pipeline is None:
            return None
        return await self.pipeline.submit_rpc(data, peer_mode=peer_mode)

    async def submit_cols(self, cols: tuple, name_lens, n: int,
                          want_cols: bool = False):
        """Serve a front-door worker's parsed request columns through the
        pipeline (core/pipeline.py ColsJob); None means the hub must take
        the protobuf path (always so without a pipeline)."""
        if self.pipeline is None:
            return None
        return await self.pipeline.submit_cols(cols, name_lens, n,
                                               want_cols=want_cols)

    async def apply_upserts(self, upserts: Sequence) -> None:
        """Write owner-broadcast replica state, in chunks of the engine's
        max_global_updates (JAX batcher.py:552-560), on the engine thread
        and in turn with every window and drain, at the batcher's clock."""
        loop = asyncio.get_running_loop()
        cap = self.engine.max_global_updates
        for i in range(0, len(upserts), cap):
            chunk = list(upserts[i:i + cap])
            now = self.now_fn() if self.now_fn is not None else None
            await loop.run_in_executor(
                self._executor,
                lambda c=chunk, t=now: self.engine.step([], t, upserts=c))

    def busy(self) -> bool:
        """Is any request queued or in flight (either lane)?"""
        p = self.pipeline
        return bool(self._pending or self._windows
                    or (p is not None and p.busy()))

    def close(self) -> None:
        # a capture still running stops on the engine thread, which its
        # profiler belongs to, before that thread goes
        self.profile.cancel()
        if self.pipeline is not None:
            self.pipeline.close()
        if self._interval is not None:
            self._interval.stop()
        self._executor.shutdown(wait=False)
