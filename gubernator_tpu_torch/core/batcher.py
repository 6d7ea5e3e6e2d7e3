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

Mesh (lockstep) mode (JAX batcher.py:88-350), with a `lockstep_clock`
(parallel/distributed.py LockstepClock; required for a multiprocess
engine): `start_lockstep` runs the tick loop, which every batch_wait takes
up to lockstep_stack windows of queued requests (`_take_window`: a request
this rank cannot serve, a key of another rank's shard or a GLOBAL key not
yet registered, fails alone there), and issues the tick's collective
sequence on the engine thread: the pipeline's drain (`lockstep_pump`),
then the stacked step (`_run_lockstep_window`: engine.step, or
step_stacked at lockstep_stack), each at the clock's `now`, empty or not.
Nothing dispatches outside the tick: submit_now and the pipeline's
leftovers join the queue.  A tick whose step raises before it issued an
all-reduce (engine.collectives_issued unchanged) issues the empty step
instead (three tries); if that, or the drain's realignment, fails, or a
step or drain raises after its all-reduce (a second one would pair with
the other ranks' next window), the batcher fail-stops: it fails its queue
and every later submit (`_ended`) rather than serve out of step.  Every
`snapshot_every`-th tick the loop awaits `on_tick_snapshot(now)` between
that tick's dispatches and the next's, on every rank alike: the daemon's
mesh snapshots are taken there, at an agreed tick.
`stop_at_tick` is the agreed final tick: the loop ends once the clock
reaches it, on every rank alike, and a submit after it raises (a rank
serves only while the mesh ticks).  `run_profiled` wraps the step in the
armed capture, as the drains are.
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

# lockstep: ticks between reads of the agreed final tick, and how far ahead
# of its own tick a stopping rank proposes it (every rank reads it well
# before it: the ticks' collectives keep the ranks within a tick)
STOP_POLL_TICKS = 8
STOP_MARGIN_TICKS = 64


def _bind_device(device) -> None:
    """The engine thread's current CUDA device is the engine's: its
    streams, events and pinned copies then belong to the engine's card
    (a mesh rank with a card of its own need not be on card 0)."""
    if getattr(device, "type", None) == "cuda" and device.index is not None:
        import torch
        torch.cuda.set_device(device)


class WindowBatcher:
    def __init__(self, engine: RateLimitEngine,
                 behaviors: Optional[BehaviorConfig] = None,
                 analytics=None, slo=None, qos=None, metrics=None,
                 tracer=None, lockstep_clock=None):
        """analytics / slo: the TrafficAnalytics and SLOEngine the
        pipeline feeds each drain's stats and wall time to, or None.
        qos: the QoSManager shared with the pipeline, or None.  metrics /
        tracer: the observability Metrics and Tracer, or None.
        lockstep_clock: the mesh's LockstepClock (lockstep mode), or
        None."""
        if engine.multiprocess and lockstep_clock is None:
            # without a tick loop nothing would drain a mesh engine's
            # windows, and its submits would hang
            raise ValueError("a multiprocess (mesh) engine needs a "
                             "lockstep_clock-driven WindowBatcher")
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
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="guber-device",
            initializer=_bind_device,
            initargs=(getattr(engine, "device", None),))
        self.profile.executor = self._executor
        # Injectable clock (ms epoch) for the classic lane; None = wall
        # time.  Tests pin it beside pipeline.now_fn.
        self.now_fn = None
        # lockstep mode: the tick clock, the tick loop, the fail-stop flag
        # and the agreed final tick
        self.clock = lockstep_clock
        self._closed = False
        self._tick_task: Optional[asyncio.Task] = None
        # why the tick loop ended (the agreed stop, a fail-stop), or None
        self._ended: Optional[Exception] = None
        self.stop_at_tick: Optional[int] = None
        # the tick snapshot: every snapshot_every-th tick (0: never) the
        # loop awaits on_tick_snapshot(the tick's now)
        self.snapshot_every = 0
        self.on_tick_snapshot = None
        self.pipeline: Optional[DispatchPipeline] = DispatchPipeline(
            engine, self._executor, qos=qos, analytics=analytics, slo=slo,
            metrics=metrics, tracer=tracer, profile=self.profile,
            lockstep=lockstep_clock is not None)
        if not self.pipeline.enabled:
            self.pipeline = None
        elif self.pipeline.lockstep:
            # a job no stack takes rides the tick queue
            self.pipeline.legacy = self._legacy_lockstep
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
        if self._ended is not None:
            raise self._ended
        adm = self.qos.admission if (self.qos is not None and admit) else None
        if adm is not None:
            reason = adm.try_admit(1, deadline=deadline)
            if reason is not None:
                return shed_response(req, reason)
        # an admitted request holds its slot until its decision resolves
        try:
            if (self.pipeline is not None and accumulate
                    and (self.pipeline.eligible(req)
                         or self.pipeline.eligible_global(req))):
                return await self.pipeline.submit_one(req)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._pending.append((req, accumulate, fut))
            if self.clock is not None:
                # the tick loop takes it on the cluster's cadence
                return await fut
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
        engine.process call.  In lockstep mode there is no immediate path:
        the requests ride the next tick, each failing alone (JAX
        batcher.py:505-531)."""
        if (self.pipeline is not None and reqs
                and all(self.pipeline.eligible(r) for r in reqs)):
            return await self.pipeline.submit_many(reqs)
        if self.clock is not None:
            return await self._legacy_lockstep(reqs)
        return await self._legacy_process(reqs)

    # ------------------------------------------------------------ lockstep

    async def _legacy_lockstep(self, reqs: Sequence[RateLimitReq]
                               ) -> List[RateLimitResp]:
        """Requests onto the tick queue, resolved per item (an error
        answers its own item in-band): the lockstep counterpart of an
        engine.process call, which would dispatch outside the tick."""
        if self._ended is not None:
            raise self._ended
        loop = asyncio.get_running_loop()
        futs = [loop.create_future() for _ in reqs]
        self._pending.extend((r, True, f) for r, f in zip(reqs, futs))
        results = await asyncio.gather(*futs, return_exceptions=True)
        return [r if isinstance(r, RateLimitResp)
                else RateLimitResp(error=str(r)) for r in results]

    def start_lockstep(self) -> None:
        """Begin the tick loop (lockstep mode; call inside the loop)."""
        if self.clock is None:
            raise RuntimeError("start_lockstep needs a lockstep_clock")
        if self._tick_task is None:
            self._tick_task = asyncio.create_task(self._tick_loop())

    async def _tick_loop(self) -> None:
        """One tick every batch_wait, on the local monotonic clock, until
        the agreed final tick: the tick's windows, then its collective
        sequence [drain, stacked step] on the engine thread at the lockstep
        clock's `now`.  A tick that cannot realign fail-stops."""
        period = self.behaviors.batch_wait
        stack = max(self.behaviors.lockstep_stack, 1)
        t0 = time.monotonic()
        n = 0
        mesh = self.engine.mesh
        while not self._closed:
            if (self.stop_at_tick is None and mesh is not None
                    and n % STOP_POLL_TICKS == 0):
                self.stop_at_tick = mesh.agreed_stop()
            if (self.stop_at_tick is not None
                    and self.clock.tick >= self.stop_at_tick):
                self._end_lockstep(RuntimeError(
                    "the mesh stopped at its agreed final tick"))
                return
            n += 1
            delay = t0 + n * period - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            windows = []
            for _ in range(stack):
                try:
                    windows.append(self._take_window())
                except Exception:  # the tick loop must not die
                    log.exception("taking a lockstep window failed")
                    windows.append([])
            try:
                now = self.clock.next_now()
                drain_fut = None
                if self.pipeline is not None:
                    drain_fut = self.pipeline.lockstep_pump(now, stack)
                await self._run_lockstep_window(windows, now)
                if drain_fut is not None:
                    await drain_fut
                if (self.snapshot_every and self.on_tick_snapshot is not None
                        and self.clock.tick % self.snapshot_every == 0):
                    await self.on_tick_snapshot(now)
            except Exception:
                # this rank can no longer keep its collective sequence:
                # stop ticking and fail what is queued, never diverge
                log.exception("lockstep dispatch failed; leaving the mesh")
                self._end_lockstep(RuntimeError(
                    "lockstep dispatch failed; this host left the mesh"))
                raise

    def _end_lockstep(self, err: Exception) -> None:
        """The tick loop is over (the agreed stop, or a fail-stop): later
        submits raise `err`, and everything queued fails with it."""
        self._ended = err
        if self.pipeline is not None:
            self.pipeline.close()
        for _, _, fut in self._pending:
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()

    async def stop_lockstep(self, timeout: Optional[float] = None) -> int:
        """End the tick loop at a final tick every rank agrees on
        (Mesh.propose_stop: this rank's tick + STOP_MARGIN_TICKS, unless
        another rank proposed first), and wait for it; returns the tick.
        The other ranks' loops read it and stop there too."""
        mesh = self.engine.mesh
        want = self.clock.tick + STOP_MARGIN_TICKS
        tick = want if mesh is None else mesh.propose_stop(want)
        self.stop_at_tick = tick
        if self._tick_task is not None:
            await asyncio.wait_for(asyncio.shield(self._tick_task), timeout)
        return tick

    def _take_window(self) -> List[tuple]:
        """One window of valid queued requests (JAX batcher.py:246): a
        request this rank cannot serve fails alone here, since a staging
        error later would skip the rank's dispatch for the tick."""
        if not self._pending:
            return []
        ok = []
        for item in self._pending:
            err = self.engine.routing_error(item[0])
            if err is None:
                ok.append(item)
            elif not item[2].done():
                item[2].set_exception(ValueError(err))
        if self.qos is not None and self.qos.fair_slotting:
            ok = interleave_by_tenant(ok, lambda t: tenant_of(t[0]))
        fit = self.engine.max_window_prefix([w[0] for w in ok])
        if self.qos is not None:
            fit = min(fit, self._window_limit())
        window, self._pending = ok[:fit], ok[fit:]
        return window

    async def _run_lockstep_window(self, windows: List[List[tuple]],
                                   now: int) -> None:
        """The tick's stacked step (JAX batcher.py:269): one engine.step,
        or one step_stacked at lockstep_stack windows, empty or not.  A
        step that raises before it issued an all-reduce is replaced by the
        empty step, so the other ranks' collectives pair up (three tries,
        then fail-stop); one that raises after it fail-stops.  Either way
        the GLOBAL scratch is cleared."""
        stacked = self.behaviors.lockstep_stack > 1
        loop = asyncio.get_running_loop()
        start = time.monotonic()
        n_reqs = sum(len(w) for w in windows)
        before = None

        def run():
            nonlocal before
            if FAULTS.enabled:
                FAULTS.on_sync(SEAM_ENGINE_DISPATCH, "lockstep")
            before = self.engine.collectives_issued()
            try:
                if stacked:
                    resps = self.engine.step_stacked(
                        [[t[0] for t in w] for w in windows], now,
                        [[t[1] for t in w] for w in windows],
                        k_stack=self.behaviors.lockstep_stack)
                else:
                    w = windows[0]
                    resps = [self.engine.step([t[0] for t in w], now,
                                              [t[1] for t in w])]
            except Exception:
                self.engine.clear_global_scratch()
                raise
            self._tier_maintain(now)
            return resps

        def run_empty():
            if stacked:
                return self.engine.step_stacked(
                    [[]], now, k_stack=self.behaviors.lockstep_stack)
            return self.engine.step([], now)

        def run_profiled():
            # the armed capture wraps the tick's step as it wraps a drain
            prof = self.profile
            profiling = prof.armed
            if profiling:
                prof.before_drain()
            try:
                return run()
            finally:
                if profiling:
                    prof.after_drain()

        try:
            resps = await loop.run_in_executor(self._executor, run_profiled)
        except Exception as e:
            for w in windows:
                for _, _, fut in w:
                    if not fut.done():
                        fut.set_exception(e)
            if (before is not None
                    and self.engine.collectives_issued() != before):
                # this tick's all-reduce already ran: fail-stop
                raise
            for attempt in range(3):
                try:
                    await loop.run_in_executor(self._executor, run_empty)
                    break
                except Exception:
                    if attempt == 2:
                        raise
                    await asyncio.sleep(0.05)
            return
        if self.qos is not None and n_reqs:
            self.qos.congestion.observe_drain(time.monotonic() - start,
                                              depth=len(windows))
        if self.metrics is not None and n_reqs:
            wall = time.monotonic() - start
            self.metrics.window_count.inc()
            self.metrics.window_occupancy.observe(n_reqs)
            self.metrics.window_duration.observe(wall)
            self.metrics.observe_stage("device_dispatch", wall)
        for w, rs in zip(windows, resps):
            for (_, _, fut), resp in zip(w, rs):
                if not fut.done():
                    fut.set_result(resp)

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
        self._closed = True
        if self.pipeline is not None:
            self.pipeline.close()
        if self._interval is not None:
            self._interval.stop()
        if self._tick_task is not None:
            self._tick_task.cancel()
        self._executor.shutdown(wait=False)
