"""Admission controller: bounded pending queue + deadline-aware shedding.

The batched serving lane (core/batcher.py `submit`) holds one admission
slot per pending decision from submit until its future resolves.  Two
shed conditions, both decided BEFORE the request queues:

  * queue_full — admitting would push the pending count past
    `max_pending`.  The bound is what prevents congestion collapse: under
    sustained overload the queue stays a couple of drain cycles deep and
    every admitted request still completes at full goodput, instead of
    every request queueing for seconds and timing out.
  * deadline — the caller's propagated deadline (gRPC deadline / HTTP
    timeout header) cannot be met even if admitted: estimated wait is
    `(pending / cwnd + 1)` drain cycles at the congestion controller's
    EWMA cycle time.  Rejecting now turns a guaranteed client-side
    timeout into an immediate, attributable answer.

Sheds are IN-BAND: an OVER_LIMIT-style RateLimitResp with
`metadata["shed_reason"]`, mirroring the reference's graceful-degradation
requirement for distributed limiters (arxiv 2602.11741) — a limiter that
errors under overload just moves the outage one layer up.

Every shed is also SLO evidence: the controller feeds the SLO engine set
in `slo`, with or without a metrics registry (which only counts sheds).
"""

from __future__ import annotations

import time
from typing import Optional

from gubernator_tpu_torch.api.types import RateLimitReq, RateLimitResp, Status

# canonical shed_reason values (tests and dashboards match on these)
SHED_QUEUE_FULL = "queue_full"
SHED_DEADLINE = "deadline"
SHED_BREAKER_OPEN = "breaker_open"
SHED_DRAINING = "draining"
# frontdoor-only (frontdoor.py): every slab of the worker's shm ring is
# in flight, so the worker sheds in-band without a cross-process
# round-trip — the CONCUR-style frontend/backend coupling signal.
SHED_RING_FULL = "ring_full"


def shed_response(req: RateLimitReq, reason: str) -> RateLimitResp:
    """In-band shed: OVER_LIMIT-shaped so naive clients back off, with
    metadata telling honest ones this was load shedding, not their
    configured limit ("shed": marker, "shed_reason": why)."""
    return RateLimitResp(
        status=Status.OVER_LIMIT,
        limit=req.limit,
        remaining=0,
        reset_time=0,
        metadata={"shed": "true", "shed_reason": reason},
    )


class AdmissionController:
    def __init__(self, conf, congestion, metrics=None, now_fn=time.monotonic):
        self.max_pending = conf.max_pending
        self.congestion = congestion
        self.metrics = metrics
        # SLOEngine fed each shed (Instance sets it when SLOs are on)
        self.slo = None
        self.now_fn = now_fn
        self.pending = 0
        self.pending_peak = 0
        # Windows currently in flight through the overlapped drain
        # pipeline (host-encoded or dispatched, not yet committed) —
        # updated by core/pipeline.py at every in-flight transition.
        self.inflight_windows = 0
        self.shed_counts: dict = {}
        # Set during graceful departure (daemon.py stop()): new work is
        # shed in-band with reason `draining` while already-admitted
        # decisions keep their slots and drain normally.
        self.draining = False

    # ----------------------------------------------------------- accounting

    def try_admit(self, n: int = 1,
                  deadline: Optional[float] = None) -> Optional[str]:
        """Admit `n` decisions or return the shed reason.  On admission the
        caller OWNS the slots and must `release(n)` when the decisions
        resolve (success or failure)."""
        if self.draining:
            return self._shed(SHED_DRAINING, n)
        if self.max_pending > 0 and self.pending + n > self.max_pending:
            return self._shed(SHED_QUEUE_FULL, n)
        if deadline is not None:
            remaining = deadline - self.now_fn()
            if remaining <= 0 or self.estimate_wait() > remaining:
                return self._shed(SHED_DEADLINE, n)
        self.pending += n
        if self.pending > self.pending_peak:
            self.pending_peak = self.pending
        return None

    def release(self, n: int = 1) -> None:
        self.pending -= n
        if self.pending < 0:  # defensive: never let accounting go negative
            self.pending = 0

    def note_inflight(self, windows: int) -> None:
        """Pipeline depth signal: how many drain windows are currently in
        flight.  Folded into the wait estimate — work ahead of a new
        request includes windows already encoded/dispatched, not just the
        pending queue."""
        self.inflight_windows = max(0, int(windows))

    # ----------------------------------------------------------- estimates

    def estimate_wait(self) -> float:
        """Queue-theoretic wait bound: cycles to drain what's ahead plus
        the request's own drain, at the congestion EWMA cycle time."""
        cw = max(self.congestion.effective_window(), 1)
        cycles = self.pending / cw + 1.0 + self.inflight_windows
        return cycles * self.congestion.drain_cycle_estimate()

    @property
    def saturated(self) -> bool:
        """The bounded queue is at (or past) its cap — health checks
        report degraded, and the server bypasses the native RPC lane so
        per-item sheds carry their reason in-band."""
        return self.max_pending > 0 and self.pending >= self.max_pending

    def close_intake(self) -> None:
        """Graceful-departure phase 1: stop admitting, keep draining."""
        self.draining = True

    def open_intake(self) -> None:
        self.draining = False

    def record_shed(self, reason: str, n: int = 1) -> str:
        """Account a shed decided OUTSIDE try_admit (e.g. fail-closed
        forwards while a peer's breaker is open, core/service.py)."""
        return self._shed(reason, n)

    def _shed(self, reason: str, n: int) -> str:
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + n
        if self.metrics is not None:
            self.metrics.observe_shed(reason, n)
        if self.slo is not None:
            self.slo.observe_shed(n)
        return reason
