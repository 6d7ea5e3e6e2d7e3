"""QoS subsystem: admission control, congestion-adaptive windows, fair
slotting, and peer-lane circuit breaking.

The serving path this protects (core/batcher.py -> core/pipeline.py ->
device) has a fixed short-term capacity: one drain in flight per fetch
slot, each drain carrying at most K windows of S*B lanes.  Nothing in the
seed bounded what piles up BEHIND that capacity — `_pending` grew without
limit, a slow peer stalled forwards behind one static timeout, and a hot
tenant could fill every device lane.  This package is the control layer:

  * AdmissionController (admission.py): bounded pending queue with
    deadline-aware load shedding.  Requests that cannot be served before
    their propagated client deadline are rejected IMMEDIATELY with an
    in-band OVER_LIMIT-style response carrying `shed_reason` metadata,
    instead of timing out silently in the queue.
  * CongestionController (congestion.py): AIMD on the EWMA of observed
    drain wall time adapts the effective window size and pipeline
    dispatch budget — the CONCUR result (arxiv 2601.22705): congestion-
    based concurrency control beats a static batch cliff for batched
    accelerator serving.
  * fair slotting (fairness.py): device windows fill round-robin across
    `name` (tenant) groups rather than FIFO, so one hot tenant cannot
    starve the rest of the window.
  * CircuitBreaker (breaker.py): per-peer closed/open/half-open breaker
    + jittered exponential backoff used by net/peers.py, with a
    configurable fail-open (answer locally, non-authoritative, flagged
    in metadata) or fail-closed fallback while a breaker is open.

Everything takes an injectable monotonic clock so the lockstep-style
deterministic tests (tests/test_qos.py) drive state machines without
sleeping.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from gubernator_tpu_torch.config import QoSConfig
from gubernator_tpu_torch.qos.admission import AdmissionController, shed_response
from gubernator_tpu_torch.qos.breaker import CircuitBreaker
from gubernator_tpu_torch.qos.congestion import CongestionController
from gubernator_tpu_torch.qos.fairness import interleave_by_tenant

__all__ = [
    "AdmissionController",
    "CircuitBreaker",
    "CongestionController",
    "QoSManager",
    "interleave_by_tenant",
    "shed_response",
]


class QoSManager:
    """One QoS control plane per Instance: the congestion controller and
    admission controller are shared by the batcher and the pipeline (one
    pending-decision budget per node), and breakers are minted per peer
    as the membership ring changes (net/peers.py holds them)."""

    def __init__(self, conf: Optional[QoSConfig] = None, metrics=None,
                 now_fn=time.monotonic):
        self.conf = conf or QoSConfig()
        self.conf.validate()
        self.metrics = metrics
        self.now_fn = now_fn
        self.congestion = CongestionController(self.conf, now_fn=now_fn)
        self.admission = AdmissionController(self.conf, self.congestion,
                                             metrics=metrics, now_fn=now_fn)
        self.fair_slotting = self.conf.fair_slotting
        # per-host registry of the breakers minted below, so the failure
        # detector (net/health.py) can force-trip a confirmed-down peer's
        # breaker and force-close a recovered one (latest mint wins after
        # membership churn — the ring's live PeerClient holds that one)
        self.breakers: Dict[str, CircuitBreaker] = {}

    @property
    def fail_open(self) -> bool:
        return self.conf.fail_open

    def make_breaker(self, host: str) -> CircuitBreaker:
        """Per-peer breaker wired to the state gauge (metrics)."""
        on_change = None
        if self.metrics is not None:
            m = self.metrics
            on_change = lambda state, h=host: m.observe_breaker(h, state)  # noqa: E731
        breaker = CircuitBreaker(
            fail_threshold=self.conf.breaker_fail_threshold,
            open_duration=self.conf.breaker_open_duration,
            half_open_probes=self.conf.breaker_half_open_probes,
            now_fn=self.now_fn,
            on_state_change=on_change,
        )
        self.breakers[host] = breaker
        return breaker

    def deadline_from_timeout(self, timeout_s: Optional[float]
                              ) -> Optional[float]:
        """Absolute monotonic deadline from a relative client timeout,
        falling back to the configured default deadline (0 = none)."""
        if timeout_s is None or timeout_s <= 0 or timeout_s == float("inf"):
            if self.conf.default_deadline <= 0:
                return None
            timeout_s = self.conf.default_deadline
        return self.now_fn() + timeout_s
