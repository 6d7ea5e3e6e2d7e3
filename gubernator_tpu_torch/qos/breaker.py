"""Per-peer circuit breaker + jittered exponential backoff schedule.

The classic three-state machine guarding the cross-host forward lane
(net/peers.py):

  closed    — normal serving; `fail_threshold` CONSECUTIVE transport
              failures trip it open (a success resets the streak);
  open      — every call rejected locally for `open_duration` seconds
              (no connection attempt: a dead peer must not cost every
              forward a full timeout);
  half_open — after the open window, at most `half_open_probes`
              outstanding trial calls are let through; one success closes
              the breaker, one failure re-opens it for a fresh window.

The clock is injectable so tests drive open->half_open->closed without
sleeping.  What happens to traffic while the breaker is open (fail-open:
answer locally, non-authoritative; fail-closed: in-band shed) is the
service's decision (core/service.py), not the breaker's.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterator, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(self, fail_threshold: int = 5, open_duration: float = 2.0,
                 half_open_probes: int = 1, now_fn=time.monotonic,
                 on_state_change: Optional[Callable[[str], None]] = None):
        self.fail_threshold = max(1, fail_threshold)
        self.open_duration = open_duration
        self.half_open_probes = max(1, half_open_probes)
        self.now_fn = now_fn
        self.on_state_change = on_state_change
        self.state = CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0

    def _set_state(self, state: str) -> None:
        if state != self.state:
            self.state = state
            if self.on_state_change is not None:
                self.on_state_change(state)

    # ------------------------------------------------------------- gate

    def allow(self) -> bool:
        """May a call proceed right now?  A True from the half-open state
        consumes a probe slot — the caller MUST follow up with
        record_success() or record_failure()."""
        if self.state == OPEN:
            if self.now_fn() - self._opened_at >= self.open_duration:
                self._set_state(HALF_OPEN)
                self._probes_in_flight = 0
            else:
                return False
        if self.state == HALF_OPEN:
            if self._probes_in_flight >= self.half_open_probes:
                return False
            self._probes_in_flight += 1
            return True
        return True

    # ------------------------------------------------------------- outcomes

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            self._probes_in_flight = max(0, self._probes_in_flight - 1)
            self._set_state(CLOSED)
        self._failures = 0

    def record_failure(self) -> None:
        if self.state == HALF_OPEN:
            self._probes_in_flight = max(0, self._probes_in_flight - 1)
            self._trip()
            return
        self._failures += 1
        if self.state == CLOSED and self._failures >= self.fail_threshold:
            self._trip()

    def _trip(self) -> None:
        self._opened_at = self.now_fn()
        self._failures = 0
        self._set_state(OPEN)

    # ------------------------------------------------- external authority

    def trip(self) -> None:
        """Force-open: the failure detector (net/health.py) confirmed this
        peer DOWN out-of-band, so stop burning forward-latency on probes
        the detector already knows will fail.  The normal open→half_open
        clockwork still applies, so the breaker recovers on its own even
        if the detector is later disabled."""
        self._trip()

    def reset(self) -> None:
        """Force-closed: the detector confirmed the peer healthy again
        (its recover_after hysteresis already debounced flapping)."""
        self._failures = 0
        self._probes_in_flight = 0
        self._set_state(CLOSED)


def backoff_delays(retries: int, base: float, cap: float,
                   rng: Optional[random.Random] = None) -> Iterator[float]:
    """Jittered exponential backoff: delay i is uniform in
    (0, min(cap, base * 2**i)] — full jitter, the variant that
    decorrelates a herd of retriers hitting the same recovering peer."""
    r = rng.random if rng is not None else random.random
    for i in range(retries):
        yield min(cap, base * (2.0 ** i)) * max(r(), 1e-3)
