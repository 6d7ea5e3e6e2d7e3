"""AIMD congestion controller over observed drain latency.

Replaces the static `batch_limit=1000` cliff with a congestion window
(`cwnd`, in DECISIONS per dispatch) adapted the way TCP adapts to RTT
inflation — the CONCUR structure (arxiv 2601.22705) specialized to the
one-engine-thread drain: the observed signal is the wall time of a whole
drain cycle (dispatch + fetch), the EWMA of which inflates as soon as the
device or the fetch link saturates.

  * below target latency: additive increase (`cwnd += increase`) per
    observation — probe for more batching, which on this hardware is
    nearly free until the transfer link saturates;
  * above target latency: multiplicative decrease (`cwnd *= decrease`),
    at most once per cooldown window (one "RTT": the larger of the EWMA
    and the target), so a burst of stale in-flight drains completing
    late doesn't collapse the window to the floor in one tick.

The controller never gates correctness — it only decides how much pending
work each dispatch takes (core/batcher.py window fill, core/pipeline.py
per-drain budget and in-flight depth) and feeds the admission
controller's wait estimate.
"""

from __future__ import annotations

import time


class CongestionController:
    def __init__(self, conf, now_fn=time.monotonic):
        self.min_window = conf.min_window
        self.max_window = conf.max_window
        self.target_latency = conf.target_drain_latency
        self.increase = conf.aimd_increase
        self.decrease = conf.aimd_decrease
        self.alpha = conf.latency_ewma_alpha
        self.now_fn = now_fn
        self._cwnd = float(conf.max_window)
        self.latency_ewma = 0.0
        self.depth_ewma = 0.0
        self._observed = False
        self._last_decrease = float("-inf")
        # telemetry for tests/metrics
        self.decreases = 0
        self.increases = 0
        # stage-boundary EWMAs (overlapped pipeline): host encode, device
        # dispatch, fetch+decode — fed per drain by the pipeline's
        # completion path.  When drains overlap, the cycle cadence is the
        # BOTTLENECK stage, not the stage sum.
        self.stage_ewma = {"host_encode": 0.0, "device_dispatch": 0.0,
                           "fetch_decode": 0.0}
        self._stages_observed = False
        self._pipelined = False
        # deferred-fetch chain stride (core/pipeline.py): how many drains
        # ride one stacked D2H fetch.  Same AIMD shape as cwnd but a
        # SEPARATE state variable: stride trades per-drain latency for
        # fetch amortization, so it grows only while backlog is deep AND
        # latency still holds, and collapses toward 1 the moment either
        # signal flips.
        self._stride = 1.0
        self.stride_increases = 0
        self.stride_decreases = 0

    # ------------------------------------------------------------- signal

    def observe_drain(self, wall_seconds: float, depth: int = 1) -> None:
        """Feed one completed drain cycle (engine dispatch through fetch).
        `depth` is the occupied window depth K of the drain (EWMA'd for
        the metrics surface and the wait estimator).

        `wall_seconds` is the pipeline's traced drain boundary
        (started→fetch_done, core/pipeline.py _on_completed) — the SAME
        value observed into guber_tpu_window_duration_* and the stage
        timeline, so the controller and the dashboards read one clock."""
        a = self.alpha
        if not self._observed:
            self.latency_ewma = wall_seconds
            self.depth_ewma = float(depth)
            self._observed = True
        else:
            self.latency_ewma += a * (wall_seconds - self.latency_ewma)
            self.depth_ewma += a * (depth - self.depth_ewma)
        if self.latency_ewma > self.target_latency:
            now = self.now_fn()
            cooldown = max(self.latency_ewma, self.target_latency)
            if now - self._last_decrease >= cooldown:
                self._cwnd = max(float(self.min_window),
                                 self._cwnd * self.decrease)
                self._last_decrease = now
                self.decreases += 1
        else:
            if self._cwnd < self.max_window:
                self._cwnd = min(float(self.max_window),
                                 self._cwnd + self.increase)
                self.increases += 1

    def observe_stages(self, host: float, device: float, fetch: float,
                       pipelined: bool = True) -> None:
        """Feed one drain's stage-boundary decomposition: host encode
        (columnar pack), device dispatch (enqueue through device done) and
        fetch+decode.  With overlap enabled the steady-state cadence is
        bounded by max(stage), not the sum — drain_cycle_estimate()
        switches to that bound once stage data exists."""
        a = self.alpha
        obs = {"host_encode": host, "device_dispatch": device,
               "fetch_decode": fetch}
        if not self._stages_observed:
            self.stage_ewma.update(obs)
            self._stages_observed = True
        else:
            for k, v in obs.items():
                self.stage_ewma[k] += a * (v - self.stage_ewma[k])
        self._pipelined = bool(pipelined)

    def observe_chain(self, backlog_windows: float, cap: int) -> None:
        """Adapt the deferred-fetch stride from one chain flush: additive
        increase while at least one more window's worth of work is queued
        behind the chain and drain latency holds under target; otherwise
        multiplicative decrease toward 1 (fetch every drain — no added
        latency under light load).  `cap` is the pipeline's configured
        GUBER_FETCH_STRIDE_MAX ceiling."""
        if backlog_windows >= 1.0 and not self.congested:
            if self._stride < cap:
                # unit additive step (NOT aimd_increase, which is sized in
                # decisions-per-window units): stride is a small integer,
                # so probing one extra chained drain per flush is the
                # gentlest useful growth
                self._stride = min(float(cap), self._stride + 1.0)
                self.stride_increases += 1
        elif self._stride > 1.0:
            self._stride = max(1.0, self._stride * self.decrease)
            self.stride_decreases += 1

    # ------------------------------------------------------------- policy

    def effective_window(self) -> int:
        """Decisions one dispatch should take (window fill / drain budget)."""
        return max(self.min_window, int(self._cwnd))

    def effective_depth(self, max_depth: int) -> int:
        """In-flight drain cap scaled with the congestion window: at full
        cwnd the pipeline keeps its configured depth; as AIMD backs off,
        fewer drains ride concurrently (dispatch cadence slows with the
        same control signal)."""
        if self.max_window <= 0:
            return max_depth
        frac = self._cwnd / float(self.max_window)
        return max(1, min(max_depth, round(max_depth * frac)))

    def effective_stride(self) -> int:
        """Drains per stacked fetch the chain should currently target."""
        return max(1, int(self._stride))

    def stride_bound(self, latency_budget: float) -> int:
        """Admission-deadline cap on the chain depth: the oldest chained
        drain waits ~(stride-1) dispatch cadences plus the shared fetch
        before it commits, so the deepest stride whose head still meets
        `latency_budget` (seconds) is (budget - t_fetch) / t_exec at the
        observed stage EWMAs.  Unbounded (a huge int) while the budget is
        unset or the stages are unobserved — a fresh node has no evidence
        to cap on, and the configured GUBER_FETCH_STRIDE_MAX still rules."""
        if latency_budget <= 0 or not self._stages_observed:
            return 1 << 30
        exec_s = max(self.stage_ewma["device_dispatch"], 1e-6)
        fetch_s = self.stage_ewma["fetch_decode"]
        return max(1, int((latency_budget - fetch_s) / exec_s))

    def drain_cycle_estimate(self) -> float:
        """Expected wall time of one drain cycle, for the admission wait
        estimator.  Before any observation the target is the prior — a
        fresh node must not promise instant service to a 1ms deadline."""
        if not self._observed:
            return self.target_latency
        if self._pipelined and self._stages_observed:
            # Overlapped drains: cycles complete at the bottleneck stage's
            # cadence (BASELINE.md cost model — bound is max, not sum).
            return max(max(self.stage_ewma.values()), 1e-6)
        return max(self.latency_ewma, 1e-6)

    @property
    def congested(self) -> bool:
        return self._observed and self.latency_ewma > self.target_latency
