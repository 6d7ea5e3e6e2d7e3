"""Request-lifecycle tracing: a lightweight span recorder.

A copy of `gubernator_tpu/observability/tracing.py` (JAX-free), with its
one config import pointed at the port's.  The port wires the peer plane's
spans so far: the servers' roots (`rpc`, `peer_rpc`, `http`), the
`peer_forward` hop and the `global_broadcast` root; the pipeline's
drain-stage spans and the `/v1/admin/debug` reader wait for ROADMAP item
7.

No OpenTelemetry dependency — the serving path needs span *recording* to
cost nanoseconds when sampling is off, and the otel SDK's context plumbing
is orders of magnitude heavier than this hot path can afford.  What this
module keeps from the otel model is the wire contract, so real tracing
backends can still consume us:

  * trace context propagates as a W3C `traceparent`
    (`00-<32hex trace>-<16hex span>-<2hex flags>`) — over HTTP as the
    header of the same name (api/http_gateway.py) and over the gRPC peer
    lane as invocation metadata (net/peers.py -> server.py), so a
    forwarded (non-owner) request yields ONE stitched trace whose spans
    cover the client hop, the peer forward, and the owner-side drain;
  * optional OTLP/HTTP JSON export behind `GUBER_TRACE_EXPORT` (an
    endpoint like http://collector:4318/v1/traces), hand-rolled with
    urllib on a background thread — export failures degrade to a
    once-per-endpoint warning, never to request latency.

Sampling (`GUBER_TRACE_SAMPLE`, 0.0-1.0) is decided ONCE at the root span
per request; everything downstream keys off the SpanContext being None
(not sampled) or not, so the disabled path is a single attribute check.

Spans land in a bounded ring (deque) read by the `/v1/admin/debug`
endpoint and tests; the recorder never allocates when tracing is off.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import queue
import random
import threading
import time
import urllib.request
from contextvars import ContextVar
from typing import Dict, List, Optional

log = logging.getLogger("gubernator.tracing")

TRACEPARENT = "traceparent"

# the ambient trace context for the current async task / thread;
# None = this request is not sampled (or tracing is off entirely)
_current: ContextVar[Optional["SpanContext"]] = ContextVar(
    "guber_trace_ctx", default=None)


def current_context() -> Optional["SpanContext"]:
    """The sampled SpanContext of the request being served, or None."""
    return _current.get()


class SpanContext:
    """Identity of one *sampled* request's position in its trace.  Only
    ever constructed for sampled requests — `ctx is None` IS the not-
    sampled fast path, so no `sampled` flag exists."""

    __slots__ = ("trace_id", "span_id", "enqueued_at")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id
        # stamped by the batcher/pipeline submit path so the drain can
        # record this request's enqueue span without a side table
        self.enqueued_at: float = 0.0

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[SpanContext]:
    """Parse an incoming W3C traceparent; None on anything malformed (a
    bad header must never fail the request, it just starts a new trace).
    An unsampled flag (…-00) returns None: the caller decided not to
    trace, and we honor it."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    try:
        int(parts[1], 16), int(parts[2], 16)
        flags = int(parts[3], 16)
    except ValueError:
        return None
    if not flags & 0x01:
        return None
    return SpanContext(parts[1], parts[2])


class Span:
    """One finished-or-open span.  Mutable `end` so the context-manager
    form stays allocation-light; recorded into the tracer ring on exit."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "wall_start", "node", "attrs")

    def __init__(self, name: str, ctx: SpanContext, parent_id: str,
                 node: str, start: float, wall_start: float):
        self.name = name
        self.trace_id = ctx.trace_id
        self.span_id = ctx.span_id
        self.parent_id = parent_id
        self.start = start          # monotonic seconds
        self.end = 0.0
        self.wall_start = wall_start  # epoch seconds (export timestamps)
        self.node = node
        self.attrs: Optional[Dict[str, str]] = None

    @property
    def duration(self) -> float:
        return max(0.0, self.end - self.start)

    def set_attr(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = str(value)

    def to_dict(self) -> dict:
        d = {"name": self.name, "trace_id": self.trace_id,
             "span_id": self.span_id, "parent_id": self.parent_id,
             "node": self.node, "duration_ms": self.duration * 1000.0,
             "start": self.wall_start}
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class _NoopSpan:
    """Shared do-nothing span for the unsampled path: every method is a
    no-op and the context manager restores nothing."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key, value):
        pass

    def finish(self):
        pass


NOOP_SPAN = _NoopSpan()


class _ActiveSpan:
    """Context-manager wrapper that installs its ctx as current and
    records itself into the tracer ring on exit."""

    __slots__ = ("span", "ctx", "_tracer", "_token")

    def __init__(self, tracer: "Tracer", span: Span, ctx: SpanContext):
        self.span = span
        self.ctx = ctx
        self._tracer = tracer
        self._token = None

    def set_attr(self, key, value):
        self.span.set_attr(key, value)

    def __enter__(self):
        self._token = _current.set(self.ctx)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self.finish()
        return False

    def finish(self):
        if self.span.end == 0.0:
            self.span.end = self._tracer.now_fn()
            self._tracer.record(self.span)


def _ids(n_bytes: int) -> str:
    return "%0*x" % (n_bytes * 2, random.getrandbits(n_bytes * 8))


class Tracer:
    """Per-instance span recorder (instances in one process each get their
    own, like Metrics; `get_tracer()` hands out the process default).

    `sample`: probability a root request starts a trace (0 disables).
    Tests flip `tracer.sample = 1.0` after boot — sampling is re-read per
    request."""

    def __init__(self, sample: Optional[float] = None,
                 export: Optional[str] = None,
                 node: str = "", max_spans: int = 2048,
                 now_fn=time.monotonic):
        from gubernator_tpu_torch.config import env_float
        self.sample = (env_float("GUBER_TRACE_SAMPLE", 0.0)
                       if sample is None else float(sample))
        self.sample = min(1.0, self.sample)
        self.node = node
        self.now_fn = now_fn
        self._spans: collections.deque = collections.deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._exporter: Optional[_OtlpExporter] = None
        endpoint = (os.environ.get("GUBER_TRACE_EXPORT", "")
                    if export is None else export)
        if endpoint:
            self._exporter = _OtlpExporter(endpoint)

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0

    # ------------------------------------------------------------ span API

    def start_trace(self, name: str, traceparent: Optional[str] = None):
        """Root span for one inbound request.  An incoming traceparent
        continues the caller's trace (every propagated request is
        sampled — the upstream node already paid the sampling dice roll);
        otherwise sample locally.  Returns NOOP_SPAN when not sampled."""
        ctx = parse_traceparent(traceparent)
        if ctx is None:
            if not (self.sample > 0.0 and random.random() < self.sample):
                return NOOP_SPAN
            ctx = SpanContext(_ids(16), _ids(8))
            parent = ""
        else:
            # the incoming span id is our parent; we become a fresh span
            parent = ctx.span_id
            ctx = SpanContext(ctx.trace_id, _ids(8))
        span = Span(name, ctx, parent, self.node, self.now_fn(), time.time())
        return _ActiveSpan(self, span, ctx)

    def span(self, name: str, ctx: Optional[SpanContext] = None):
        """Child span under `ctx` (or the ambient current context).
        Returns NOOP_SPAN when the request is unsampled — the disabled
        hot path is one ContextVar read and a None check."""
        parent = ctx if ctx is not None else _current.get()
        if parent is None:
            return NOOP_SPAN
        child = SpanContext(parent.trace_id, _ids(8))
        span = Span(name, child, parent.span_id, self.node, self.now_fn(),
                    time.time())
        return _ActiveSpan(self, span, child)

    def record_span(self, ctx: Optional[SpanContext], name: str,
                    start: float, end: float, parent: bool = True,
                    attrs: Optional[dict] = None) -> None:
        """Record a completed span with explicit monotonic timestamps —
        the form the drain uses for stage spans measured on the engine
        thread (the span's lifetime doesn't nest in any `with` block)."""
        if ctx is None:
            return
        child = SpanContext(ctx.trace_id, _ids(8))
        span = Span(name, child, ctx.span_id if parent else "", self.node,
                    start, time.time() - (self.now_fn() - start))
        span.end = end
        if attrs:
            for k, v in attrs.items():
                span.set_attr(k, v)
        self.record(span)

    def record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)
        if self._exporter is not None:
            self._exporter.offer(span)

    # ----------------------------------------------------------- inspection

    def spans(self, trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def recent_traces(self, limit: int = 10) -> List[dict]:
        """Newest-first trace summaries for the debug endpoint: span
        count, total wall, and the slowest stage of each trace."""
        with self._lock:
            spans = list(self._spans)
        by_trace: Dict[str, List[Span]] = {}
        order: List[str] = []
        for s in spans:
            if s.trace_id not in by_trace:
                by_trace[s.trace_id] = []
                order.append(s.trace_id)
            by_trace[s.trace_id].append(s)
        out = []
        for tid in reversed(order[-limit:]):
            group = by_trace[tid]
            slowest = max(group, key=lambda s: s.duration)
            roots = [s for s in group if not s.parent_id]
            out.append({
                "trace_id": tid,
                "spans": len(group),
                "root": roots[0].name if roots else group[0].name,
                "duration_ms": (max(s.end for s in group)
                                - min(s.start for s in group)) * 1000.0,
                "slowest_span": slowest.name,
                "slowest_ms": slowest.duration * 1000.0,
                "nodes": sorted({s.node for s in group if s.node}),
            })
        return out

    def close(self) -> None:
        if self._exporter is not None:
            self._exporter.close()


class _OtlpExporter:
    """Best-effort OTLP/HTTP JSON shipper on one daemon thread.  The
    serving path only ever pays a non-blocking queue put; a full queue
    drops spans (observability must shed before it backpressures)."""

    def __init__(self, endpoint: str, flush_interval: float = 1.0):
        self.endpoint = endpoint
        self.flush_interval = flush_interval
        self._q: "queue.Queue[Optional[Span]]" = queue.Queue(maxsize=8192)
        self._warned = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="guber-trace-export")
        self._thread.start()

    def offer(self, span: Span) -> None:
        try:
            self._q.put_nowait(span)
        except queue.Full:
            pass

    def _run(self) -> None:
        batch: List[Span] = []
        while True:
            try:
                item = self._q.get(timeout=self.flush_interval)
            except queue.Empty:
                item = None
            if item is not None:
                batch.append(item)
                if len(batch) < 512:
                    continue
            if batch:
                self._ship(batch)
                batch = []

    def _ship(self, batch: List[Span]) -> None:
        # epoch-ns timestamps from the span's wall_start + duration
        def ns(t: float) -> str:
            return str(int(t * 1e9))

        body = json.dumps({"resourceSpans": [{
            "resource": {"attributes": [{
                "key": "service.name",
                "value": {"stringValue": "gubernator-tpu"}}]},
            "scopeSpans": [{
                "scope": {"name": "gubernator_tpu_torch.observability.tracing"},
                "spans": [{
                    "traceId": s.trace_id,
                    "spanId": s.span_id,
                    **({"parentSpanId": s.parent_id} if s.parent_id else {}),
                    "name": s.name,
                    "kind": 1,
                    "startTimeUnixNano": ns(s.wall_start),
                    "endTimeUnixNano": ns(s.wall_start + s.duration),
                    "attributes": [
                        {"key": k, "value": {"stringValue": v}}
                        for k, v in ({"node": s.node} | (s.attrs or {})).items()
                        if v],
                } for s in batch],
            }],
        }]}).encode("utf-8")
        req = urllib.request.Request(
            self.endpoint, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=5.0).close()
        except Exception as e:
            if not self._warned:
                self._warned = True
                log.warning("OTLP export to %s failed (%s); further "
                            "failures are silent", self.endpoint, e)

    def close(self) -> None:
        pass  # daemon thread; nothing to join


_default_tracer: Optional[Tracer] = None
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-default tracer, configured from GUBER_TRACE_* env —
    what library embedders share when they don't inject their own."""
    global _default_tracer
    if _default_tracer is None:
        with _default_lock:
            if _default_tracer is None:
                _default_tracer = Tracer()
    return _default_tracer
