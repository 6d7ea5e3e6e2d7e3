"""Cross-host peer client: one peer's connection and its batching window.

The port of `gubernator_tpu/net/peers.py`.  One PeerClient per remote
peer owns the BATCHING aggregation window (reference peers.go:35-207):
BATCHING and GLOBAL requests queue until batch_limit (1000) items or
batch_wait (500 us), then ship as one GetPeerRateLimits RPC whose
responses demux back by index; NO_BATCHING goes as an immediate
single-item RPC.  Every RPC attempt runs through the resilience layer
(`_call`): the peer's circuit breaker (qos/breaker.py), jittered-backoff
retries on transient failures, the `peer_rpc` fault seam (net/faults.py)
and typed PeerErrors out; a sampled trace context rides as `traceparent`
metadata (observability/tracing.py).

One departure: the module loads without grpcio or protobuf (the chip
machine has neither).  All socket I/O goes through one transport seam,
`_connect()`, which returns an object with the PeersV1 calls and the
tuple `errors` of the exception types its failed RPCs raise; by default
that is GrpcPeerTransport, built (and grpc and the stubs imported) on
first use.  A caller may pass its own transport (chip_smoke.py's
in-process loopback): the batching window, the retries, the breaker, the
fault seam and the trace metadata run above the seam either way.

`transfer_buckets` ships migrated bucket rows (state/migrate.py's bytes)
through the same layer, and `register_globals` /
`apply_global_registration` carry mesh GLOBAL registration (a rank to the
registrar, the registrar to every rank; core/service.py) as in the JAX
package (net/peers.py:247-268).
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from gubernator_tpu_torch.api.types import (
    Behavior,
    RateLimitReq,
    RateLimitResp,
)
from gubernator_tpu_torch.config import BehaviorConfig, QoSConfig
from gubernator_tpu_torch.core.interval import ArmedInterval
from gubernator_tpu_torch.net.faults import FAULTS, SEAM_PEER_RPC, FaultError
from gubernator_tpu_torch.observability.tracing import (
    TRACEPARENT,
    current_context,
)
from gubernator_tpu_torch.qos.breaker import CircuitBreaker, backoff_delays

log = logging.getLogger("gubernator.peers")

# transient transport conditions, by gRPC status name: retried with
# jittered backoff and counted against the breaker (everything else is the
# caller's problem)
_TRANSIENT = ("UNAVAILABLE", "DEADLINE_EXCEEDED")


def _status_code(name: str):
    """grpc.StatusCode.<name> where grpc is installed, else the name."""
    try:
        import grpc
    except ImportError:
        return name
    return getattr(grpc.StatusCode, name)


class PeerError(Exception):
    """Typed peer-lane failure with the peer host attached.

    Every transport failure on the forward lane (a failed RPC, an asyncio
    timeout, an injected fault) normalizes to this, so shed and fallback
    logic and tests match on a stable type.  `retryable` marks transient
    transport conditions (UNAVAILABLE / DEADLINE_EXCEEDED) that count
    against the peer's circuit breaker."""

    def __init__(self, host: str, message: str, code=None,
                 retryable: bool = False):
        self.host = host
        self.code = code
        self.retryable = retryable
        super().__init__(f"peer '{host}': {message}")


class BreakerOpenError(PeerError):
    """The peer's circuit breaker is open: the call was rejected locally
    without touching the network.  core/service.py turns this into the
    configured fail-open (local non-authoritative answer) or fail-closed
    (in-band shed) behavior."""

    def __init__(self, host: str):
        super().__init__(host, "circuit breaker open", retryable=False)


def _global_specs(specs: List[tuple]) -> list:
    """(key, limit, duration, algorithm) tuples as GlobalSpec messages."""
    from gubernator_tpu_torch.api import pb
    return [pb.GlobalSpec(key=k, limit=lim, duration=dur, algorithm=int(a))
            for (k, lim, dur, a) in specs]


class GrpcPeerTransport:
    """The PeersV1 calls over an insecure grpc.aio channel, like the
    reference (peers.go:132).  Importing grpc and the protobuf stubs
    happens here, at construction.  `options`: the channel's gRPC
    options."""

    def __init__(self, host: str, options=()):
        import grpc

        from gubernator_tpu_torch.api.grpc_api import PeersV1Stub
        self.errors = (grpc.RpcError,)
        self.channel = grpc.aio.insecure_channel(host, options=list(options))
        self.stub = PeersV1Stub(self.channel)
        self._raw_batch = self.channel.unary_unary(
            "/pb.gubernator.PeersV1/GetPeerRateLimits",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        self._raw_transfer = self.channel.unary_unary(
            "/pb.gubernator.PeersV1/TransferBuckets",
            request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        self._v1 = None

    async def get_peer_rate_limits(self, reqs: List[RateLimitReq],
                                   timeout: float,
                                   metadata=None) -> List[RateLimitResp]:
        from gubernator_tpu_torch.api import pb
        msg = pb.GetPeerRateLimitsReq(requests=[pb.req_to_pb(r)
                                                for r in reqs])
        resp = await self.stub.GetPeerRateLimits(msg, timeout=timeout,
                                                 metadata=metadata)
        return [pb.resp_from_pb(m) for m in resp.rate_limits]

    async def update_peer_globals(self, globals_: List,
                                  timeout: float) -> None:
        from gubernator_tpu_torch.api import pb
        msg = pb.UpdatePeerGlobalsReq(globals=[
            pb.UpdatePeerGlobal(
                key=g.key,
                status=pb.resp_to_pb(g.status),
                algorithm=int(g.algorithm),
                duration=g.duration,
            )
            for g in globals_
        ])
        await self.stub.UpdatePeerGlobals(msg, timeout=timeout)

    async def get_peer_rate_limits_raw(self, data: bytes,
                                       timeout: float) -> bytes:
        return await self._raw_batch(data, timeout=timeout)

    async def transfer_buckets(self, payload: bytes,
                               timeout: float) -> bytes:
        return await self._raw_transfer(payload, timeout=timeout)

    async def register_globals(self, specs: List[tuple],
                               timeout: float) -> None:
        from gubernator_tpu_torch.api import pb
        await self.stub.RegisterGlobals(
            pb.RegisterGlobalsReq(specs=_global_specs(specs)),
            timeout=timeout)

    async def apply_global_registration(self, specs: List[tuple], now: int,
                                        activate: bool,
                                        timeout: float) -> None:
        from gubernator_tpu_torch.api import pb
        await self.stub.ApplyGlobalRegistration(
            pb.ApplyGlobalRegistrationReq(specs=_global_specs(specs),
                                          now=now, activate=activate),
            timeout=timeout)

    async def health_check(self, timeout: float):
        from gubernator_tpu_torch.api import pb
        if self._v1 is None:
            from gubernator_tpu_torch.api.grpc_api import V1Stub
            self._v1 = V1Stub(self.channel)
        return await self._v1.HealthCheck(pb.HealthCheckReq(),
                                          timeout=timeout)

    async def close(self) -> None:
        await self.channel.close()


class PeerClient:
    def __init__(self, behaviors: BehaviorConfig, host: str, qos=None,
                 transport=None):
        """qos: the Instance's QoSManager, which supplies the breaker (with
        its clock and state-gauge hook) and the retry policy; None gets
        the default-config resilience (standalone embedding, tests).
        transport: the object `_connect()` returns (see the module
        docstring); None builds a GrpcPeerTransport on first use."""
        self.host = host
        self.conf = behaviors
        self.is_owner = False  # True when this entry names the local instance
        self._transport = transport
        self._pending: List[tuple] = []  # (req, future, trace ctx|None)
        self._interval: Optional[ArmedInterval] = None
        self._waiter: Optional[asyncio.Task] = None
        # ---- resilience (qos/breaker.py)
        self._qos = qos
        qconf = qos.conf if qos is not None else QoSConfig()
        self.retries = qconf.peer_retries
        self.retry_base = qconf.retry_base
        self.retry_cap = qconf.retry_cap
        self.breaker = (qos.make_breaker(host) if qos is not None
                        else CircuitBreaker(
                            fail_threshold=qconf.breaker_fail_threshold,
                            open_duration=qconf.breaker_open_duration,
                            half_open_probes=qconf.breaker_half_open_probes))
        self._sleep = asyncio.sleep  # injectable for deterministic tests

    def _connect(self):
        """The transport seam: every RPC of this client goes through the
        object returned here."""
        if self._transport is None:
            self._transport = GrpcPeerTransport(self.host)
        return self._transport

    # ------------------------------------------------------------ resilience

    @staticmethod
    def _normalize(host: str, e: Exception) -> PeerError:
        """Fold any transport failure into a typed PeerError."""
        if isinstance(e, PeerError):
            return e
        if isinstance(e, FaultError):
            # injected partition (net/faults.py): indistinguishable from a
            # dead peer by design
            return PeerError(host, str(e),
                             code=_status_code("UNAVAILABLE"),
                             retryable=True)
        if isinstance(e, (asyncio.TimeoutError, TimeoutError)):
            return PeerError(host, "request timed out",
                             code=_status_code("DEADLINE_EXCEEDED"),
                             retryable=True)
        code = None
        code_fn = getattr(e, "code", None)
        if callable(code_fn):
            try:
                code = code_fn()
            except Exception:
                code = None
        details_fn = getattr(e, "details", None)
        msg = None
        if callable(details_fn):
            try:
                msg = details_fn()
            except Exception:
                msg = None
        return PeerError(host, msg or str(e), code=code,
                         retryable=getattr(code, "name", code) in _TRANSIENT)

    async def _call(self, do):
        """Run one RPC attempt closure through the resilience layer:
        breaker gate -> attempt -> jittered-backoff retries on transient
        UNAVAILABLE-class failures -> typed PeerError out.  Success and
        (final) transient failure feed the breaker; non-transient errors
        (bad request, peer-side app errors) do not trip it."""
        if not self.breaker.allow():
            raise BreakerOpenError(self.host)
        transport = self._connect()
        caught = (*transport.errors, asyncio.TimeoutError, TimeoutError,
                  FaultError)
        delays = backoff_delays(self.retries, self.retry_base, self.retry_cap)
        attempt = 0
        while True:
            try:
                if FAULTS.enabled:
                    await FAULTS.on_async(SEAM_PEER_RPC, self.host)
                out = await do(transport)
            except caught as e:
                err = self._normalize(self.host, e)
                if err.retryable and attempt < self.retries:
                    attempt += 1
                    if (self._qos is not None
                            and self._qos.metrics is not None):
                        self._qos.metrics.observe_peer_retry(self.host)
                    await self._sleep(next(delays))
                    continue
                if err.retryable:
                    self.breaker.record_failure()
                else:
                    # the peer answered (with an application error): it is
                    # alive, which is what the breaker tracks
                    self.breaker.record_success()
                raise err from e
            self.breaker.record_success()
            return out

    async def health_check(self, timeout: float = 0.5):
        """One probe against this peer's V1 HealthCheck.  Outside the
        resilience layer: no retries and no breaker gate (an open breaker
        must never hide a peer that came back).  The peer_rpc fault seam
        still applies."""
        if FAULTS.enabled:
            await FAULTS.on_async(SEAM_PEER_RPC, self.host)
        return await self._connect().health_check(timeout)

    # ------------------------------------------------------------ forwarding

    async def get_peer_rate_limit(self, req: RateLimitReq) -> RateLimitResp:
        """Forward one request, batching per behavior (peers.go:73-91)."""
        if req.behavior in (Behavior.BATCHING, Behavior.GLOBAL):
            return await self._batched(req)
        resps = await self.get_peer_rate_limits([req])
        return resps[0]

    async def get_peer_rate_limits(self, reqs: List[RateLimitReq],
                                   ctx=None) -> List[RateLimitResp]:
        """One batch RPC; validates the response length (peers.go:93-105).

        `ctx` (or the ambient sampled SpanContext) rides the RPC as
        `traceparent` metadata so the owner's spans stitch into the
        caller's trace."""
        if ctx is None:
            ctx = current_context()
        md = ((TRACEPARENT, ctx.traceparent()),) if ctx is not None else None
        resps = await self._call(lambda t: t.get_peer_rate_limits(
            reqs, timeout=self.conf.batch_timeout, metadata=md))
        if len(resps) != len(reqs):
            raise RuntimeError(
                "number of rate limits in peer response does not match request")
        return resps

    async def update_peer_globals(self, globals_: List) -> None:
        """Push authoritative global statuses (peers.go:107-109)."""
        await self._call(lambda t: t.update_peer_globals(
            globals_, timeout=self.conf.global_timeout))

    async def get_peer_rate_limits_raw(self, data: bytes) -> bytes:
        """Bytes-level batch relay: the caller splices serialized
        RateLimitReq frames straight into the request and gets framed
        responses back, the whole forward path without a protobuf object
        (the pipeline's mixed-RPC flow)."""
        return await self._call(lambda t: t.get_peer_rate_limits_raw(
            data, timeout=self.conf.batch_timeout))

    async def transfer_buckets(self, payload: bytes) -> bytes:
        """Ship migrated bucket rows to this peer (state/migrate.py's wire
        payload) and return its ack bytes.  Bytes-level like the raw batch
        relay: the codec lives in one module, not in generated protos."""
        return await self._call(lambda t: t.transfer_buckets(
            payload, timeout=self.conf.batch_timeout))

    async def register_globals(self, specs: List[tuple]) -> None:
        """Send (key, limit, duration, algorithm) registrations to the mesh
        registrar (api/proto/peers.proto RegisterGlobals)."""
        await self._call(lambda t: t.register_globals(
            list(specs), timeout=self.conf.global_timeout))

    async def apply_global_registration(self, specs: List[tuple], now: int,
                                        activate: bool) -> None:
        """The registrar's fan-out of one registration phase to this
        rank."""
        await self._call(lambda t: t.apply_global_registration(
            list(specs), now, activate, timeout=self.conf.global_timeout))

    # -------------------------------------------------------------- batching

    async def _batched(self, req: RateLimitReq) -> RateLimitResp:
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        # capture the ambient trace context NOW: the flusher task that
        # ships the window has no ambient ctx of its own
        self._pending.append((req, fut, current_context()))
        if len(self._pending) >= self.conf.batch_limit:
            self._flush()
        elif len(self._pending) == 1:
            if self._interval is None:
                self._interval = ArmedInterval(self.conf.batch_wait)
            self._interval.arm()
            if self._waiter is None or self._waiter.done():
                self._waiter = asyncio.create_task(self._wait_interval())
        return await fut

    async def _wait_interval(self) -> None:
        await self._interval.wait()
        if self._pending:
            self._flush()

    def _flush(self) -> None:
        window = self._pending
        self._pending = []
        asyncio.create_task(self._send_window(window))

    async def _send_window(self, window: List[tuple]) -> None:
        reqs = [w[0] for w in window]
        # the window carries many requests but one RPC: propagate the first
        # sampled context (a shared-batch trace is stitched, not per-item)
        ctx = next((w[2] for w in window if w[2] is not None), None)
        try:
            resps = await self.get_peer_rate_limits(reqs, ctx=ctx)
        except Exception as e:
            # the whole batch failed; every waiter sees the error
            # (peers.go:189-196)
            for w in window:
                if not w[1].done():
                    w[1].set_exception(e)
            return
        for w, resp in zip(window, resps):
            if not w[1].done():
                w[1].set_result(resp)

    async def close(self) -> None:
        """Disconnect (the reference leaks old PeerClients on membership
        churn, gubernator.go:276 TODO; the port closes them)."""
        if self._interval is not None:
            self._interval.stop()
        if self._transport is not None:
            await self._transport.close()
