"""gRPC server hosting an Instance (V1 + PeersV1 services).

The port of `gubernator_tpu/server.py`.  The RPC bodies are the
module-level serve_* functions taking (instance, payload, context): bytes
in, response bytes out.  `context` needs only `time_remaining()` and an
`abort()` that raises, so the same bodies serve a grpc.aio context or any
other transport's.  This module imports neither grpc nor protobuf when it
is loaded: the bytes lane (an RPC of at least FASTPATH_MIN_BYTES that the
native parser takes) runs with neither installed, `grpc` is imported
inside GrpcServer and where an abort needs its status code, and protobuf
only on the protobuf path (RPCs under FASTPATH_MIN_BYTES, or ones the
parser refuses), which raises ImportError on a machine without it.

Ported: V1.GetRateLimits and HealthCheck, PeersV1.GetPeerRateLimits,
UpdatePeerGlobals (an owner's GLOBAL broadcast, `serve_update_peer_globals`)
and TransferBuckets (key migration, `serve_transfer_buckets`: raw bytes in,
raw bytes out).  Not registered yet, so a caller gets UNIMPLEMENTED:
RegisterGlobals and ApplyGlobalRegistration (mesh GLOBAL, ROADMAP item 8).  With the Instance's tracer sampling, GetRateLimits
roots an `rpc` span and GetPeerRateLimits a `peer_rpc` span, each
continuing the caller's `traceparent` invocation metadata (the peer lane
sends it, net/peers.py), so a forwarded request is one trace across the
two nodes.

The bodies serve the front door's records too (frontdoor.py): its
engine-side context shim has `time_remaining`, `invocation_metadata` and
an `abort` that takes integer status codes (`integer_codes`, _abort), so
the engine process needs no grpc; its RAW records (small and GLOBAL
RPCs) take the protobuf path.

The protobuf path carries the caller's gRPC deadline
(`context.time_remaining()`) into QoS admission and its source address
into the lease book (`_client_id_from`); an RPC with CONCURRENCY items
arms the stream-close hook (`_arm_lease_stream_close`), which releases
the caller's leases when gRPC cancels the RPC before its response is
delivered.  While the admission queue is saturated the bytes lane is
bypassed, so every item is admitted or shed on the protobuf path.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from gubernator_tpu_torch.api.types import Algorithm
from gubernator_tpu_torch.core.service import BatchTooLargeError, Instance
from gubernator_tpu_torch.observability.tracing import TRACEPARENT

# Only RPCs at least this large take the native pipeline RPC lane; smaller
# ones go through the per-item path, whose requests aggregate with
# everything else pending in the next pipeline drain anyway (the reference's
# BATCHING default, peers.go:143-172).  ~32B/item on the wire, so this is
# roughly a 64-item batch.
FASTPATH_MIN_BYTES = 2048

# 1MB max receive, like the reference (cmd/gubernator/main.go:59-61)
MAX_RECEIVE_BYTES = 1024 * 1024

_GET_RATE_LIMITS = "/pb.gubernator.V1/GetRateLimits"
_HEALTH_CHECK = "/pb.gubernator.V1/HealthCheck"
_GET_PEER_RATE_LIMITS = "/pb.gubernator.PeersV1/GetPeerRateLimits"
_UPDATE_PEER_GLOBALS = "/pb.gubernator.PeersV1/UpdatePeerGlobals"
_TRANSFER_BUCKETS = "/pb.gubernator.PeersV1/TransferBuckets"


# gRPC status codes by name (the first element of each grpc.StatusCode
# value): a context whose `integer_codes` is true, such as the front
# door's engine-side shim (frontdoor.py), aborts with these, so the
# engine process needs no grpc
STATUS_CODES = {"INVALID_ARGUMENT": 3, "RESOURCE_EXHAUSTED": 8,
                "FAILED_PRECONDITION": 9, "OUT_OF_RANGE": 11,
                "UNIMPLEMENTED": 12, "INTERNAL": 13}


async def _abort(context, name: str, message: str) -> None:
    """context.abort with grpc.StatusCode.<name>, resolved only when an
    abort needs it, or with its integer code for an integer-code
    context."""
    if getattr(context, "integer_codes", False):
        await context.abort(STATUS_CODES[name], message)
    else:
        import grpc
        await context.abort(getattr(grpc.StatusCode, name), message)


def _observe(inst: Instance, method: str, start: float, ok: bool) -> None:
    if inst.metrics is not None:
        inst.metrics.observe_rpc(method, start, ok=ok)


def _client_id_from(context) -> Optional[str]:
    """Caller identity for the lease book: the transport-level source
    ADDRESS (ports are ephemeral per connection, so identity sticks across
    reconnects; a forwarding peer's grants attribute to its host)."""
    peer = getattr(context, "peer", None)
    if not callable(peer):
        return None
    try:
        p = peer()
    except Exception:
        return None
    if not p:
        return None
    if p.startswith(("ipv4:", "ipv6:")):
        p = p.split(":", 1)[1].rsplit(":", 1)[0]
    return p or None


def _traceparent_from(context) -> Optional[str]:
    """The caller's `traceparent` invocation-metadata entry, if any (the
    gRPC leg of trace propagation; net/peers.py sets it)."""
    try:
        for k, v in context.invocation_metadata() or ():
            if k == TRACEPARENT:
                return v
    except Exception:
        return None
    return None


def _arm_lease_stream_close(inst: Instance, context,
                            client_id: Optional[str]) -> None:
    """Release a client's concurrency leases when its RPC is torn down
    before the response is delivered (gRPC cancel: the stream closed under
    us): the grants this RPC made never reached the holder, and a vanished
    holder cannot release them itself.  Off with
    GUBER_LEASE_RELEASE_ON_CLOSE=0."""
    if client_id is None or not inst.lease_conf.release_on_stream_close:
        return
    add_cb = getattr(context, "add_done_callback", None)
    if not callable(add_cb):
        return
    loop = asyncio.get_running_loop()

    def _on_done(ctx, cid=client_id, loop=loop):
        cancelled = getattr(ctx, "cancelled", None)
        try:
            was = cancelled() if callable(cancelled) else False
        except Exception:
            was = False
        if was and inst.leases.holds(cid):
            loop.call_soon_threadsafe(
                lambda: loop.create_task(
                    inst.release_client_leases(cid,
                                               reason="stream_close")))

    try:
        add_cb(_on_done)
    except Exception:
        pass


async def serve_get_rate_limits(inst: Instance, data: bytes,
                                context) -> bytes:
    """V1.GetRateLimits body: bytes in, response bytes out."""
    kind, val = await serve_get_rate_limits_inner(inst, data, context)
    if kind == "bytes":
        return val
    from gubernator_tpu_torch.api import pb
    return pb.GetRateLimitsResp(
        responses=[pb.resp_to_pb(r) for r in val]).SerializeToString()


async def serve_get_rate_limits_inner(inst: Instance, data: bytes, context):
    """GetRateLimits body without the final serialization: ("bytes", out)
    when the native RPC lane already encoded, or ("resps",
    [RateLimitResp]) from the protobuf path."""
    start = time.monotonic()
    qos_saturated = (inst.qos is not None
                     and inst.qos.admission.saturated)
    if (not inst.mesh_mode and not qos_saturated
            and len(data) >= FASTPATH_MIN_BYTES):
        # native RPC lane: C parse -> stacked compact drain -> C encode
        # (core/pipeline.py RpcJob)
        out = await inst.batcher.submit_rpc(data)
        if out is not None:
            _observe(inst, _GET_RATE_LIMITS, start, True)
            return "bytes", out
    from gubernator_tpu_torch.api import pb
    try:
        request = pb.GetRateLimitsReq.FromString(data)
    except Exception:
        _observe(inst, _GET_RATE_LIMITS, start, False)
        await _abort(context, "INVALID_ARGUMENT",
                     "malformed GetRateLimitsReq")
    deadline = None
    if inst.qos is not None:
        remaining = None
        tr = getattr(context, "time_remaining", None)
        if callable(tr):
            remaining = tr()
        deadline = inst.qos.deadline_from_timeout(remaining)
    reqs = [pb.req_from_pb(r) for r in request.requests]
    client_id = _client_id_from(context)
    if any(r.algorithm == Algorithm.CONCURRENCY for r in reqs):
        _arm_lease_stream_close(inst, context, client_id)
    try:
        resps = await inst.get_rate_limits(
            reqs, deadline=deadline, client_id=client_id)
    except BatchTooLargeError as e:
        _observe(inst, _GET_RATE_LIMITS, start, False)
        await _abort(context, "OUT_OF_RANGE", str(e))
    _observe(inst, _GET_RATE_LIMITS, start, True)
    return "resps", resps


async def serve_peer_rate_limits(inst: Instance, data: bytes,
                                 context) -> bytes:
    """PeersV1.GetPeerRateLimits body."""
    start = time.monotonic()
    if not inst.mesh_mode:
        # authoritative relay through the native lane: the same wire shape
        # as GetRateLimits, the ring ignored (gubernator.go:210-227)
        out = await inst.batcher.submit_rpc(data, peer_mode=True)
        if out is not None:
            _observe(inst, _GET_PEER_RATE_LIMITS, start, True)
            return out
    from gubernator_tpu_torch.api import pb
    try:
        request = pb.GetPeerRateLimitsReq.FromString(data)
    except Exception:
        _observe(inst, _GET_PEER_RATE_LIMITS, start, False)
        await _abort(context, "INVALID_ARGUMENT",
                     "malformed GetPeerRateLimitsReq")
    try:
        resps = await inst.get_peer_rate_limits(
            [pb.req_from_pb(r) for r in request.requests],
            client_id=_client_id_from(context))
    except BatchTooLargeError as e:
        _observe(inst, _GET_PEER_RATE_LIMITS, start, False)
        await _abort(context, "OUT_OF_RANGE", str(e))
    _observe(inst, _GET_PEER_RATE_LIMITS, start, True)
    return pb.GetPeerRateLimitsResp(
        rate_limits=[pb.resp_to_pb(r) for r in resps]).SerializeToString()


async def serve_update_peer_globals(inst: Instance, request, context):
    """PeersV1.UpdatePeerGlobals body: an owner's broadcast (a decoded
    UpdatePeerGlobalsReq) upserted into this node's replicas."""
    from gubernator_tpu_torch.api import pb
    from gubernator_tpu_torch.api.types import UpdatePeerGlobal
    start = time.monotonic()
    ups = [
        UpdatePeerGlobal(
            key=g.key,
            status=pb.resp_from_pb(g.status),
            algorithm=g.algorithm,
            duration=g.duration,
        )
        for g in request.globals
    ]
    await inst.update_peer_globals(ups)
    _observe(inst, _UPDATE_PEER_GLOBALS, start, True)
    return pb.UpdatePeerGlobalsResp()


async def serve_transfer_buckets(inst: Instance, data: bytes,
                                 context) -> bytes:
    """PeersV1.TransferBuckets body, the import lane of key migration
    (state/migrate.py): payload bytes in, ack bytes out.  A malformed
    payload aborts with INVALID_ARGUMENT, an import the engine refuses
    with FAILED_PRECONDITION."""
    from gubernator_tpu_torch.state.migrate import MigrationError
    start = time.monotonic()
    try:
        ack = await inst.transfer_buckets(data)
    except MigrationError as e:
        _observe(inst, _TRANSFER_BUCKETS, start, False)
        await _abort(context, "INVALID_ARGUMENT", str(e))
    except Exception as e:
        _observe(inst, _TRANSFER_BUCKETS, start, False)
        await _abort(context, "FAILED_PRECONDITION", str(e))
    _observe(inst, _TRANSFER_BUCKETS, start, True)
    return ack


class _V1Servicer:
    def __init__(self, instance: Instance):
        self.instance = instance

    async def GetRateLimits(self, data: bytes, context):
        tracer = self.instance.tracer
        if tracer is None or not tracer.enabled:
            return await serve_get_rate_limits(self.instance, data, context)
        with tracer.start_trace("rpc", _traceparent_from(context)):
            return await serve_get_rate_limits(self.instance, data, context)

    async def HealthCheck(self, request, context):
        # the reference's stats-handler observes every RPC, HealthCheck
        # included (prometheus.go:104-137)
        from gubernator_tpu_torch.api import pb
        start = time.monotonic()
        h = await self.instance.health_check()
        _observe(self.instance, _HEALTH_CHECK, start, True)
        return pb.HealthCheckResp(
            status=h.status, message=h.message, peer_count=h.peer_count)


class _PeersServicer:
    def __init__(self, instance: Instance):
        self.instance = instance

    async def GetPeerRateLimits(self, data: bytes, context):
        # the owner's root of a forwarded request: the traceparent the
        # forwarding node attached stitches this node's spans into its
        # trace
        tracer = self.instance.tracer
        if tracer is None or not tracer.enabled:
            return await serve_peer_rate_limits(self.instance, data, context)
        with tracer.start_trace("peer_rpc", _traceparent_from(context)):
            return await serve_peer_rate_limits(self.instance, data, context)

    async def UpdatePeerGlobals(self, request, context):
        return await serve_update_peer_globals(self.instance, request,
                                               context)

    async def TransferBuckets(self, data: bytes, context):
        return await serve_transfer_buckets(self.instance, data, context)


class GrpcServer:
    def __init__(self, instance: Instance, address: str):
        import grpc

        from gubernator_tpu_torch.api.grpc_api import (
            add_peers_servicer,
            add_v1_servicer,
        )
        self.instance = instance
        self.server = grpc.aio.server(
            options=[("grpc.max_receive_message_length", MAX_RECEIVE_BYTES)])
        add_v1_servicer(self.server, _V1Servicer(instance))
        add_peers_servicer(self.server, _PeersServicer(instance))
        self.port = self.server.add_insecure_port(address)
        host = address.rsplit(":", 1)[0]
        self.address = f"{host}:{self.port}"

    async def start(self) -> None:
        await self.server.start()

    async def stop(self, grace: Optional[float] = 1.0) -> None:
        await self.server.stop(grace)
