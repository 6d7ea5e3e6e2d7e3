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

Ported: V1.GetRateLimits and HealthCheck, PeersV1.GetPeerRateLimits.  Not
registered yet, so a caller gets UNIMPLEMENTED: TransferBuckets (key
migration, with the peer ring) and RegisterGlobals, ApplyGlobalRegistration and
UpdatePeerGlobals (GLOBAL across processes).  The concurrency-lease
stream-close hook and the tracing roots wait for the ports of leases and
tracing.
"""

from __future__ import annotations

import time
from typing import Optional

from gubernator_tpu_torch.core.service import BatchTooLargeError, Instance

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


def _status(name: str):
    """grpc.StatusCode.<name>, resolved only when an abort needs it."""
    import grpc
    return getattr(grpc.StatusCode, name)


def _observe(inst: Instance, method: str, start: float, ok: bool) -> None:
    if inst.metrics is not None:
        inst.metrics.observe_rpc(method, start, ok=ok)


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
        await context.abort(_status("INVALID_ARGUMENT"),
                            "malformed GetRateLimitsReq")
    reqs = [pb.req_from_pb(r) for r in request.requests]
    try:
        resps = await inst.get_rate_limits(reqs)
    except BatchTooLargeError as e:
        _observe(inst, _GET_RATE_LIMITS, start, False)
        await context.abort(_status("OUT_OF_RANGE"), str(e))
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
        await context.abort(_status("INVALID_ARGUMENT"),
                            "malformed GetPeerRateLimitsReq")
    try:
        resps = await inst.get_peer_rate_limits(
            [pb.req_from_pb(r) for r in request.requests])
    except BatchTooLargeError as e:
        _observe(inst, _GET_PEER_RATE_LIMITS, start, False)
        await context.abort(_status("OUT_OF_RANGE"), str(e))
    _observe(inst, _GET_PEER_RATE_LIMITS, start, True)
    return pb.GetPeerRateLimitsResp(
        rate_limits=[pb.resp_to_pb(r) for r in resps]).SerializeToString()


class _V1Servicer:
    def __init__(self, instance: Instance):
        self.instance = instance

    async def GetRateLimits(self, data: bytes, context):
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
        return await serve_peer_rate_limits(self.instance, data, context)


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
