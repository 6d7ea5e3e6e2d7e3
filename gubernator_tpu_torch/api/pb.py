"""Protobuf message access + conversion to/from the port's dataclasses.

A copy of `gubernator_tpu/api/pb.py` over the port's own generated
modules (`api/proto/`, copies of the JAX package's, which `protoc
--python_out` generated from the .proto files beside them).  The port
imports them by package path, so the one edited line is peers_pb2's
import of gubernator_pb2.  Importing this module needs protobuf; nothing
on the serving core (core/, native/, ops/) imports it.
"""

from __future__ import annotations

from gubernator_tpu_torch.api import types
from gubernator_tpu_torch.api.proto.gubernator_pb2 import (
    GetRateLimitsReq,
    GetRateLimitsResp,
    HealthCheckReq,
    HealthCheckResp,
    RateLimitReq,
    RateLimitResp,
)
from gubernator_tpu_torch.api.proto.peers_pb2 import (
    ApplyGlobalRegistrationReq,
    ApplyGlobalRegistrationResp,
    GetPeerRateLimitsReq,
    GetPeerRateLimitsResp,
    GlobalSpec,
    RegisterGlobalsReq,
    RegisterGlobalsResp,
    UpdatePeerGlobal,
    UpdatePeerGlobalsReq,
    UpdatePeerGlobalsResp,
)


def req_from_pb(m: RateLimitReq) -> types.RateLimitReq:
    return types.RateLimitReq(
        name=m.name,
        unique_key=m.unique_key,
        hits=m.hits,
        limit=m.limit,
        duration=m.duration,
        algorithm=m.algorithm,
        behavior=m.behavior,
    )


def req_to_pb(r: types.RateLimitReq) -> RateLimitReq:
    return RateLimitReq(
        name=r.name,
        unique_key=r.unique_key,
        hits=r.hits,
        limit=r.limit,
        duration=r.duration,
        algorithm=int(r.algorithm),
        behavior=int(r.behavior),
    )


def resp_from_pb(m: RateLimitResp) -> types.RateLimitResp:
    return types.RateLimitResp(
        status=m.status,
        limit=m.limit,
        remaining=m.remaining,
        reset_time=m.reset_time,
        error=m.error,
        metadata=dict(m.metadata),
    )


def resp_to_pb(r: types.RateLimitResp) -> RateLimitResp:
    m = RateLimitResp(
        status=int(r.status),
        limit=r.limit,
        remaining=r.remaining,
        reset_time=r.reset_time,
        error=r.error,
    )
    for k, v in (r.metadata or {}).items():
        m.metadata[k] = v
    return m


__all__ = [
    "GetRateLimitsReq", "GetRateLimitsResp", "HealthCheckReq",
    "HealthCheckResp", "RateLimitReq", "RateLimitResp",
    "GetPeerRateLimitsReq", "GetPeerRateLimitsResp", "UpdatePeerGlobal",
    "UpdatePeerGlobalsReq", "UpdatePeerGlobalsResp",
    "req_from_pb", "req_to_pb", "resp_from_pb", "resp_to_pb",
]
