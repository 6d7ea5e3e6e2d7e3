"""gRPC service wiring for V1 and PeersV1 (hand-wired generic handlers).

A copy of `gubernator_tpu/api/grpc_api.py` over the port's messages.
Service and method names match the reference exactly ("pb.gubernator.V1"
and "pb.gubernator.PeersV1", reference gubernator.pb.go:419,
peers.pb.go:164) so reference clients interoperate.  Method handlers are
registered directly instead of through generated *_grpc.py stubs: every
PeersV1 method, TransferBuckets (key migration) at the bytes level, and
RegisterGlobals and ApplyGlobalRegistration (mesh GLOBAL registration).
"""

from __future__ import annotations

import grpc

from gubernator_tpu_torch.api import pb

V1_SERVICE = "pb.gubernator.V1"
PEERS_SERVICE = "pb.gubernator.PeersV1"


def add_v1_servicer(server: grpc.aio.Server, servicer) -> None:
    """servicer: async methods GetRateLimits(req, ctx), HealthCheck(req, ctx).

    GetRateLimits is registered at the BYTES level (no grpc-layer proto
    codec): the servicer owns decode/encode so eligible RPCs can run the
    native pipeline lane (core/pipeline.py) without ever materializing
    Python protobuf objects."""
    handlers = {
        "GetRateLimits": grpc.unary_unary_rpc_method_handler(
            servicer.GetRateLimits,
            request_deserializer=None,
            response_serializer=None,
        ),
        "HealthCheck": grpc.unary_unary_rpc_method_handler(
            servicer.HealthCheck,
            request_deserializer=pb.HealthCheckReq.FromString,
            response_serializer=pb.HealthCheckResp.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(V1_SERVICE, handlers),)
    )


def add_peers_servicer(server: grpc.aio.Server, servicer) -> None:
    """servicer: async GetPeerRateLimits(req, ctx), TransferBuckets(req,
    ctx), UpdatePeerGlobals(req, ctx), RegisterGlobals(req, ctx),
    ApplyGlobalRegistration(req, ctx)."""
    handlers = {
        # bytes-level like V1.GetRateLimits: the servicer owns
        # decode/encode so authoritative relays can run the native
        # pipeline lane without materializing protobuf objects
        "GetPeerRateLimits": grpc.unary_unary_rpc_method_handler(
            servicer.GetPeerRateLimits,
            request_deserializer=None,
            response_serializer=None,
        ),
        # bytes-level: the migration payload's codec is state/migrate.py's
        # (versioned JSON), not a generated proto
        "TransferBuckets": grpc.unary_unary_rpc_method_handler(
            servicer.TransferBuckets,
            request_deserializer=None,
            response_serializer=None,
        ),
        "UpdatePeerGlobals": grpc.unary_unary_rpc_method_handler(
            servicer.UpdatePeerGlobals,
            request_deserializer=pb.UpdatePeerGlobalsReq.FromString,
            response_serializer=pb.UpdatePeerGlobalsResp.SerializeToString,
        ),
        "RegisterGlobals": grpc.unary_unary_rpc_method_handler(
            servicer.RegisterGlobals,
            request_deserializer=pb.RegisterGlobalsReq.FromString,
            response_serializer=pb.RegisterGlobalsResp.SerializeToString,
        ),
        "ApplyGlobalRegistration": grpc.unary_unary_rpc_method_handler(
            servicer.ApplyGlobalRegistration,
            request_deserializer=pb.ApplyGlobalRegistrationReq.FromString,
            response_serializer=(
                pb.ApplyGlobalRegistrationResp.SerializeToString),
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(PEERS_SERVICE, handlers),)
    )


class V1Stub:
    """Client stub for the public API (reference gubernator.pb.go:375-409)."""

    def __init__(self, channel):
        self.GetRateLimits = channel.unary_unary(
            f"/{V1_SERVICE}/GetRateLimits",
            request_serializer=pb.GetRateLimitsReq.SerializeToString,
            response_deserializer=pb.GetRateLimitsResp.FromString,
        )
        self.HealthCheck = channel.unary_unary(
            f"/{V1_SERVICE}/HealthCheck",
            request_serializer=pb.HealthCheckReq.SerializeToString,
            response_deserializer=pb.HealthCheckResp.FromString,
        )


class PeersV1Stub:
    """Client stub for the peer plane (reference peers.pb.go:122-155)."""

    def __init__(self, channel):
        self.GetPeerRateLimits = channel.unary_unary(
            f"/{PEERS_SERVICE}/GetPeerRateLimits",
            request_serializer=pb.GetPeerRateLimitsReq.SerializeToString,
            response_deserializer=pb.GetPeerRateLimitsResp.FromString,
        )
        self.UpdatePeerGlobals = channel.unary_unary(
            f"/{PEERS_SERVICE}/UpdatePeerGlobals",
            request_serializer=pb.UpdatePeerGlobalsReq.SerializeToString,
            response_deserializer=pb.UpdatePeerGlobalsResp.FromString,
        )
        self.RegisterGlobals = channel.unary_unary(
            f"/{PEERS_SERVICE}/RegisterGlobals",
            request_serializer=pb.RegisterGlobalsReq.SerializeToString,
            response_deserializer=pb.RegisterGlobalsResp.FromString,
        )
        self.ApplyGlobalRegistration = channel.unary_unary(
            f"/{PEERS_SERVICE}/ApplyGlobalRegistration",
            request_serializer=pb.ApplyGlobalRegistrationReq.SerializeToString,
            response_deserializer=pb.ApplyGlobalRegistrationResp.FromString,
        )
