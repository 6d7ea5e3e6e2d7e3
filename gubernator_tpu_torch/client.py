"""Clients for the V1 service (async + sync), plus dial helpers.

A copy of `gubernator_tpu/client.py` over the port's stubs.  Covers both
reference clients: the Go thin dial helper (client.go:38-49) and
the Python package (python/gubernator/__init__.py) — one stub class works
with sync and aio channels because grpc exposes the same unary_unary API on
both.  Helpers mirror client.go:52-82.
"""

from __future__ import annotations

import random
import string
from typing import List, Optional, Sequence

import grpc

from gubernator_tpu_torch.api import pb
from gubernator_tpu_torch.api.grpc_api import V1Stub
from gubernator_tpu_torch.api.types import (
    HealthCheckResp,
    RateLimitReq,
    RateLimitResp,
    millisecond_now,
)


def dial_v1_server(address: str) -> "Client":
    """Connect to any node in the cluster (insecure, like client.go:38-49)."""
    return Client(address)


class Client:
    """Synchronous client."""

    def __init__(self, address: str):
        self.channel = grpc.insecure_channel(address)
        self.stub = V1Stub(self.channel)

    def get_rate_limits(self, requests: Sequence[RateLimitReq],
                        timeout: Optional[float] = None) -> List[RateLimitResp]:
        msg = pb.GetRateLimitsReq(requests=[pb.req_to_pb(r) for r in requests])
        resp = self.stub.GetRateLimits(msg, timeout=timeout)
        return [pb.resp_from_pb(m) for m in resp.responses]

    def health_check(self, timeout: Optional[float] = None) -> HealthCheckResp:
        h = self.stub.HealthCheck(pb.HealthCheckReq(), timeout=timeout)
        return HealthCheckResp(status=h.status, message=h.message,
                               peer_count=h.peer_count)

    def close(self) -> None:
        self.channel.close()


class AsyncClient:
    """grpc.aio client with the same surface."""

    def __init__(self, address: str):
        self.channel = grpc.aio.insecure_channel(address)
        self.stub = V1Stub(self.channel)

    async def get_rate_limits(self, requests: Sequence[RateLimitReq],
                              timeout: Optional[float] = None) -> List[RateLimitResp]:
        msg = pb.GetRateLimitsReq(requests=[pb.req_to_pb(r) for r in requests])
        resp = await self.stub.GetRateLimits(msg, timeout=timeout)
        return [pb.resp_from_pb(m) for m in resp.responses]

    async def health_check(self, timeout: Optional[float] = None) -> HealthCheckResp:
        h = await self.stub.HealthCheck(pb.HealthCheckReq(), timeout=timeout)
        return HealthCheckResp(status=h.status, message=h.message,
                               peer_count=h.peer_count)

    async def close(self) -> None:
        await self.channel.close()


# ---- misc helpers (client.go:52-82) ----

def to_timestamp(duration_ms: int) -> int:
    """Convert a duration from now into a ms-epoch timestamp."""
    return millisecond_now() + duration_ms


def random_peer(peers: List[str]) -> str:
    return random.choice(peers)


def random_string(prefix: str, n: int = 10) -> str:
    return prefix + "".join(random.choices(string.ascii_letters + string.digits, k=n))
