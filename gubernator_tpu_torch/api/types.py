"""Wire-level types for the rate-limit API.

These mirror the reference proto contract exactly (enum values and field
semantics from the reference's proto/gubernator.proto:56-143) so that clients
of the reference can switch over without changes.  The dataclasses here are the
in-process representation; the gRPC layer maps them 1:1 onto protobuf messages
generated from the same .proto files.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class Algorithm(enum.IntEnum):
    # reference proto/gubernator.proto:56-61; values 2..4 are the
    # algorithm-plane extension (ops/kernel.py ladders): GCRA,
    # weighted sliding-window counters, and concurrency leases (negative
    # hits releases held slots).  Out-of-range values degrade to
    # TOKEN_BUCKET on-device (reference algorithms.go:100-104 fallback).
    TOKEN_BUCKET = 0
    LEAKY_BUCKET = 1
    GCRA = 2
    SLIDING_WINDOW = 3
    CONCURRENCY = 4


class Behavior(enum.IntEnum):
    # reference proto/gubernator.proto:64-95
    BATCHING = 0
    NO_BATCHING = 1
    GLOBAL = 2


class Status(enum.IntEnum):
    # reference proto/gubernator.proto:126-129
    UNDER_LIMIT = 0
    OVER_LIMIT = 1


# Duration constants in milliseconds (reference client.go:27-31).
Millisecond = 1
Second = 1000 * Millisecond
Minute = 60 * Second
Hour = 60 * Minute


def millisecond_now() -> int:
    """Unix epoch in milliseconds (reference cache/lru.go:99-101)."""
    return time.time_ns() // 1_000_000


@dataclass
class RateLimitReq:
    # reference proto/gubernator.proto:97-123
    name: str = ""
    unique_key: str = ""
    hits: int = 0
    limit: int = 0
    duration: int = 0  # milliseconds
    algorithm: int = Algorithm.TOKEN_BUCKET
    behavior: int = Behavior.BATCHING

    def hash_key(self) -> str:
        """The cache/routing key: name + "_" + unique_key (reference client.go:33-35)."""
        return self.name + "_" + self.unique_key


@dataclass
class RateLimitResp:
    # reference proto/gubernator.proto:131-143
    status: int = Status.UNDER_LIMIT
    limit: int = 0
    remaining: int = 0
    reset_time: int = 0  # unix ms epoch
    error: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)


@dataclass
class GetRateLimitsReq:
    requests: List[RateLimitReq] = field(default_factory=list)


@dataclass
class GetRateLimitsResp:
    responses: List[RateLimitResp] = field(default_factory=list)


@dataclass
class HealthCheckResp:
    # reference proto/gubernator.proto:146-153
    status: str = ""
    message: str = ""
    peer_count: int = 0


@dataclass
class UpdatePeerGlobal:
    """One authoritative global-limit status pushed owner -> peers.

    The reference message carries only (key, status)
    (the reference's proto/peers.proto:50-53), which loses the algorithm and
    duration and silently breaks GLOBAL leaky buckets (status.reset_time is 0
    for leaky, so the reference stores an entry that is already expired).  We
    carry algorithm and duration as additive fields so replicas can upsert a
    fully-typed entry; see state/arena.py upsert.
    """

    key: str = ""
    status: Optional[RateLimitResp] = None
    algorithm: int = Algorithm.TOKEN_BUCKET
    duration: int = 0
