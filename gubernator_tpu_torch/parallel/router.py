"""Host-level consistent-hash peer picker.

A copy of `ConsistentHashRing` from `gubernator_tpu/parallel/router.py`
(JAX-free).  Inside one engine the keyspace partitions by
`crc32(key) % shards` (core/engine.py); across hosts the ring is exactly
compatible with the reference (hash.go:28-96): crc32 IEEE of the peer
address, one point per host, a sorted ring, binary-search successor with
wraparound, so a cluster of reference nodes, JAX nodes and port nodes
routes every key to the same owner.  The mesh picker (`MeshShardPicker`)
comes with mesh serving (ROADMAP item 8).
"""

from __future__ import annotations

import bisect
import zlib
from typing import Generic, List, Optional, TypeVar

T = TypeVar("T")


class ConsistentHashRing(Generic[T]):
    """PeerPicker (reference peers.go:26-33 / hash.go:28-96)."""

    def __init__(self):
        self._points: List[int] = []  # sorted hash points
        self._by_point = {}  # point -> peer
        self._by_host = {}  # host -> peer

    def new(self) -> "ConsistentHashRing[T]":
        return ConsistentHashRing()

    @staticmethod
    def _hash(data: str) -> int:
        return zlib.crc32(data.encode("utf-8"))

    def add(self, host: str, peer: T) -> None:
        point = self._hash(host)
        if point not in self._by_point:
            bisect.insort(self._points, point)
        self._by_point[point] = peer
        self._by_host[host] = peer

    def size(self) -> int:
        return len(self._points)

    def peers(self) -> List[T]:
        return list(self._by_host.values())

    def get_by_host(self, host: str) -> Optional[T]:
        return self._by_host.get(host)

    def get(self, key: str) -> T:
        """Owner peer for a hash key; raises if the ring is empty."""
        if not self._points:
            raise RuntimeError("unable to pick a peer; pool is empty")
        h = self._hash(key)
        idx = bisect.bisect_left(self._points, h)
        if idx == len(self._points):
            idx = 0  # wrap to the first point
        return self._by_point[self._points[idx]]

    def ring_table(self):
        """(sorted points, peer per point): the native RPC parser's
        classification table (host_router.cc router_set_ring)."""
        return list(self._points), [self._by_point[p] for p in self._points]
