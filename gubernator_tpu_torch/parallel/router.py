"""Host-level consistent-hash peer picker.

A copy of `ConsistentHashRing` from `gubernator_tpu/parallel/router.py`
(JAX-free).  Inside one engine the keyspace partitions by
`crc32(key) % shards` (core/engine.py); across hosts the ring is exactly
compatible with the reference (hash.go:28-96): crc32 IEEE of the peer
address, one point per host, a sorted ring, binary-search successor with
wraparound, so a cluster of reference nodes, JAX nodes and port nodes
routes every key to the same owner.  In mesh mode (parallel/distributed.py)
`MeshShardPicker` takes the ring's place: key -> global shard -> owning
rank -> host, a copy of the JAX package's.
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


class MeshShardPicker(Generic[T]):
    """Mesh-mode PeerPicker: key -> global shard -> owning process -> host.

    In mesh mode the keyspace partition is the mesh's shard axis, so host
    routing must agree with the engine's `crc32(key) % num_shards` exactly
    (a ring would route by host hash and disagree).  Hosts register in
    process-rank order via add(); get() then maps shard -> rank.
    """

    def __init__(self, shard_to_process: List[int], rank_hosts: List[str]):
        self._shard_to_process = shard_to_process  # global shard -> rank
        self._rank_hosts = rank_hosts  # rank -> host address (fixed at boot)
        self._by_host = {}

    @classmethod
    def for_mesh(cls, mesh, rank_hosts: List[str]) -> "MeshShardPicker[T]":
        from gubernator_tpu_torch.parallel.distributed import owning_process
        shard_to_process = [owning_process(s, mesh)
                            for s in range(mesh.num_shards)]
        if max(shard_to_process) >= len(rank_hosts):
            raise ValueError(
                f"mesh spans {max(shard_to_process) + 1} processes but only "
                f"{len(rank_hosts)} peer addresses were given")
        return cls(shard_to_process, list(rank_hosts))

    def new(self) -> "MeshShardPicker[T]":
        return MeshShardPicker(self._shard_to_process, self._rank_hosts)

    def add(self, host: str, peer: T) -> None:
        if host not in self._rank_hosts:
            raise ValueError(f"host {host!r} is not in the mesh peer list "
                             f"{self._rank_hosts}")
        self._by_host[host] = peer

    def size(self) -> int:
        return len(self._by_host)

    def peers(self) -> List[T]:
        return list(self._by_host.values())

    def get_by_host(self, host: str) -> Optional[T]:
        return self._by_host.get(host)

    def get(self, key: str) -> T:
        """Rank-exact routing: a missing (e.g. connect-failed) peer raises
        rather than shifting other ranks' shards onto the wrong host."""
        if not self._by_host:
            raise RuntimeError("unable to pick a peer; pool is empty")
        shard = zlib.crc32(key.encode("utf-8")) % len(self._shard_to_process)
        host = self._rank_hosts[self._shard_to_process[shard]]
        peer = self._by_host.get(host)
        if peer is None:
            raise RuntimeError(
                f"mesh peer {host} (owner of shard {shard}) is not connected")
        return peer
