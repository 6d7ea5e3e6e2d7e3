"""In-process multi-node cluster harness for tests and local development.

The port of `gubernator_tpu/cluster.py` (the reference's
cluster/cluster.go:29-124): N full Instances, each with its own gRPC
server on a real loopback socket, wired into a static full-mesh peer list
with is_owner set by address match; no discovery backend.  The GLOBAL
manager syncs fast for tests (50 ms, cluster.go:87).  Every Instance owns
its own arenas on `device` (`cuda` by default, `cpu` in the tests), so the
cluster runs the cross-host protocol (forwarding, hit aggregation,
broadcasts) over real gRPC.  It needs grpcio and protobuf.  Growing and
shrinking the ring with key migration waits for ROADMAP item 6d.
"""

from __future__ import annotations

import logging
import random
from dataclasses import replace
from typing import List, Optional, Sequence

from gubernator_tpu_torch.config import BehaviorConfig, EngineConfig, PeerInfo
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.server import GrpcServer

log = logging.getLogger("gubernator.cluster")


class ClusterNode:
    def __init__(self, instance: Instance, server: GrpcServer):
        self.instance = instance
        self.server = server
        self.address = server.address


class Cluster:
    def __init__(self):
        self.nodes: List[ClusterNode] = []

    @property
    def addresses(self) -> List[str]:
        return [n.address for n in self.nodes]

    def get_peer(self) -> str:
        """A random node address (cluster.go:55-57): tests dial randomly so
        routing and forwarding are exercised implicitly."""
        return random.choice(self.addresses)

    def peer_at(self, idx: int) -> str:
        return self.nodes[idx].address

    def instance_at(self, idx: int) -> Instance:
        return self.nodes[idx].instance

    async def owner_index_of(self, key: str) -> int:
        """Index of the node owning `key`, so a test can pick a non-owner
        node (functional_test.go:283-285)."""
        owner = self.nodes[0].instance.get_peer(key)
        return self.addresses.index(owner.host)

    async def stop(self) -> None:
        """Stop every node, tolerating per-node failures: one failing stop
        must not leak every later node's server and engine thread."""
        errors = []
        for n in self.nodes:
            try:
                await n.server.stop()
            except Exception as e:
                errors.append(e)
                log.exception("cluster stop: server %s", n.address)
            try:
                n.instance.close()
            except Exception as e:
                errors.append(e)
                log.exception("cluster stop: instance %s", n.address)
        self.nodes = []
        if errors:
            raise errors[0]


async def start_with(
    addresses: Sequence[str],
    behaviors: Optional[BehaviorConfig] = None,
    engine: Optional[EngineConfig] = None,
    device=None,
) -> Cluster:
    """Boot one Instance and server per address and wire the full mesh
    (cluster.go:70-118).  Each node gets its own Metrics registry, as a
    JAX Instance always has one."""
    from gubernator_tpu_torch.observability.metrics import Metrics
    if behaviors is None:
        # fast global sync for tests (cluster.go:87)
        behaviors = BehaviorConfig(global_sync_wait=0.05)
    if engine is None:
        engine = EngineConfig(
            capacity_per_shard=512, batch_per_shard=128,
            global_capacity=128, global_batch_per_shard=32,
            max_global_updates=32,
        )
    cluster = Cluster()
    try:
        for addr in addresses:
            inst = Instance(engine_config=engine, behaviors=replace(behaviors),
                            device=device, advertise_address=addr,
                            metrics=Metrics())
            server = GrpcServer(inst, addr)
            await server.start()
            # an ephemeral port resolves the address late: re-label the
            # node so stitched traces name each node distinctly
            inst.advertise_address = server.address
            inst.tracer.node = server.address
            cluster.nodes.append(ClusterNode(inst, server))
        for node in cluster.nodes:
            node.instance.engine.warmup()
        for node in cluster.nodes:
            # is_owner marks self by address match (cluster.go:35-45)
            await node.instance.set_peers([
                PeerInfo(address=a, is_owner=(a == node.address))
                for a in cluster.addresses])
    except Exception:
        await cluster.stop()
        raise
    return cluster


async def start(count: int = 6,
                behaviors: Optional[BehaviorConfig] = None,
                engine: Optional[EngineConfig] = None,
                device=None) -> Cluster:
    """N nodes on ephemeral loopback ports (cluster.go:70-76)."""
    return await start_with(["127.0.0.1:0"] * count, behaviors, engine,
                            device=device)
