"""In-process multi-node cluster harness for tests and local development.

The port of `gubernator_tpu/cluster.py` (the reference's
cluster/cluster.go:29-124): N full Instances, each with its own gRPC
server on a real loopback socket, wired into a static full-mesh peer list
with is_owner set by address match; no discovery backend.  The GLOBAL
manager syncs fast for tests (50 ms, cluster.go:87).  Every Instance owns
its own arenas on `device` (`cuda` by default, `cpu` in the tests), so the
cluster runs the cross-host protocol (forwarding, hit aggregation,
broadcasts) over real gRPC.  It needs grpcio and protobuf.  The ring
grows (`add_instance`) and shrinks (`remove_instance`) with live key
migration (Instance.migrate_keys, which needs EngineConfig
use_native=False), and `kill_instance` crashes a node with no handoff, for
the failure detector (net/health.py) to notice.
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
        # remembered for add_instance: a node joining later is built with
        # the founders' configs and device
        self._behaviors: Optional[BehaviorConfig] = None
        self._engine: Optional[EngineConfig] = None
        self._device = None

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

    async def _boot(self, address: str) -> ClusterNode:
        """One Instance (its own Metrics) and gRPC server on `address`, the
        Instance relabelled with the address the server bound."""
        from gubernator_tpu_torch.observability.metrics import Metrics
        inst = Instance(engine_config=self._engine,
                        behaviors=replace(self._behaviors),
                        device=self._device, advertise_address=address,
                        metrics=Metrics())
        server = GrpcServer(inst, address)
        await server.start()
        # an ephemeral port resolves the address late: re-label the node
        # so stitched traces name each node distinctly
        inst.advertise_address = server.address
        inst.tracer.node = server.address
        return ClusterNode(inst, server)

    async def _rewire(self) -> None:
        """Install the current membership on every node (is_owner by
        address match, cluster.go:35-45)."""
        for node in self.nodes:
            await node.instance.set_peers([
                PeerInfo(address=a, is_owner=(a == node.address))
                for a in self.addresses])

    async def add_instance(self, address: str = "127.0.0.1:0") -> ClusterNode:
        """Grow the ring by one node, then migrate the re-homed keys live:
        once the new membership is installed everywhere, every founding
        node diffs old -> new ownership and ships its moved rows to their
        new owners (Instance.migrate_keys); about 1/(N+1) of the key space
        moves, the rest stays where it was."""
        old_hosts = self.addresses
        node = await self._boot(address)
        node.instance.engine.warmup()
        self.nodes.append(node)
        await self._rewire()
        for n in self.nodes[:-1]:
            await n.instance.migrate_keys(old_hosts, self.addresses)
        return node

    async def remove_instance(self, idx: int) -> None:
        """Shrink the ring: the departing node first ships every key it
        owns to the surviving membership (its diff is old membership ->
        membership without itself, so all its keys re-home), then leaves
        the ring and stops.  A failed handoff still rewires the survivors
        (its keys restart cold there)."""
        node = self.nodes[idx]
        old_hosts = self.addresses
        new_hosts = [a for a in old_hosts if a != node.address]
        try:
            # the departing node still has the old ring installed, so its
            # picker reaches every destination while it hands off
            await node.instance.migrate_keys(old_hosts, new_hosts)
        except Exception:
            log.exception("departing node %s failed its handoff; its keys "
                          "restart cold on the survivors", node.address)
        self.nodes.pop(idx)
        await self._rewire()
        await node.server.stop()
        node.instance.close()

    async def kill_instance(self, idx: int) -> ClusterNode:
        """Crash a node: stop its server and engine with no handoff and no
        rewire, so the survivors' rings still name it, as after a real
        peer death.  Recovery is the failure detector's job
        (net/health.py).  Returns the removed node."""
        node = self.nodes.pop(idx)
        try:
            await node.server.stop(grace=0.0)
        except Exception:
            log.exception("killing %s: server stop failed", node.address)
        try:
            node.instance.close()
        except Exception:
            log.exception("killing %s: instance close failed", node.address)
        return node

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
    cluster._behaviors = behaviors
    cluster._engine = engine
    cluster._device = device
    try:
        for addr in addresses:
            cluster.nodes.append(await cluster._boot(addr))
        for node in cluster.nodes:
            node.instance.engine.warmup()
        await cluster._rewire()
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
