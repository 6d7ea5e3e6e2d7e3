"""Static peer list "discovery": a fixed membership pushed once.

A copy of `gubernator_tpu/discovery/static.py`.  The reference has no
static backend (only etcd and k8s); this is the simplest OnUpdate source,
used by the daemon's GUBER_STATIC_PEERS and by embedding users who manage
membership themselves (the reference's library embedding story,
architecture.md:79-91: call SetPeers yourself).
"""

from __future__ import annotations

from typing import Awaitable, Callable, List

from gubernator_tpu_torch.config import PeerInfo

OnUpdate = Callable[[List[PeerInfo]], Awaitable[None]]


class StaticPool:
    def __init__(self, addresses: List[str], advertise_address: str,
                 on_update: OnUpdate):
        self.addresses = addresses
        self.advertise_address = advertise_address
        self.on_update = on_update

    async def start(self) -> None:
        peers = [
            PeerInfo(address=a, is_owner=(a == self.advertise_address))
            for a in self.addresses
        ]
        await self.on_update(peers)

    async def close(self) -> None:
        pass
