"""etcd-based peer discovery via the etcd v3 HTTP/JSON gateway.

Functional equivalent of the reference's EtcdPool (etcd.go:47-316): each node
self-registers under `<prefix><advertise_address>` with a leased key (TTL
30s, etcd.go:39), keeps the lease alive (re-registering if it expires,
etcd.go:247-298), and watches the prefix — any change rebuilds the full peer
list and fires OnUpdate → Instance.set_peers (etcd.go:150-209, restart with
5s backoff).

The reference links the etcd Go client; this image has no Python etcd
client, so we speak the stable v3 JSON gateway (/v3/kv/*, /v3/lease/*,
/v3/watch) over aiohttp — same server-side semantics, zero extra deps.
Unlike the reference (which never sets IsOwner on etcd-discovered peers —
a noted inconsistency, SURVEY.md §3.5), we mark self by advertise address.

A copy of `gubernator_tpu/discovery/etcd.py` (aiohttp, no torch), with
PeerInfo from the port's config.py.
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
from typing import Awaitable, Callable, Dict, List, Optional

import aiohttp

from gubernator_tpu_torch.config import PeerInfo

log = logging.getLogger("gubernator.etcd")

LEASE_TTL_S = 30  # reference etcdTimeout lease TTL (etcd.go:39)
BACKOFF_S = 5.0  # watch restart backoff (etcd.go:199)

OnUpdate = Callable[[List[PeerInfo]], Awaitable[None]]


def _b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


def _unb64(s: str) -> str:
    return base64.b64decode(s).decode()


def _prefix_range_end(prefix: str) -> str:
    raw = bytearray(prefix.encode())
    for i in range(len(raw) - 1, -1, -1):
        if raw[i] < 0xFF:
            raw[i] += 1
            return _b64(bytes(raw[: i + 1]).decode("latin-1"))
    return _b64("\0")


class EtcdPool:
    def __init__(
        self,
        endpoints: List[str],
        advertise_address: str,
        on_update: OnUpdate,
        prefix: str = "/gubernator/peers/",
        username: str = "",
        password: str = "",
        ssl_context=None,
    ):
        if not advertise_address:
            raise ValueError("AdvertiseAddress is required")  # etcd.go:68
        self.base = endpoints[0].rstrip("/")
        if not self.base.startswith("http"):
            # TLS-configured connections default to the https scheme
            # (the reference's etcd client switches transports on conf.TLS)
            scheme = "https://" if ssl_context is not None else "http://"
            self.base = scheme + self.base
        self.prefix = prefix
        self.advertise_address = advertise_address
        self.on_update = on_update
        self.username = username
        self.password = password
        self.ssl_context = ssl_context
        self._session: Optional[aiohttp.ClientSession] = None
        self._lease_id: Optional[int] = None
        self._peers: Dict[str, PeerInfo] = {}
        self._tasks: List[asyncio.Task] = []
        self._closed = False

    async def _post(self, path: str, payload: dict) -> dict:
        async with self._session.post(self.base + path, json=payload) as r:
            r.raise_for_status()
            return await r.json()

    def _connector(self) -> Optional[aiohttp.TCPConnector]:
        if self.ssl_context is None:
            return None
        return aiohttp.TCPConnector(ssl=self.ssl_context)

    async def start(self) -> None:
        headers = {}
        if self.username:
            # v3 JSON gateway auth: exchange user/pass for a token
            async with aiohttp.ClientSession(connector=self._connector()) as s:
                async with s.post(self.base + "/v3/auth/authenticate", json={
                    "name": self.username, "password": self.password}) as r:
                    r.raise_for_status()
                    headers["Authorization"] = (await r.json())["token"]
        self._session = aiohttp.ClientSession(
            headers=headers, connector=self._connector())
        await self._register()
        await self._collect()
        self._tasks.append(asyncio.create_task(self._keepalive_loop()))
        self._tasks.append(asyncio.create_task(self._watch_loop()))

    # ------------------------------------------------------------ registration

    async def _register(self) -> None:
        """Grant a lease and put our key under it (etcd.go:211-245)."""
        grant = await self._post("/v3/lease/grant", {"TTL": str(LEASE_TTL_S)})
        self._lease_id = int(grant["ID"])
        key = self.prefix + self.advertise_address
        await self._post("/v3/kv/put", {
            "key": _b64(key),
            "value": _b64(self.advertise_address),
            "lease": str(self._lease_id),
        })

    async def _keepalive_loop(self) -> None:
        """Heartbeat the lease; on failure re-register (etcd.go:247-298)."""
        while not self._closed:
            await asyncio.sleep(LEASE_TTL_S / 3)
            try:
                resp = await self._post("/v3/lease/keepalive",
                                        {"ID": str(self._lease_id)})
                ttl = int(resp.get("result", {}).get("TTL", 0))
                if ttl <= 0:
                    raise RuntimeError("lease expired")
            except Exception as e:
                if self._closed:
                    return
                log.warning("lease keep-alive failed (%s); re-registering", e)
                await asyncio.sleep(BACKOFF_S)
                try:
                    await self._register()
                except Exception as e2:
                    log.error("re-register failed: %s", e2)

    # ----------------------------------------------------------------- watch

    async def _collect(self) -> None:
        """Initial full read of the prefix (etcd.go:132-148)."""
        resp = await self._post("/v3/kv/range", {
            "key": _b64(self.prefix),
            "range_end": _prefix_range_end(self.prefix),
        })
        self._peers = {}
        for kv in resp.get("kvs", []):
            addr = _unb64(kv["value"])
            self._peers[_unb64(kv["key"])] = PeerInfo(address=addr)
        await self._fire()

    async def _watch_loop(self) -> None:
        """Stream watch events; restart with backoff (etcd.go:150-209)."""
        while not self._closed:
            try:
                payload = json.dumps({"create_request": {
                    "key": _b64(self.prefix),
                    "range_end": _prefix_range_end(self.prefix),
                }})
                async with self._session.post(self.base + "/v3/watch",
                                              data=payload) as r:
                    async for line in r.content:
                        if self._closed:
                            return
                        if not line.strip():
                            continue
                        msg = json.loads(line)
                        events = msg.get("result", {}).get("events", [])
                        if events:
                            await self._apply_events(events)
            except Exception as e:
                if self._closed:
                    return
                log.warning("etcd watch interrupted (%s); restarting", e)
                await asyncio.sleep(BACKOFF_S)
                try:
                    await self._collect()
                except Exception:
                    pass

    async def _apply_events(self, events: List[dict]) -> None:
        # PUT adds/updates a peer; DELETE (lease expiry) removes it
        # (etcd.go:168-182)
        for ev in events:
            kv = ev.get("kv", {})
            key = _unb64(kv.get("key", ""))
            if ev.get("type") == "DELETE":
                self._peers.pop(key, None)
            else:
                self._peers[key] = PeerInfo(address=_unb64(kv.get("value", "")))
        await self._fire()

    async def _fire(self) -> None:
        peers = [
            PeerInfo(address=p.address,
                     is_owner=(p.address == self.advertise_address))
            for p in self._peers.values()
        ]
        await self.on_update(peers)

    async def close(self) -> None:
        """Deregister and stop (etcd.go:283-295)."""
        self._closed = True
        for t in self._tasks:
            t.cancel()
        try:
            if self._lease_id is not None:
                await self._post("/v3/kv/deleterange",
                                 {"key": _b64(self.prefix + self.advertise_address)})
                await self._post("/v3/lease/revoke", {"ID": str(self._lease_id)})
        except Exception:
            pass
        if self._session is not None:
            await self._session.close()
