"""Kubernetes peer discovery: watch the Endpoints API for pod membership.

Functional equivalent of the reference's K8sPool (kubernetes.go:35-161):
watch Endpoints in our namespace filtered by a label selector; the peer list
is every ready pod IP plus the configured port; self is marked by PodIP
match (kubernetes.go:148-150).  No self-registration — kubelet readiness
drives membership.

The reference links client-go's SharedIndexInformer; this image has no
Python k8s client, so we speak the core REST API directly (in-cluster
service-account token + CA, watch=true streaming) over aiohttp — the same
watch/relist protocol an informer uses.

A copy of `gubernator_tpu/discovery/kubernetes.py` (aiohttp, no torch), with
PeerInfo from the port's config.py.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import ssl
from typing import Awaitable, Callable, List, Optional

import aiohttp

from gubernator_tpu_torch.config import PeerInfo

log = logging.getLogger("gubernator.k8s")

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
BACKOFF_S = 5.0

OnUpdate = Callable[[List[PeerInfo]], Awaitable[None]]


class K8sPool:
    def __init__(
        self,
        namespace: str,
        pod_ip: str,
        pod_port: str,
        selector: str,
        on_update: OnUpdate,
        api_base: Optional[str] = None,
        token: Optional[str] = None,
        ssl_context: Optional[ssl.SSLContext] = None,
    ):
        self.namespace = namespace
        self.pod_ip = pod_ip
        self.pod_port = pod_port
        self.selector = selector
        self.on_update = on_update
        # in-cluster config (the reference uses rest.InClusterConfig,
        # kubernetes.go:57); tests may inject api_base/token directly
        if api_base is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            api_base = f"https://{host}:{port}"
        self.api_base = api_base.rstrip("/")
        if token is None and os.path.exists(f"{SA_DIR}/token"):
            token = open(f"{SA_DIR}/token").read().strip()
        self.token = token or ""
        if ssl_context is None and os.path.exists(f"{SA_DIR}/ca.crt"):
            ssl_context = ssl.create_default_context(cafile=f"{SA_DIR}/ca.crt")
        self.ssl_context = ssl_context
        self._session: Optional[aiohttp.ClientSession] = None
        self._task: Optional[asyncio.Task] = None
        self._closed = False

    def _url(self, watch: bool, resource_version: str = "") -> str:
        url = (f"{self.api_base}/api/v1/namespaces/{self.namespace}/endpoints"
               f"?labelSelector={self.selector}")
        if watch:
            url += "&watch=true"
            if resource_version:
                url += f"&resourceVersion={resource_version}"
        return url

    async def start(self) -> None:
        headers = {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        self._session = aiohttp.ClientSession(headers=headers)
        self._task = asyncio.create_task(self._run())

    async def _run(self) -> None:
        while not self._closed:
            try:
                # list, then watch from the returned resourceVersion — the
                # informer pattern (kubernetes.go:78-104)
                async with self._session.get(self._url(False),
                                             ssl=self.ssl_context) as r:
                    r.raise_for_status()
                    listing = await r.json()
                await self._update_from(listing.get("items", []))
                rv = listing.get("metadata", {}).get("resourceVersion", "")
                async with self._session.get(self._url(True, rv),
                                             ssl=self.ssl_context,
                                             timeout=aiohttp.ClientTimeout(total=None)) as r:
                    async for line in r.content:
                        if self._closed:
                            return
                        if not line.strip():
                            continue
                        ev = json.loads(line)
                        if ev.get("type") in ("ADDED", "MODIFIED", "DELETED"):
                            # simplest correct reaction: relist
                            # (update/delete handlers, kubernetes.go:105-123)
                            break
            except Exception as e:
                if self._closed:
                    return
                log.warning("k8s endpoints watch interrupted (%s); retrying", e)
                await asyncio.sleep(BACKOFF_S)

    async def _update_from(self, endpoints_items: List[dict]) -> None:
        """Peer list = ready pod IPs + configured port (kubernetes.go:135-156)."""
        peers: List[PeerInfo] = []
        for item in endpoints_items:
            for subset in item.get("subsets", []) or []:
                for addr in subset.get("addresses", []) or []:
                    ip = addr.get("ip", "")
                    if not ip:
                        continue
                    peers.append(PeerInfo(
                        address=f"{ip}:{self.pod_port}",
                        is_owner=(ip == self.pod_ip),
                    ))
        await self.on_update(peers)

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._task.cancel()
        if self._session is not None:
            await self._session.close()
