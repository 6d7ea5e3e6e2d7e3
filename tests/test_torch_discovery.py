"""The port's discovery backends (gubernator_tpu_torch/discovery/etcd.py,
discovery/kubernetes.py): the mirror of JAX tests/test_discovery.py.

EtcdPool is driven against an in-process fake of the etcd v3 JSON gateway
(register, lease, watch, delete), with and without TLS; K8sPool's
Endpoints parsing is fed a listing.  Then the daemon: GUBER_ETCD_ENDPOINTS
builds an EtcdPool in place of the static pool (and no heartbeat
detector), whose registration reaches Instance.set_peers; each pool
gives the same peer list as the JAX package's pool on the same input;
and cmd/cluster_main.py's dev cluster prints "Ready" and serves.
"""


import asyncio
import base64
import json

import pytest
from aiohttp import web

from gubernator_tpu.discovery.kubernetes import K8sPool as JK8sPool
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.discovery.etcd import EtcdPool
from gubernator_tpu_torch.discovery.kubernetes import K8sPool

pytestmark = pytest.mark.torch_port


def b64(s: str) -> str:
    return base64.b64encode(s.encode()).decode()


class FakeEtcd:
    """Minimal v3 JSON gateway: kv put/range/deleterange, lease grant,
    streaming watch."""

    def __init__(self):
        self.kv = {}
        self.lease_seq = 100
        self.watchers = []
        app = web.Application()
        app.router.add_post("/v3/lease/grant", self.lease_grant)
        app.router.add_post("/v3/lease/keepalive", self.keepalive)
        app.router.add_post("/v3/lease/revoke", self.revoke)
        app.router.add_post("/v3/kv/put", self.put)
        app.router.add_post("/v3/kv/range", self.range)
        app.router.add_post("/v3/kv/deleterange", self.deleterange)
        app.router.add_post("/v3/watch", self.watch)
        self.app = app

    async def lease_grant(self, req):
        self.lease_seq += 1
        return web.json_response({"ID": str(self.lease_seq), "TTL": "30"})

    async def keepalive(self, req):
        return web.json_response({"result": {"TTL": "30"}})

    async def revoke(self, req):
        return web.json_response({})

    async def put(self, req):
        body = await req.json()
        self.kv[body["key"]] = body["value"]
        await self.notify("PUT", body["key"], body["value"])
        return web.json_response({})

    async def range(self, req):
        kvs = [{"key": k, "value": v} for k, v in sorted(self.kv.items())]
        return web.json_response({"kvs": kvs})

    async def deleterange(self, req):
        body = await req.json()
        v = self.kv.pop(body["key"], None)
        if v is not None:
            await self.notify("DELETE", body["key"], "")
        return web.json_response({})

    async def notify(self, type_, key, value):
        ev = {"result": {"events": [
            {"type": type_, "kv": {"key": key, "value": value}}]}}
        line = (json.dumps(ev) + "\n").encode()
        for resp in list(self.watchers):
            try:
                await resp.write(line)
            except Exception:
                self.watchers.remove(resp)

    async def watch(self, req):
        resp = web.StreamResponse()
        await resp.prepare(req)
        self.watchers.append(resp)
        # keep the stream open until the client disconnects
        try:
            while True:
                await asyncio.sleep(3600)
        except asyncio.CancelledError:
            raise
        finally:
            if resp in self.watchers:
                self.watchers.remove(resp)


@pytest.mark.slow
def test_etcd_pool_register_watch():
    async def body():
        fake = FakeEtcd()
        runner = web.AppRunner(fake.app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]

        updates = []

        async def on_update(peers):
            updates.append(sorted(p.address for p in peers))

        pool = EtcdPool(
            endpoints=[f"http://127.0.0.1:{port}"],
            advertise_address="10.0.0.1:81",
            on_update=on_update,
        )
        await pool.start()
        # initial collect includes our own registration
        assert updates[-1] == ["10.0.0.1:81"]
        # let the watch stream connect (the fake has no revision replay)
        for _ in range(50):
            if fake.watchers:
                break
            await asyncio.sleep(0.02)

        # a second node registers -> watch event fires an update
        await fake.put_key("/gubernator/peers/10.0.0.2:81", "10.0.0.2:81")
        await asyncio.sleep(0.2)
        assert updates[-1] == ["10.0.0.1:81", "10.0.0.2:81"]

        # it departs (lease expiry == DELETE)
        await fake.del_key("/gubernator/peers/10.0.0.2:81")
        await asyncio.sleep(0.2)
        assert updates[-1] == ["10.0.0.1:81"]

        # self-identification
        await pool._fire()
        await pool.close()
        await runner.cleanup()

    asyncio.new_event_loop().run_until_complete(body())


# direct-manipulation helpers for the fake
async def _put_key(self, key, value):
    self.kv[b64(key)] = b64(value)
    await self.notify("PUT", b64(key), b64(value))


async def _del_key(self, key):
    self.kv.pop(b64(key), None)
    await self.notify("DELETE", b64(key), "")


FakeEtcd.put_key = _put_key
FakeEtcd.del_key = _del_key


def test_k8s_endpoints_parsing():
    async def body():
        updates = []

        async def on_update(peers):
            updates.append(peers)

        pool = K8sPool(
            namespace="default", pod_ip="10.1.0.5", pod_port="81",
            selector="app=guber", on_update=on_update,
            api_base="http://unused", token="t",
        )
        await pool._update_from([{
            "subsets": [{
                "addresses": [{"ip": "10.1.0.5"}, {"ip": "10.1.0.6"}],
            }],
        }])
        peers = updates[-1]
        assert [p.address for p in peers] == ["10.1.0.5:81", "10.1.0.6:81"]
        assert [p.is_owner for p in peers] == [True, False]
        await pool.close()

    asyncio.new_event_loop().run_until_complete(body())


def test_etcd_pool_over_tls(tmp_path):
    """EtcdPool speaks TLS when given the config-built ssl context (the
    reference's GUBER_ETCD_TLS_* surface, cmd/gubernator/config.go:149-192)."""
    import os
    import subprocess

    from gubernator_tpu_torch.config import config_from_env

    cert = tmp_path / "etcd.crt"
    key = tmp_path / "etcd.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)

    async def body():
        import ssl

        fake = FakeEtcd()
        runner = web.AppRunner(fake.app)
        await runner.setup()
        srv_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        srv_ctx.load_cert_chain(str(cert), str(key))
        site = web.TCPSite(runner, "127.0.0.1", 0, ssl_context=srv_ctx)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]

        env = {"GUBER_ETCD_ENDPOINTS": f"127.0.0.1:{port}",
               "GUBER_ETCD_TLS_CA": str(cert)}
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            conf = config_from_env()
        finally:
            for k, v in old.items():
                os.environ.pop(k, None) if v is None else os.environ.update({k: v})
        assert conf.etcd_tls_enabled and not conf.etcd_tls_skip_verify

        updates = []

        async def on_update(peers):
            updates.append(sorted(p.address for p in peers))

        pool = EtcdPool(
            endpoints=conf.etcd_addresses,
            advertise_address="10.0.0.9:81",
            on_update=on_update,
            ssl_context=conf.etcd_ssl_context(),
        )
        assert pool.base.startswith("https://")
        await pool.start()
        assert updates[-1] == ["10.0.0.9:81"]
        await pool.close()
        await runner.cleanup()

    asyncio.new_event_loop().run_until_complete(body())


def test_etcd_tls_skip_verify_context():
    import ssl

    from gubernator_tpu_torch.config import DaemonConfig

    c = DaemonConfig()
    assert c.etcd_ssl_context() is None
    c.etcd_tls_enabled = True
    c.etcd_tls_skip_verify = True
    ctx = c.etcd_ssl_context()
    assert ctx.verify_mode == ssl.CERT_NONE and not ctx.check_hostname


def test_k8s_endpoints_parsing_equals_the_jax_pool():
    """Several subsets, a not-ready-less address, an address without an
    ip: the port's pool and the JAX pool give the same peers."""
    items = [{"subsets": [
        {"addresses": [{"ip": "10.1.0.5"}, {"ip": ""}, {"ip": "10.1.0.7"}]},
        {"addresses": None},
        {"addresses": [{"ip": "10.1.0.9"}]},
    ]}, {"subsets": None}]

    async def body():
        got = []
        for cls in (K8sPool, JK8sPool):
            updates = []

            async def on_update(peers, updates=updates):
                updates.append(peers)

            pool = cls(namespace="ns", pod_ip="10.1.0.7", pod_port="81",
                       selector="app=guber", on_update=on_update,
                       api_base="http://unused", token="t")
            await pool._update_from(items)
            got.append([(p.address, p.is_owner) for p in updates[-1]])
            await pool.close()
        return got

    mine, theirs = asyncio.new_event_loop().run_until_complete(body())
    assert mine == theirs == [("10.1.0.5:81", False), ("10.1.0.7:81", True),
                              ("10.1.0.9:81", False)]


def test_daemon_builds_an_etcd_pool_from_the_environment(monkeypatch):
    """GUBER_ETCD_ENDPOINTS: the daemon registers with etcd in place of a
    static pool, runs no heartbeat detector (etcd watches membership),
    and the pool's update installs this node in the ring."""
    import os

    from gubernator_tpu_torch.config import config_from_env
    from gubernator_tpu_torch.daemon import Daemon

    for k in [k for k in os.environ if k.startswith("GUBER_")]:
        monkeypatch.delenv(k)

    async def body():
        fake = FakeEtcd()
        # the fake's watch streams never end: cleanup closes them at once
        runner = web.AppRunner(fake.app, shutdown_timeout=0.5)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        monkeypatch.setenv("GUBER_ETCD_ENDPOINTS", f"http://127.0.0.1:{port}")
        monkeypatch.setenv("GUBER_ADVERTISE_ADDRESS", "127.0.0.1:7777")
        monkeypatch.setenv("GUBER_GRPC_ADDRESS", "127.0.0.1:0")
        monkeypatch.setenv("GUBER_HTTP_ADDRESS", "127.0.0.1:0")
        monkeypatch.setenv("GUBER_TORCH_DEVICE", "cpu")
        monkeypatch.setenv("GUBER_TPU_CAPACITY_PER_SHARD", "64")
        monkeypatch.setenv("GUBER_TPU_BATCH_PER_SHARD", "16")
        conf = config_from_env()
        assert conf.etcd_enabled and not conf.k8s_enabled
        d = Daemon(conf)
        await d.start()
        try:
            assert isinstance(d.pool, EtcdPool)
            assert d.monitor is None
            peers = d.instance.peer_list()
            assert [(p.host, p.is_owner) for p in peers] == [
                ("127.0.0.1:7777", True)]
            assert b64("/gubernator/peers/127.0.0.1:7777") in fake.kv
        finally:
            await d.stop()
            await runner.cleanup()
        # the departure deregistered this node
        assert b64("/gubernator/peers/127.0.0.1:7777") not in fake.kv

    asyncio.new_event_loop().run_until_complete(body())


def test_cluster_main_serves_and_prints_ready(monkeypatch, capsys):
    """cmd/cluster_main.py: the dev cluster boots its nodes on the given
    addresses, prints "Ready" once they serve, and stops on request."""
    from gubernator_tpu_torch.client import AsyncClient
    from gubernator_tpu_torch.cmd import cluster_main
    from gubernator_tpu_torch.cluster import Cluster

    monkeypatch.setenv("GUBER_TORCH_DEVICE", "cpu")
    booted = []
    start_with = cluster_main.cluster_mod.start_with

    async def recording_start_with(*a, **kw):
        c = await start_with(*a, **kw)
        booted.append(c)
        return c

    monkeypatch.setattr(cluster_main.cluster_mod, "start_with",
                        recording_start_with)

    async def body():
        stop = asyncio.Event()
        task = asyncio.create_task(
            cluster_main.serve(["127.0.0.1:0"] * 2, stop))
        for _ in range(600):
            if "Ready" in capsys.readouterr().out:
                break
            await asyncio.sleep(0.05)
        else:
            raise AssertionError("the cluster never printed Ready")
        c = booted[0]
        assert isinstance(c, Cluster) and len(c.nodes) == 2
        cl = AsyncClient(c.peer_at(1))
        rs = await cl.get_rate_limits([RateLimitReq(
            name="cm", unique_key="k", hits=1, limit=3, duration=60_000)])
        await cl.close()
        stop.set()
        await task
        return rs

    rs = asyncio.new_event_loop().run_until_complete(body())
    assert rs[0].remaining == 2 and rs[0].error == ""
    assert cluster_main.ADDRESSES == [f"127.0.0.1:{p}"
                                      for p in range(9090, 9096)]
