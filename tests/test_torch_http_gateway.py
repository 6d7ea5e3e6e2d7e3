"""The port's HTTP JSON gateway (api/http_gateway.py) against the JAX
package's, through aiohttp's test client.

Both gateways serve an Instance (the port's on the CPU with a Metrics
registry, the JAX one at its default Config over an engine with the native
router on a two-CPU-device mesh, clocks pinned as in
tests/test_torch_server.py) and get the same requests in the same order:
GetRateLimits JSON (all five algorithms, validation errors, int64 fields),
malformed JSON, a non-numeric X-Guber-Timeout-Ms header (a numeric one
would set the JAX QoS layer's deadline, which the port does not have
yet), 1001 items, HealthCheck, and the analytics top-K (off: 404 in both;
on: equal snapshots after equal traffic).  Status codes and JSON bodies must be
equal.  /metrics must carry the reference's family names.
"""

import asyncio
import json

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import gubernator_tpu  # noqa: F401  (enables x64)
import gubernator_tpu_torch.core.engine as pengine
from gubernator_tpu import compat
from gubernator_tpu.api.http_gateway import build_app as jbuild_app
from gubernator_tpu.config import AnalyticsConfig as JAnalyticsConfig
from gubernator_tpu.config import Config as JConfig
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.core.service import Instance as JInstance
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch.api.http_gateway import build_app
from gubernator_tpu_torch.config import AnalyticsConfig, EngineConfig
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.observability.metrics import Metrics

pytestmark = pytest.mark.torch_port

T0 = 1_700_000_000_000
GEOMETRY = dict(capacity_per_shard=256, batch_per_shard=64,
                global_capacity=16, global_batch_per_shard=8,
                max_global_updates=8)
ANALYTICS = dict(enabled=True, topk=8, sketch_width=64, sketch_depth=3,
                 tenant_slots=6, decay_ms=0, over_weight=4)


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    monkeypatch.setattr(jengine, "millisecond_now", lambda: T0)
    monkeypatch.setattr(pengine, "millisecond_now", lambda: T0)
    _clear_jax_executable_caches()
    yield
    _clear_jax_executable_caches()


def _pin(inst):
    inst.batcher.now_fn = lambda: T0
    if inst.batcher.pipeline is not None:
        inst.batcher.pipeline.now_fn = lambda: T0
    return inst


def _pair(analytics=False):
    mesh = make_mesh(jax.devices("cpu")[2:4])
    jeng = jengine.RateLimitEngine(mesh=mesh, use_native="on", **GEOMETRY)
    jconf = JConfig()
    if analytics:
        jconf.analytics = JAnalyticsConfig(**ANALYTICS)
    jinst = _pin(JInstance(jconf, engine=jeng))
    pinst = _pin(Instance(
        engine_config=EngineConfig(**GEOMETRY, num_shards=2), device="cpu",
        metrics=Metrics(),
        analytics=AnalyticsConfig(**ANALYTICS) if analytics else None))
    if analytics:
        clock = lambda: 1.0  # noqa: E731
        jinst.analytics._now = clock
        pinst.analytics._now = clock
    return jinst, pinst


async def _drive(app, calls):
    client = TestClient(TestServer(app))
    await client.start_server()
    out = []
    try:
        for method, path, body, headers in calls:
            fn = client.post if method == "POST" else client.get
            async with fn(path, data=body, headers=headers or {}) as r:
                text = await r.text()
                try:
                    payload = json.loads(text)
                except ValueError:
                    payload = text
                out.append((r.status, payload))
    finally:
        await client.close()
    return out


def _req(items):
    return json.dumps({"requests": [
        {"name": n, "uniqueKey": k, "hits": str(h), "limit": str(lim),
         "duration": str(d), "algorithm": a, "behavior": b}
        for (n, k, h, lim, d, a, b) in items]})


def _calls():
    rng = np.random.default_rng(3)
    post = "/v1/GetRateLimits"
    calls = []
    for algo, name in enumerate(("TOKEN_BUCKET", "LEAKY_BUCKET", "GCRA",
                                 "SLIDING_WINDOW", "CONCURRENCY")):
        items = [("h", f"k{algo}_{i % 4}", int(rng.integers(0, 3)), 5,
                  60_000, name if algo < 2 else algo, "BATCHING")
                 for i in range(12)]
        calls.append(("POST", post, _req(items), None))
    bad = [("h", "", 1, 5, 1000, 0, 0), ("", "k", 1, 5, 1000, 0, 0),
           ("h", "k", 1, 5, 1000, 9, 0), ("h", "g", 1, 5, 1000, 2, "GLOBAL"),
           ("h", "i64", 2 ** 40, 2 ** 41, 2 ** 36, 0, "NO_BATCHING")]
    calls += [
        ("POST", post, _req(bad), None),
        ("POST", post, "{not json", None),
        ("POST", post, json.dumps({"requests": [{"hits": "x"}]}), None),
        ("POST", post, _req(bad[:1]), {"X-Guber-Timeout-Ms": "soon"}),
        ("POST", post, _req([("h", "k", 1, 5, 1000, 0, 0)] * 1001), None),
        ("GET", "/v1/HealthCheck", None, None),
        ("GET", "/v1/admin/topk", None, None),
        ("GET", "/v1/admin/topk?n=x", None, None),
    ]
    return calls


def test_gateway_answers_as_the_jax_gateway(pinned):
    calls = _calls()
    jinst, pinst = _pair()
    try:
        got_j = asyncio.run(_drive(jbuild_app(jinst), calls))
        got_p = asyncio.run(_drive(build_app(pinst), calls))
    finally:
        jinst.close()
        pinst.close()
    for i, (c, j, p) in enumerate(zip(calls, got_j, got_p)):
        assert p == j, (i, c[:2])
    statuses = [s for s, _ in got_p]
    assert statuses.count(400) == 4 and statuses.count(404) == 2
    assert got_p[5][1]["responses"][4]["remaining"] == str(2 ** 41 - 2 ** 40)


def test_topk_after_traffic_equals_the_jax_gateway(pinned):
    """With analytics on, the same traffic gives the same top-K snapshot
    (hot keys and tenants of the per-item path) through both gateways."""
    items = [("tenant_a", "hot", 1, 50, 60_000, "TOKEN_BUCKET", "BATCHING")
             ] * 10 + [("tenant_b", f"c{i}", 2, 50, 60_000,
                        "LEAKY_BUCKET", "BATCHING") for i in range(6)]
    calls = [("POST", "/v1/GetRateLimits", _req(items), None),
             ("POST", "/v1/GetRateLimits", _req(items[:4]), None),
             ("GET", "/v1/admin/topk", None, None),
             ("GET", "/v1/admin/topk?n=2", None, None)]
    jinst, pinst = _pair(analytics=True)
    try:
        got_j = asyncio.run(_drive(jbuild_app(jinst), calls))
        got_p = asyncio.run(_drive(build_app(pinst), calls))
    finally:
        jinst.close()
        pinst.close()
    assert got_p == got_j
    snap = got_p[2][1]
    assert snap["topk"][0]["key"] == "tenant_a_hot"
    assert len(got_p[3][1]["topk"]) == 2


def test_metrics_carry_the_reference_family_names(pinned):
    pinst = _pin(Instance(engine_config=EngineConfig(**GEOMETRY),
                          device="cpu", metrics=Metrics()))
    calls = [("POST", "/v1/GetRateLimits",
              _req([("m", f"k{i % 3}", 1, 5, 1000, 0, 0) for i in range(6)]),
              None),
             ("POST", "/v1/GetRateLimits", "{bad", None),
             ("GET", "/v1/HealthCheck", None, None),
             ("GET", "/metrics", None, None)]
    try:
        got = asyncio.run(_drive(build_app(pinst), calls))
    finally:
        pinst.close()
    status, text = got[3]
    assert status == 200
    for line in (
            "cache_size 3.0",
            'cache_access_count_total{type="hit"} 3.0',
            'cache_access_count_total{type="miss"} 3.0',
            'grpc_request_counts_total{method="/pb.gubernator.V1/'
            'GetRateLimits",status="success"} 1.0',
            'grpc_request_counts_total{method="/pb.gubernator.V1/'
            'GetRateLimits",status="failed"} 1.0',
            'grpc_request_counts_total{method="/pb.gubernator.V1/'
            'HealthCheck",status="success"} 1.0',
            "# TYPE grpc_request_duration_milliseconds histogram"):
        assert line in text.splitlines(), line


def test_metrics_without_a_registry_is_404():
    inst = Instance(engine_config=EngineConfig(**GEOMETRY), device="cpu")
    try:
        ((status, body),) = asyncio.run(_drive(
            build_app(inst), [("GET", "/metrics", None, None)]))
    finally:
        inst.close()
    assert status == 404 and body["code"] == 12
