"""The port daemon's state lifecycle and the gateway's admin plane, on the
CPU.

A port daemon with GUBER_SNAPSHOT_DIR restores before it serves: from a
file the JAX package's Instance saved (its periodic save,
`Instance.save_snapshot`), after which it answers as the JAX engine does;
from a corrupt file or none, with a logged cold start.  It saves every
GUBER_SNAPSHOT_INTERVAL_MS and once more in the stop sequence, after the
drain and the handoff (the JAX daemon's stop phases, STOP_PHASES for a
standalone daemon).
The HTTP gateway's GET /v1/admin/snapshot and POST /v1/admin/restore
answer as the JAX gateway's on the same state (clocks pinned as in
tests/test_torch_http_gateway.py): the same blob bytes in each layout,
the same restored-key count, the same 400 body for a bad blob; and a
restore body over aiohttp's default 1 MiB cap succeeds.
"""

import asyncio
import json
import logging
import os

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

import gubernator_tpu  # noqa: F401  (enables x64)
import gubernator_tpu_torch.core.engine as pengine
import gubernator_tpu_torch.daemon as daemon_mod
from gubernator_tpu import compat
from gubernator_tpu.api.http_gateway import build_app as jbuild_app
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.config import Config as JConfig
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.core.service import Instance as JInstance
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch import config as pconfig
from gubernator_tpu_torch.api.http_gateway import build_app
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.client import AsyncClient
from gubernator_tpu_torch.config import EngineConfig
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.observability.metrics import Metrics
from gubernator_tpu_torch.state import snapshot as snapmod

pytestmark = pytest.mark.torch_port

T0 = 1_700_000_000_000
SMALL = {"GUBER_TORCH_DEVICE": "cpu", "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
         "GUBER_HTTP_ADDRESS": "127.0.0.1:0",
         "GUBER_TPU_CAPACITY_PER_SHARD": "256",
         "GUBER_TPU_BATCH_PER_SHARD": "64",
         "GUBER_TPU_GLOBAL_CAPACITY": "16"}
# a standalone daemon's stop, in the JAX daemon's order (no survivor to
# hand keys to)
STOP_PHASES = ["monitor_stop", "drain", "global_flush", "handoff_skipped",
               "snapshot", "teardown"]
GEOMETRY = dict(capacity_per_shard=256, batch_per_shard=64,
                global_capacity=16, global_batch_per_shard=8,
                max_global_updates=8)


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture
def clean_env(monkeypatch):
    saved = dict(os.environ)
    for k in list(os.environ):
        if k.startswith("GUBER_"):
            monkeypatch.delenv(k)
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()
    yield monkeypatch
    _clear_jax_executable_caches()
    os.environ.clear()
    os.environ.update(saved)


def _reqs(n_keys=10, hits=1):
    return [RateLimitReq(name="ds", unique_key=f"k{i}", hits=hits, limit=5,
                         duration=600_000) for i in range(n_keys)]


def _jreqs(reqs):
    return [JReq(name=r.name, unique_key=r.unique_key, hits=r.hits,
                 limit=r.limit, duration=r.duration, algorithm=r.algorithm,
                 behavior=r.behavior) for r in reqs]


def _tuples(rs):
    return [(int(r.status), int(r.limit), int(r.remaining),
             int(r.reset_time)) for r in rs]


def _env(monkeypatch, **extra):
    for k, v in {**SMALL, **extra}.items():
        monkeypatch.setenv(k, str(v))
    return pconfig.config_from_env()


def test_daemon_boots_from_a_jax_instance_snapshot(clean_env, tmp_path):
    """The JAX package's Instance saves (its daemon's periodic save); a
    port daemon pointed at the directory restores before serving and
    answers the next hits as the JAX engine does; its stop saves again
    after the drain."""
    conf = _env(clean_env, GUBER_SNAPSHOT_DIR=str(tmp_path))
    assert conf.engine.num_shards == 1
    mesh = make_mesh(jax.devices("cpu")[4:5])
    jeng = jengine.RateLimitEngine(
        mesh=mesh, use_native="on", capacity_per_shard=256,
        batch_per_shard=64, global_capacity=16)
    jinst = JInstance(JConfig(), engine=jeng)

    async def body():
        jeng.process(_jreqs(_reqs(hits=2)))
        size = await jinst.save_snapshot(str(tmp_path / "arena.snap"))
        await jinst.aclose()
        d = daemon_mod.Daemon(conf)
        await d.start()
        try:
            client = AsyncClient(d.grpc.address)
            got = await client.get_rate_limits(_reqs())
            await client.close()
            text = d.instance.metrics.expose().decode()
        finally:
            await d.stop()
        return size, d, got, text

    size, d, got, text = asyncio.run(body())
    want = jeng.process(_jreqs(_reqs()))
    assert size > 0
    assert [r.remaining for r in got] == [2] * 10
    assert _tuples(got) == _tuples(want)
    assert "guber_tpu_restore_age_seconds" in text
    assert d.shutdown_phases == STOP_PHASES
    # the stop's save holds the hits served after the restore
    fresh = pengine.RateLimitEngine(capacity_per_shard=256, device="cpu",
                                    use_native="auto", global_capacity=16)
    snap = snapmod.restore_engine(fresh, str(tmp_path / "arena.snap"))
    assert snap is not None and snap.total_keys() == 10
    assert [r.remaining for r in fresh.process(_reqs())] == [1] * 10


def test_daemon_saves_each_interval_and_once_after_the_drain(clean_env,
                                                             tmp_path):
    conf = _env(clean_env, GUBER_SNAPSHOT_DIR=str(tmp_path / "snaps"),
                GUBER_SNAPSHOT_INTERVAL_MS=100)
    assert conf.snapshot_interval_ms == 100

    async def body():
        d = daemon_mod.Daemon(conf)
        await d.start()
        calls = []
        real = d.instance.save_snapshot

        async def recorded(path, layout="auto"):
            calls.append(list(d.shutdown_phases))
            return await real(path, layout)

        d.instance.save_snapshot = recorded
        try:
            client = AsyncClient(d.grpc.address)
            await client.get_rate_limits(_reqs())
            for _ in range(200):
                if len(calls) >= 3:
                    break
                await asyncio.sleep(0.02)
            periodic = len(calls)
            # served after the last periodic save: only the stop's save
            # can hold it
            await client.get_rate_limits(_reqs(hits=3))
            await client.close()
        finally:
            await d.stop()
        return d, calls, periodic, d.instance.metrics.expose().decode()

    d, calls, periodic, text = asyncio.run(body())
    assert periodic >= 3
    # every save before the stop ran outside it; the stop saved once,
    # after the drain
    assert all(c == [] for c in calls[:-1])
    assert calls[-1] == STOP_PHASES[:-1] and len(calls) > periodic
    assert d.shutdown_phases == STOP_PHASES
    line = [ln for ln in text.splitlines()
            if ln.startswith('guber_tpu_snapshots_total{status="success"}')]
    assert line and float(line[0].split()[1]) == len(calls)
    fresh = pengine.RateLimitEngine(capacity_per_shard=256, device="cpu",
                                    use_native="auto", global_capacity=16)
    assert snapmod.restore_engine(
        fresh, str(tmp_path / "snaps" / "arena.snap")) is not None
    assert [r.remaining for r in fresh.process(_reqs())] == [0] * 10


@pytest.mark.parametrize("case", ["missing", "corrupt"])
def test_daemon_cold_starts_on_a_missing_or_corrupt_file(clean_env,
                                                         tmp_path, caplog,
                                                         case):
    path = tmp_path / "arena.snap"
    if case == "corrupt":
        eng = pengine.RateLimitEngine(capacity_per_shard=256, device="cpu",
                                      use_native="auto", global_capacity=16)
        eng.process(_reqs(hits=4))
        blob = snapmod.dumps(eng.export_state())
        path.write_bytes(blob[:40] + bytes([blob[40] ^ 1]) + blob[41:])
    conf = _env(clean_env, GUBER_SNAPSHOT_DIR=str(tmp_path))

    async def body():
        d = daemon_mod.Daemon(conf)
        with caplog.at_level(logging.INFO, "gubernator.snapshot"):
            await d.start()
        try:
            client = AsyncClient(d.grpc.address)
            got = await client.get_rate_limits(_reqs())
            await client.close()
        finally:
            await d.stop()
        return got

    got = asyncio.run(body())
    assert [r.remaining for r in got] == [4] * 10  # fresh buckets
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "gubernator.snapshot"]
    assert any("starting cold" in m for m in msgs), msgs
    # the stop's save replaced the unusable file with a good one
    assert snapmod.load(str(path)).total_keys() == 10


# ------------------------------------------------------- the admin plane


@pytest.fixture
def pinned(clean_env):
    clean_env.setattr(jengine, "millisecond_now", lambda: T0)
    clean_env.setattr(pengine, "millisecond_now", lambda: T0)
    yield


def _pin(inst):
    inst.batcher.now_fn = lambda: T0
    if inst.batcher.pipeline is not None:
        inst.batcher.pipeline.now_fn = lambda: T0
    return inst


async def _call(app, calls):
    client = TestClient(TestServer(app))
    await client.start_server()
    out = []
    try:
        for method, path, body in calls:
            fn = client.post if method == "POST" else client.get
            async with fn(path, data=body) as r:
                raw = await r.read()
                ctype = r.headers.get("Content-Type", "")
                out.append((r.status, ctype.split(";")[0],
                            json.loads(raw) if "json" in ctype else raw))
    finally:
        await client.close()
    return out


def _traffic():
    rng = np.random.default_rng(8)
    items = []
    for i in range(60):
        k = int(rng.integers(20))
        items.append({"name": "adm", "uniqueKey": f"k{k}",
                      "hits": str(int(rng.integers(0, 3))), "limit": "9",
                      "duration": "60000", "algorithm": ["TOKEN_BUCKET",
                                                         "LEAKY_BUCKET"][k % 2],
                      "behavior": "GLOBAL" if k % 5 == 0 else "BATCHING"})
    return json.dumps({"requests": items})


def test_admin_routes_answer_as_the_jax_gateway(pinned):
    """Same state in both (the same GetRateLimits at a pinned clock), then
    the admin plane: the snapshot blob in each layout byte for byte, a
    restore of it ({"restoredKeys": n}), a restore at rebase_to, and the
    bad blobs' 400 bodies; then the state after the restores answers the
    same GetRateLimits alike."""
    mesh = make_mesh(jax.devices("cpu")[2:4])
    jinst = _pin(JInstance(JConfig(), engine=jengine.RateLimitEngine(
        mesh=mesh, use_native="on", **GEOMETRY)))
    pinst = _pin(Instance(engine_config=EngineConfig(**GEOMETRY,
                                                     num_shards=2),
                          device="cpu", metrics=Metrics()))
    post = ("POST", "/v1/GetRateLimits", _traffic())
    blobs = {}

    async def run(inst, build):
        app = build(inst)
        first = await _call(app, [post] + [
            ("GET", f"/v1/admin/snapshot{q}", None)
            for q in ("", "?layout=int64", "?layout=compact32")])
        blob = first[2][2]
        blobs.setdefault("int64", []).append(blob)
        later = await _call(app, [
            ("POST", "/v1/admin/restore", blob),
            ("POST", f"/v1/admin/restore?rebase_to={T0 + 5000}", blob),
            ("POST", "/v1/admin/restore", b"not a snapshot"),
            ("POST", "/v1/admin/restore", blob[:len(blob) // 2]),
            ("POST", "/v1/admin/restore", blob[:20] + b"\x00" + blob[21:]),
            post])
        return first, later

    try:
        want = asyncio.run(run(jinst, jbuild_app))
        got = asyncio.run(run(pinst, build_app))
    finally:
        jinst.close()
        pinst.close()
    assert got == want
    first, later = got
    assert [c[0] for c in first] == [200] * 4
    assert first[1][1] == "application/octet-stream"
    assert first[1][2] == first[3][2]  # auto is compact32 while sound
    assert later[0][2]["restoredKeys"] > 0
    assert [c[0] for c in later[2:5]] == [400] * 3
    assert all(c[2]["code"] == 3 for c in later[2:5])


def test_admin_restore_over_one_mib_succeeds(pinned):
    """A 64k-slot arena's blob is past aiohttp's 1 MiB default body cap;
    the gateway's 1 GiB cap takes it."""
    geom = dict(GEOMETRY, capacity_per_shard=1 << 16)
    src = Instance(engine=pengine.RateLimitEngine(**geom, device="cpu"))
    src.engine.process([RateLimitReq(name="big", unique_key=f"k{i}",
                                     hits=1, limit=5, duration=60_000)
                        for i in range(50)])
    blob = snapmod.dumps(src.engine.export_state(layout="int64"))
    src.close()
    assert len(blob) > 1 << 20
    dst = _pin(Instance(engine=pengine.RateLimitEngine(**geom,
                                                       device="cpu")))
    try:
        (status, ctype, body), = asyncio.run(_call(
            build_app(dst), [("POST", "/v1/admin/restore", blob)]))
        assert (status, body) == (200, {"restoredKeys": 50})
        out = dst.engine.process([RateLimitReq(
            name="big", unique_key="k7", hits=1, limit=5, duration=60_000)])
        assert out[0].remaining == 3
    finally:
        dst.close()
