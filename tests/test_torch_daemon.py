"""The port's daemon config and composition root (config.py
DaemonConfig / config_from_env / load_env_file, daemon.py, __main__.py).

config_from_env must give the JAX package's values for every knob the
port serves, on defaults, overrides and an env-file, and raise where the
JAX function raises; a knob of a subsystem the port has not ported raises
ValueError naming its ROADMAP item unless it is at its default.  A daemon
on GUBER_TORCH_DEVICE=cpu serves the port's client over loopback gRPC and
its HTTP gateway, a real SIGTERM walks its graceful stop in the JAX
daemon's phase order, and `python -m gubernator_tpu_torch.daemon --config
FILE` boots, answers and exits 0 on SIGTERM.  The state lifecycle's knobs
(GUBER_SNAPSHOT_*, GUBER_TIER_*) are served since the port has snapshots
and tiers: they are held against the JAX function like the rest
(tests/test_torch_daemon_snapshot.py drives them), and so are the peer
ring's (GUBER_STATIC_PEERS, GUBER_ADVERTISE_ADDRESS, the batch timeout,
GUBER_GLOBAL_*, GUBER_HINT_*, GUBER_TRACE_*) and the failure detector's
(GUBER_HEARTBEAT_*).  Two daemons given each other as GUBER_STATIC_PEERS
forward a key to its owner, and a GUBER_FAULTS rule on the snapshot_io
seam fails the daemon's saves, never its boot or its serving.
"""

import asyncio
import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import aiohttp
import pytest
import torch

import gubernator_tpu  # noqa: F401
import gubernator_tpu.config as jconfig
import gubernator_tpu_torch.daemon as daemon_mod
from gubernator_tpu_torch import config as pconfig
from gubernator_tpu_torch.api.types import RateLimitReq, Second
from gubernator_tpu_torch.client import AsyncClient, Client

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"GUBER_TORCH_DEVICE": "cpu", "GUBER_GRPC_ADDRESS": "127.0.0.1:0",
         "GUBER_HTTP_ADDRESS": "127.0.0.1:0",
         "GUBER_TPU_CAPACITY_PER_SHARD": "256",
         "GUBER_TPU_BATCH_PER_SHARD": "64",
         "GUBER_TPU_GLOBAL_CAPACITY": "16"}
# the JAX daemon's stop phases, in its order (gubernator_tpu/daemon.py)
JAX_PHASES = ["monitor_stop", "drain", "global_flush", "handoff",
              "handoff_skipped", "snapshot", "teardown"]


@pytest.fixture
def clean_env(monkeypatch):
    """No GUBER_* variable set; everything an env-file loads is undone."""
    saved = dict(os.environ)
    for k in list(os.environ):
        if k.startswith("GUBER_"):
            monkeypatch.delenv(k)
    yield monkeypatch
    os.environ.clear()
    os.environ.update(saved)


def _served(c, jax_side):
    """The knobs the port serves, from either package's DaemonConfig."""
    e, b = c.engine, c.behaviors
    return {
        "grpc": c.grpc_listen_address, "http": c.http_listen_address,
        "cache_size": c.cache_size, "debug": c.debug,
        "batch_wait": b.batch_wait, "batch_limit": b.batch_limit,
        "capacity": e.capacity_per_shard, "lanes": e.batch_per_shard,
        "global_capacity": e.global_capacity, "use_native": e.use_native,
        "exact_keys": e.exact_keys, "replay_cap": e.replay_cap,
        "analytics": dataclasses.asdict(c.analytics),
        "slo": dataclasses.asdict(c.slo),
        "drain_timeout": (c.health.drain_timeout if jax_side
                          else c.drain_timeout),
        "snapshot_dir": c.snapshot_dir,
        "snapshot_interval_ms": c.snapshot_interval_ms,
        "tiers": dataclasses.asdict(c.tiers),
        "qos": dataclasses.asdict(c.qos),
        "leases": dataclasses.asdict(c.leases),
        "advertise": c.advertise_address,
        "batch_timeout": b.batch_timeout,
        "global_sync_wait": b.global_sync_wait,
        "global_timeout": b.global_timeout,
        "global_batch_limit": b.global_batch_limit,
        "hint_ttl": c.health.hint_ttl, "hint_max": c.health.hint_max,
        "heartbeat": (c.health.heartbeat_enabled,
                      c.health.heartbeat_interval,
                      c.health.heartbeat_timeout, c.health.suspect_after,
                      c.health.recover_after),
    }


def _both(env_file=None):
    got = []
    for mod, jax_side in ((jconfig, True), (pconfig, False)):
        try:
            got.append(_served(mod.config_from_env(env_file), jax_side))
        except ValueError as e:
            got.append(("ValueError", str(e)))
    return got


OVERRIDES = {
    "GUBER_GRPC_ADDRESS": "0.0.0.0:9999", "GUBER_HTTP_ADDRESS": "h:8080",
    "GUBER_CACHE_SIZE": "777", "GUBER_DEBUG": "yes",
    "GUBER_BATCH_WAIT": "0.002",
    "GUBER_BATCH_LIMIT": "500", "GUBER_TPU_BATCH_PER_SHARD": "128",
    "GUBER_TPU_GLOBAL_CAPACITY": "64", "GUBER_NATIVE": "0",
    "GUBER_EXACT_KEYS": "1", "GUBER_REPLAY_CAP": "7",
    "GUBER_ANALYTICS": "1", "GUBER_ANALYTICS_TOPK": "5",
    "GUBER_ANALYTICS_DECAY_MS": "0", "GUBER_SLO": "true",
    "GUBER_SLO_DRAIN_P99_MS": "50", "GUBER_DRAIN_TIMEOUT_MS": "1500",
    "GUBER_SNAPSHOT_DIR": "/var/lib/guber", "GUBER_SNAPSHOT_INTERVAL_MS": "50",
    "GUBER_TIER_WARM": "4096", "GUBER_TIER_LAYOUT": "compact32",
    "GUBER_TIER_DEMOTE_BATCH": "16",
    "GUBER_QOS_MAX_PENDING": "512", "GUBER_QOS_TARGET_DRAIN_MS": "25",
    "GUBER_QOS_FAIR_SLOTTING": "off", "GUBER_QOS_DEFAULT_DEADLINE_MS": "900",
    "GUBER_QOS_AIMD_DECREASE": "0.25", "GUBER_LEASE_SWEEP_MS": "250",
    "GUBER_LEASE_RELEASE_ON_CLOSE": "0",
}


@pytest.mark.parametrize("env", [
    {},
    OVERRIDES,
    {"GUBER_TPU_CAPACITY_PER_SHARD": "4096", "GUBER_CACHE_SIZE": "10",
     "GUBER_NATIVE": "true",
     "GUBER_ANALYTICS_TENANTS": "1", "GUBER_DRAIN_TIMEOUT_MS": "junk"},
    {"GUBER_BATCH_LIMIT": "5000"},
    {"GUBER_CACHE_SIZE": "not-a-number"},
    {"GUBER_ANALYTICS_SKETCH_DEPTH": "99"},
    {"GUBER_TIER_WARM": "64", "GUBER_NATIVE": "1",
     "GUBER_SNAPSHOT_INTERVAL_MS": "junk"},
    {"GUBER_TIER_WARM": "64", "GUBER_TIER_LAYOUT": "int16"},
], ids=["defaults", "overrides", "capacity", "batch_limit_cap",
        "bad_cache_size", "bad_sketch_depth", "tiers_force_python",
        "bad_tier_layout"])
def test_config_from_env_equals_the_jax_function(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    got_j, got_p = _both()
    assert got_p == got_j


def test_env_file_equals_the_jax_function(clean_env, tmp_path):
    f = tmp_path / "guber.conf"
    f.write_text("# comment\n\n" + "".join(
        f"{k} = {v}\n" for k, v in OVERRIDES.items()))
    got = []
    for mod, jax_side in ((jconfig, True), (pconfig, False)):
        for k in [k for k in os.environ if k.startswith("GUBER_")]:
            del os.environ[k]  # each function reads the file itself
        got.append(_served(mod.config_from_env(str(f)), jax_side))
    got_j, got_p = got
    assert got_p == got_j and got_p["cache_size"] == 777


def test_malformed_env_file_raises_in_both(clean_env, tmp_path):
    f = tmp_path / "bad.conf"
    f.write_text("GUBER_DEBUG=1\nNOT A KEY VALUE LINE\n")
    for mod in (jconfig, pconfig):
        with pytest.raises(ValueError, match="line '2'"):
            mod.config_from_env(str(f))


def _front_door_and_discovery(c):
    """The front door's and the discovery backends' knobs, from either
    package's DaemonConfig."""
    return {
        "workers": c.frontdoor_workers, "slots": c.shm_ring_slots,
        "slab": c.shm_slab_bytes, "encode": c.frontdoor_encode,
        "batch_reads": c.frontdoor_batch_reads,
        "k8s": (c.k8s_namespace, c.k8s_pod_ip, c.k8s_pod_port,
                c.k8s_endpoints_selector, c.k8s_enabled),
        "etcd": (c.etcd_addresses, c.etcd_prefix, c.etcd_dial_timeout,
                 c.etcd_username, c.etcd_password, c.etcd_enabled),
        "etcd_tls": (c.etcd_tls_enabled, c.etcd_tls_cert, c.etcd_tls_key,
                     c.etcd_tls_ca, c.etcd_tls_skip_verify),
    }


@pytest.mark.parametrize("name,value,read", [
    ("GUBER_K8S_NAMESPACE", "default",
     lambda c: c.k8s_namespace == "default" and c.k8s_enabled),
    ("GUBER_ETCD_ENDPOINTS", "http://e1:2379, http://e2:2379,",
     lambda c: c.etcd_addresses == ["http://e1:2379", "http://e2:2379"]),
    ("GUBER_ETCD_TLS_CA", "/etc/ca.pem",
     lambda c: c.etcd_tls_enabled and c.etcd_tls_ca == "/etc/ca.pem"),
    ("GUBER_K8S_POD_IP", "10.0.0.7", lambda c: c.k8s_pod_ip == "10.0.0.7"),
    ("GUBER_FRONTDOOR_WORKERS", "2", lambda c: c.frontdoor_workers == 2),
])
def test_front_door_and_discovery_knob_reads_as_the_jax_function(
        clean_env, name, value, read):
    """The front door's and the discovery backends' knobs are served now
    (they raised while unported): the port's config_from_env reads each
    as the JAX function does, the rest of the config unchanged."""
    clean_env.setenv(name, value)
    got_j, got_p = _both()
    assert got_p == got_j
    c = pconfig.config_from_env()
    assert read(c)
    assert (_front_door_and_discovery(c)
            == _front_door_and_discovery(jconfig.config_from_env()))


@pytest.mark.parametrize("env", [
    {"GUBER_SHM_RING_SLOTS": "1", "GUBER_SHM_SLAB_BYTES": "1000",
     "GUBER_FRONTDOOR_ENCODE": "bogus", "GUBER_FRONTDOOR_BATCH_READS": "-3"},
    {"GUBER_SHM_RING_SLOTS": "16", "GUBER_FRONTDOOR_ENCODE": "engine",
     "GUBER_FRONTDOOR_BATCH_READS": "0", "GUBER_ETCD_KEY_PREFIX": "/p/",
     "GUBER_ETCD_DIAL_TIMEOUT": "2.5", "GUBER_ETCD_USER": "u",
     "GUBER_ETCD_TLS_SKIP_VERIFY": "yes", "GUBER_K8S_POD_PORT": "81",
     "GUBER_K8S_ENDPOINTS_SELECTOR": "app=g"},
], ids=["floors", "every_knob"])
def test_front_door_and_discovery_knobs_clamp_as_the_jax_function(clean_env,
                                                                  env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert (_front_door_and_discovery(pconfig.config_from_env())
            == _front_door_and_discovery(jconfig.config_from_env()))


def test_both_discovery_backends_raise_in_both(clean_env):
    clean_env.setenv("GUBER_K8S_NAMESPACE", "ns")
    clean_env.setenv("GUBER_ETCD_ENDPOINTS", "http://e:2379")
    got_j, got_p = _both()
    assert got_p == got_j and got_p[0] == "ValueError"


@pytest.mark.parametrize("name,value,item", [
    ("GUBER_MESH_PEERS", "127.0.0.1:1", 8),
    ("GUBER_MESH_COORDINATOR", "127.0.0.1:2", 8),
    ("GUBER_LOCKSTEP_STACK", "2", 8),
    ("GUBER_SKIP_GLOBAL", "1", 8),
])
def test_unported_knob_raises_naming_its_roadmap_item(clean_env, name,
                                                      value, item):
    """ROADMAP item 8's knobs raised while mesh serving was unported (the
    name is kept from then); they are served now, and config_from_env
    raises for none and reads each as the JAX package's does:
    GUBER_LOCKSTEP_STACK into behaviors.lockstep_stack, GUBER_SKIP_GLOBAL
    into engine.skip_global (gubernator_tpu/config.py:666, :687).
    GUBER_MESH_* are no config knobs in either package: the daemon and
    parallel/distributed.py read them from the environment, both config
    objects stay at their defaults."""
    assert item == 8
    clean_env.setenv(name, value)
    got_j, got_p = _both()
    assert got_p == got_j and isinstance(got_p, dict)
    jc, pc = jconfig.config_from_env(), pconfig.config_from_env()
    read = (pc.behaviors.lockstep_stack, pc.engine.skip_global)
    assert read == (jc.behaviors.lockstep_stack, jc.engine.skip_global)
    assert read == {"GUBER_LOCKSTEP_STACK": (2, False),
                    "GUBER_SKIP_GLOBAL": (1, True)}.get(name, (1, False))


@pytest.mark.parametrize("name,value,knob,want", [
    ("GUBER_DEVPROF", "periodic", "devprof_mode", "periodic"),
    ("GUBER_DEVPROF_INTERVAL_S", "0.01", "devprof_interval_s", 0.05),
    ("GUBER_DEVPROF_DRAINS", "3", "devprof_drains", 3),
    ("GUBER_DEVPROF_RING", "9", "devprof_ring", 9),
    ("GUBER_DEVPROF_SLOW_MS", "12.5", "devprof_slow_ms", 12.5),
])
def test_devprof_knob_reads_as_the_jax_function(clean_env, name, value,
                                                 knob, want):
    """The device profiler's knobs are served now (GUBER_DEVPROF raised
    while it was unported): the port's config_from_env reads each as the
    JAX package's Config does (gubernator_tpu/config.py:416-431), the
    interval's 0.05 s floor included."""
    clean_env.setenv(name, value)
    got = getattr(pconfig.config_from_env(), knob)
    assert got == getattr(jconfig.Config(), knob) == want


@pytest.mark.parametrize("name,value,section,knob,want", [
    ("GUBER_QOS_ENABLED", "1", "qos", "enabled", True),
    ("GUBER_QOS_MAX_PENDING", "10", "qos", "max_pending", 10),
    ("GUBER_LEASE_SWEEP_MS", "0", "leases", "sweep_interval_ms", 0),
    ("GUBER_LEASE_MAX_PER_CLIENT", "3", "leases", "max_per_client", 3),
])
def test_qos_and_lease_knob_reads_as_the_jax_function(clean_env, name, value,
                                                      section, knob, want):
    """The QoS and lease knobs are served now (they raised while their
    subsystems were unported): the port's config_from_env reads each as
    the JAX function does."""
    clean_env.setenv(name, value)
    got_j, got_p = _both()
    assert got_p == got_j
    assert got_p[section][knob] == want


@pytest.mark.parametrize("name,value,read", [
    ("GUBER_STATIC_PEERS", "127.0.0.1:1, 127.0.0.1:2,",
     lambda c: c.static_peers == ["127.0.0.1:1", "127.0.0.1:2"]),
    ("GUBER_ADVERTISE_ADDRESS", "10.0.0.5:81",
     lambda c: c.advertise_address == "10.0.0.5:81"),
    ("GUBER_BATCH_TIMEOUT", "0.25",
     lambda c: c.behaviors.batch_timeout == 0.25),
    ("GUBER_GLOBAL_TIMEOUT", "0.25",
     lambda c: c.behaviors.global_timeout == 0.25),
    ("GUBER_GLOBAL_BATCH_LIMIT", "100",
     lambda c: c.behaviors.global_batch_limit == 100),
    ("GUBER_GLOBAL_SYNC_WAIT", "0.01",
     lambda c: c.behaviors.global_sync_wait == 0.01),
    ("GUBER_HINT_TTL_MS", "1000", lambda c: c.health.hint_ttl == 1.0),
    ("GUBER_HINT_MAX", "7", lambda c: c.health.hint_max == 7),
    ("GUBER_FAULTS_SEED", "7", lambda c: True),
    ("GUBER_FAULTS", "peer_rpc:drop=0.5", lambda c: True),
    ("GUBER_TRACE_EXPORT", "stdout", lambda c: c.trace_export == "stdout"),
    ("GUBER_TRACE_SAMPLE", "0.5", lambda c: c.trace_sample == 0.5),
])
def test_peer_ring_knob_reads_as_the_jax_function(clean_env, name, value,
                                                  read):
    """The peer ring's knobs are served now (they raised while it was
    unported): the port reads each as the JAX function (or, for tracing,
    the JAX library Config) does.  GUBER_FAULTS is read by the daemon at
    boot, as in the JAX package."""
    clean_env.setenv(name, value)
    got_j, got_p = _both()
    assert got_p == got_j
    c = pconfig.config_from_env()
    assert read(c)
    jc = jconfig.Config()
    assert (c.trace_sample, c.trace_export) == (jc.trace_sample,
                                                jc.trace_export)
    if name == "GUBER_STATIC_PEERS":
        assert c.advertise_address == c.grpc_listen_address


@pytest.mark.parametrize("name,value,knob,want", [
    ("GUBER_HEARTBEAT_ENABLED", "0", "heartbeat_enabled", False),
    ("GUBER_HEARTBEAT_INTERVAL_MS", "250", "heartbeat_interval", 0.25),
    ("GUBER_HEARTBEAT_SUSPECT", "5", "suspect_after", 5),
    ("GUBER_HEARTBEAT_TIMEOUT_MS", "40", "heartbeat_timeout", 0.04),
    ("GUBER_HEARTBEAT_RECOVER", "4", "recover_after", 4),
    ("GUBER_HEARTBEAT_INTERVAL_MS", "5", "heartbeat_interval", 0.01),
    ("GUBER_HEARTBEAT_SUSPECT", "0", "suspect_after", 1),
    ("GUBER_HEARTBEAT_RECOVER", "junk", "recover_after", 2),
])
def test_heartbeat_knob_reads_as_the_jax_function(clean_env, name, value,
                                                  knob, want):
    """The failure detector's knobs are served (they raised while it was
    unported): the port's config_from_env reads each as the JAX function
    does, its floors and its fallback on a malformed value included."""
    clean_env.setenv(name, value)
    got_j, got_p = _both()
    assert got_p == got_j
    assert getattr(pconfig.config_from_env().health, knob) == want


@pytest.mark.parametrize("name,value", [
    ("GUBER_FRONTDOOR_WORKERS", "0"), ("GUBER_LEASE_SWEEP_MS", "5000"),
    ("GUBER_LEASE_RELEASE_ON_CLOSE", "true"), ("GUBER_QOS_ENABLED", "0"),
    ("GUBER_LOCKSTEP_STACK", "1"), ("GUBER_SNAPSHOT_DIR", ""),
    ("GUBER_ETCD_KEY_PREFIX", "/gubernator/peers/"),
    ("GUBER_BATCH_TIMEOUT", "0.5"), ("GUBER_HEARTBEAT_ENABLED", "true"),
    ("GUBER_HEARTBEAT_RECOVER", "2")])
def test_unported_knob_at_its_default_is_accepted(clean_env, name, value):
    clean_env.setenv(name, value)
    pconfig.config_from_env()


def _reqs(n=120):
    return [RateLimitReq(name="dmn", unique_key=f"k{i % 30}", hits=1,
                         limit=3, duration=Second) for i in range(n)]


def test_sigterm_stops_a_serving_daemon_in_order(clean_env, monkeypatch):
    """A daemon on the CPU answers the port's client over gRPC (a 120-item
    RPC on the bytes lane) and its HTTP gateway; then a real SIGTERM walks
    _amain into Daemon.stop(): drain, then teardown, in the JAX daemon's
    order, and the instance is closed."""
    for k, v in SMALL.items():
        clean_env.setenv(k, v)
    built = []

    class Recorded(daemon_mod.Daemon):
        async def start(self):
            await super().start()
            built.append(self)

    monkeypatch.setattr(daemon_mod, "Daemon", Recorded)

    async def body():
        loop = asyncio.get_running_loop()
        task = loop.create_task(daemon_mod._amain(pconfig.config_from_env()))
        try:
            for _ in range(600):
                if built or task.done():
                    break
                await asyncio.sleep(0.05)
            d = built[0]
            client = AsyncClient(d.grpc.address)
            rs = await client.get_rate_limits(_reqs())
            health = await client.health_check()
            await client.close()
            base = f"http://127.0.0.1:{d.http.port}"
            async with aiohttp.ClientSession() as s:
                async with s.get(base + "/v1/HealthCheck") as r:
                    hjson = await r.json()
                async with s.get(base + "/metrics") as r:
                    text = await r.text()
            os.kill(os.getpid(), signal.SIGTERM)
            await asyncio.wait_for(task, timeout=30)
            return d, rs, health, hjson, text
        finally:
            task.cancel()
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    loop.remove_signal_handler(sig)
                except (ValueError, RuntimeError):
                    pass

    d, rs, health, hjson, text = asyncio.run(body())
    assert [r.remaining for r in rs[:30]] == [2] * 30
    assert [int(r.status) for r in rs[90:]] == [1] * 30
    assert health.status == hjson["status"] == "healthy"
    assert "grpc_request_counts_total" in text and "cache_size 30.0" in text
    assert d.instance.batcher.pipeline.rpc_staged == 1
    assert d.shutdown_phases == ["monitor_stop", "drain", "global_flush",
                                 "handoff_skipped", "teardown"]
    assert d.shutdown_phases == [p for p in JAX_PHASES
                                 if p in d.shutdown_phases]
    assert d.instance.batcher.pipeline._closed


def test_devprof_periodic_daemon_serves_the_profile_and_kernels_routes(
        clean_env, tmp_path):
    """GUBER_DEVPROF=periodic boots the port's daemon with the periodic
    controller running; POST /v1/admin/profile and GET /v1/admin/kernels
    answer as the JAX routes do (409 while a capture is armed, 400 on a
    bad argument); the census gauge is published at boot; the drain phase
    stops the controller before the teardown."""
    for k, v in SMALL.items():
        clean_env.setenv(k, v)
    clean_env.setenv("GUBER_DEVPROF", "periodic")
    clean_env.setenv("GUBER_DEVPROF_INTERVAL_S", "3600")

    async def body():
        d = daemon_mod.Daemon(pconfig.config_from_env())
        await d.start()
        try:
            client = AsyncClient(d.grpc.address)
            await client.get_rate_limits(_reqs())
            await client.close()
            # the boot's census, queued on the engine thread, has run
            await asyncio.get_running_loop().run_in_executor(
                d.instance.batcher._executor, lambda: None)
            base = f"http://127.0.0.1:{d.http.port}"
            got = {}
            async with aiohttp.ClientSession() as s:
                async with s.get(base + "/v1/admin/debug") as r:
                    got["debug"] = await r.json()
                async with s.post(base + "/v1/admin/profile?drains=x") as r:
                    got["bad"] = r.status
                async with s.post(base + "/v1/admin/profile",
                                  json={"drains": 2, "dir": str(tmp_path)}) \
                        as r:
                    got["armed"] = (r.status, await r.json())
                async with s.post(base + "/v1/admin/profile") as r:
                    got["again"] = r.status
                async with s.get(base + "/v1/admin/kernels?measure=1") as r:
                    got["measure_armed"] = r.status
                d.instance.batcher.profile.cancel()
                async with s.get(base + "/v1/admin/kernels?census=0") as r:
                    got["kernels"] = (r.status, await r.json())
                async with s.get(base + "/metrics") as r:
                    got["metrics"] = await r.text()
        finally:
            await d.stop()
        return d, got

    d, got = asyncio.run(body())
    dp = got["debug"]["devprof"]
    assert dp["mode"] == "periodic" and dp["controller"]["running"] is True
    assert got["bad"] == 400 and got["again"] == 409
    assert got["armed"][0] == 200 and got["armed"][1]["armed"] is True
    assert got["measure_armed"] == 409
    status, kern = got["kernels"]
    assert status == 200 and kern["controller"]["interval_s"] == 3600.0
    assert kern["clock"]["arms"]["composed_drain"]["count"] >= 1
    assert "guber_tpu_kernels_per_window 0.125" in got["metrics"]
    assert d.instance.devprof.controller.status()["running"] is False
    assert d.shutdown_phases == ["monitor_stop", "drain", "global_flush",
                                 "handoff_skipped", "teardown"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_daemon_on_the_default_device_raises_without_a_card(clean_env):
    conf = pconfig.config_from_env()
    assert conf.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(daemon_mod.Daemon(conf).start())


def _read_until(proc, marker, seconds):
    """Lines of the daemon's output up to the first holding `marker`
    (waiting at most `seconds`); fails if the daemon exits first.  A
    thread reads them: a select on the pipe would wait for more bytes
    while the text buffer already holds the marker's line."""
    import threading
    lines, found = [], threading.Event()

    def read():
        for line in iter(proc.stdout.readline, ""):
            lines.append(line)
            if marker in line:
                found.set()
                return
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(seconds)
    if found.is_set():
        return lines
    raise AssertionError(f"no {marker!r} from the daemon:\n{''.join(lines)}")


def test_python_m_daemon_serves_and_exits_on_sigterm(clean_env, tmp_path):
    """`python -m gubernator_tpu_torch.daemon --config FILE --debug` boots
    on the CPU from an env-file (port 0: it logs the port it bound),
    answers the synchronous client, and exits 0 on SIGTERM."""
    f = tmp_path / "daemon.conf"
    f.write_text("".join(f"{k}={v}\n" for k, v in SMALL.items()))
    env = {k: v for k, v in os.environ.items() if not k.startswith("GUBER_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "gubernator_tpu_torch.daemon", "--config",
         str(f), "--debug"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        lines = _read_until(proc, "gRPC listening on ", 120)
        address = lines[-1].rsplit("gRPC listening on ", 1)[1].strip()
        client = Client(address)
        health = client.health_check(timeout=10)
        rs = client.get_rate_limits(_reqs(3), timeout=10)
        client.close()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert health.status == "healthy"
    assert [r.remaining for r in rs] == [2, 2, 2]
    assert proc.returncode == 0, out
    assert "caught signal; shutting down" in out


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _rings_settle(ds, addrs, seconds=30.0):
    """Wait until every daemon's ring holds every address and its detector
    sees every peer UP."""
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if all(sorted(p.host for p in d.instance.peer_list()) == sorted(addrs)
               and all(v["state"] == "up" for v in
                       d.monitor.snapshot()["peers"].values())
               for d in ds):
            return
        await asyncio.sleep(0.02)
    raise AssertionError("the daemons' rings never settled")


def test_two_daemons_with_static_peers_forward_to_the_owner(clean_env):
    """Two daemons given GUBER_STATIC_PEERS naming both (each advertising
    its own gRPC address) build the same ring: a key sent to either is
    decided by its owner, and the non-owner's answer names it."""
    addrs = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    confs = []
    for a in addrs:
        for k, v in {**SMALL, "GUBER_GRPC_ADDRESS": a,
                     "GUBER_STATIC_PEERS": ",".join(addrs)}.items():
            clean_env.setenv(k, v)
        confs.append(pconfig.config_from_env())
    assert [c.advertise_address for c in confs] == addrs

    async def body():
        ds = [daemon_mod.Daemon(c) for c in confs]
        for d in ds:
            await d.start()
        try:
            # each daemon's heartbeat detector probes the other from its
            # start: a peer still booting may be re-homed around and back
            # before both rings settle on both nodes
            await _rings_settle(ds, addrs)
            inst = ds[0].instance
            assert [p.host for p in inst.peer_list()] == addrs
            # four keys each daemon owns (the ports, so the ring, vary)
            pool = [RateLimitReq(name="sp", unique_key=f"k{i}", hits=1,
                                 limit=5, duration=Second)
                    for i in range(4096)]
            reqs = [r for a in addrs for r in [
                q for q in pool
                if inst.get_peer(q.hash_key()).host == a][:4]]
            owners = [inst.get_peer(r.hash_key()).host for r in reqs]
            assert owners == [addrs[0]] * 4 + [addrs[1]] * 4
            out = []
            for a in addrs * 2:
                client = AsyncClient(a)
                out.append(await client.get_rate_limits(reqs))
                await client.close()
            health = await ds[1].instance.health_check()
            return owners, out, health
        finally:
            for d in ds:
                await d.stop()

    owners, out, health = asyncio.run(body())
    assert health.peer_count == 2 and health.status == "healthy"
    for n, (a, rs) in enumerate(zip(addrs * 2, out)):
        assert [r.remaining for r in rs] == [4 - n] * 8
        assert [r.metadata.get("owner", a) for r in rs] == owners


def test_fault_rule_on_an_unwired_seam_fails_the_boot(clean_env, tmp_path):
    """A GUBER_FAULTS rule on snapshot_io (a seam the port crosses now)
    boots: the restore starts cold, the daemon serves, and its failed
    saves are counted and leave the previous snapshot file as it was."""
    from gubernator_tpu_torch.net.faults import FAULTS
    snap_dir = tmp_path / "snaps"
    for k, v in {**SMALL, "GUBER_SNAPSHOT_DIR": str(snap_dir)}.items():
        clean_env.setenv(k, v)

    async def serve(conf):
        d = daemon_mod.Daemon(conf)
        await d.start()
        try:
            client = AsyncClient(d.grpc.address)
            got = await client.get_rate_limits(_reqs(10))
            await client.close()
        finally:
            await d.stop()
        return d, got

    _, first = asyncio.run(serve(pconfig.config_from_env()))
    before = (snap_dir / "arena.snap").read_bytes()
    clean_env.setenv("GUBER_FAULTS", "snapshot_io:error")
    clean_env.setenv("GUBER_FAULTS_SEED", "3")
    try:
        d1, second = asyncio.run(serve(pconfig.config_from_env()))
        assert FAULTS.enabled
        assert FAULTS.describe()["snapshot_io"][0]["fired"] >= 2
    finally:
        FAULTS.clear()
    assert [r.remaining for r in first] == [2] * 10
    # the injected load failure restored nothing: the keys start cold
    assert [r.remaining for r in second] == [2] * 10
    assert d1.shutdown_phases[-2:] == ["snapshot", "teardown"]
    assert d1.instance.metrics.snapshot_total.labels(
        status="failed")._value.get() == 1
    assert (snap_dir / "arena.snap").read_bytes() == before
