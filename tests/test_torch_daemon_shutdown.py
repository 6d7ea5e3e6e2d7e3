"""The port daemon's graceful departure: the JAX daemon's shutdown contract.

The mirror of tests/test_daemon_shutdown.py against the port's Daemon:
`Daemon.stop()` (gubernator_tpu_torch/daemon.py) runs its phases in the
JAX daemon's order (stop the detector, drain admitted work, flush the
GLOBAL plane, hand the owned key space to the survivors, the final
snapshot, teardown), every phase tolerant of an exception in an earlier
one, and the handoff skipped when no survivor exists.  The phase names
land in `daemon.shutdown_phases` as they run; each contract is checked
on the JAX daemon too, on the same fake Instance, where it can run.  A
real daemon on the CPU with a static peer walks the same phases, its
handoff failing on the native router as the JAX daemon's does, and a
Python-table daemon leaving a two-node ring hands its keys to the
survivor, which answers them where they were.
"""

import asyncio
import os
import signal
import socket
from types import SimpleNamespace

import pytest

import gubernator_tpu.daemon as jdaemon_mod
import gubernator_tpu_torch.daemon as daemon_mod
from gubernator_tpu.config import DaemonConfig as JDaemonConfig
from gubernator_tpu_torch import config as pconfig
from gubernator_tpu_torch.api.types import RateLimitReq, Second
from gubernator_tpu_torch.client import AsyncClient
from gubernator_tpu_torch.config import DaemonConfig
from gubernator_tpu_torch.daemon import Daemon

from .test_torch_daemon import _rings_settle

pytestmark = pytest.mark.torch_port

SURVIVING = ["monitor_stop", "drain", "global_flush", "handoff", "snapshot",
             "teardown"]


class FakeGlobalMgr:
    def __init__(self, calls):
        self.calls = calls

    async def flush(self):
        self.calls.append("global_flush")

    def stop(self):
        self.calls.append("global_stop")


class FakeInstance:
    """Records every call the stop makes, in order."""

    def __init__(self, peers=("self:1", "peer:2", "peer:3"),
                 drain_raises=False):
        self.advertise_address = "self:1"
        self.calls = []
        self._peers = list(peers)
        self.drain_raises = drain_raises
        self.global_mgr = FakeGlobalMgr(self.calls)
        self.migrations = []

    async def drain(self, timeout):
        self.calls.append("drain")
        if self.drain_raises:
            raise RuntimeError("drain exploded")
        return True

    def peer_list(self):
        return [SimpleNamespace(host=h) for h in self._peers]

    async def migrate_keys(self, old_hosts, new_hosts):
        self.calls.append("migrate")
        self.migrations.append((list(old_hosts), list(new_hosts)))
        return {"moved": 0}

    async def save_snapshot(self, path, layout="auto"):
        self.calls.append("snapshot")
        return 0

    async def aclose(self):
        self.calls.append("aclose")


class FakeMonitor:
    def __init__(self, calls):
        self.calls = calls

    async def stop(self):
        self.calls.append("monitor_stop")


def _daemon(mod, inst, with_monitor=True, with_snapshot_task=False,
            loop=None):
    """A daemon of either package (`mod`) around a fake Instance."""
    if mod is daemon_mod:
        d = Daemon(DaemonConfig(snapshot_dir="/tmp"))
        d.conf.drain_timeout = 2.0
    else:
        d = jdaemon_mod.Daemon(JDaemonConfig(snapshot_dir="/tmp"))
        d.conf.health.drain_timeout = 2.0
    d.instance = inst
    if with_monitor:
        d.monitor = FakeMonitor(inst.calls)
    if with_snapshot_task:
        d._snapshot_task = loop.create_task(asyncio.sleep(600))

        async def snap_once():
            inst.calls.append("snapshot")

        d._snapshot_once = snap_once
    return d


@pytest.mark.parametrize("mod", [daemon_mod, jdaemon_mod],
                         ids=["port", "jax"])
def test_stop_phase_ordering_with_surviving_ring(mod):
    async def body():
        inst = FakeInstance()
        d = _daemon(mod, inst, with_snapshot_task=True,
                    loop=asyncio.get_running_loop())
        await asyncio.wait_for(d.stop(), timeout=10)
        return d, inst

    d, inst = asyncio.run(body())
    assert d.shutdown_phases == SURVIVING
    # the calls the phases made, in the same order
    assert inst.calls == ["monitor_stop", "drain", "global_flush", "migrate",
                          "snapshot", "aclose"]
    # the handoff diffed the full membership -> the membership minus self
    assert inst.migrations == [
        (["self:1", "peer:2", "peer:3"], ["peer:2", "peer:3"])]


@pytest.mark.parametrize("mod", [daemon_mod, jdaemon_mod],
                         ids=["port", "jax"])
def test_stop_skips_handoff_with_no_surviving_ring(mod):
    """The last node standing: the handoff has no destination, so it is
    skipped (and recorded so), not hung until the migrate timeout."""
    async def body():
        inst = FakeInstance(peers=("self:1",))
        d = _daemon(mod, inst)
        await asyncio.wait_for(d.stop(), timeout=5)
        return d, inst

    d, inst = asyncio.run(body())
    assert d.shutdown_phases == ["monitor_stop", "drain", "global_flush",
                                 "handoff_skipped", "teardown"]
    assert "migrate" not in inst.calls
    assert inst.calls[-1] == "aclose"


@pytest.mark.parametrize("mod", [daemon_mod, jdaemon_mod],
                         ids=["port", "jax"])
def test_stop_phase_failure_does_not_skip_later_phases(mod):
    async def body():
        inst = FakeInstance(drain_raises=True)
        d = _daemon(mod, inst)
        await asyncio.wait_for(d.stop(), timeout=10)
        return d, inst

    d, inst = asyncio.run(body())
    # the drain raised, but the flush, the handoff and the teardown still
    # ran: a failed phase never strands the key space
    assert d.shutdown_phases == ["monitor_stop", "drain", "global_flush",
                                 "handoff", "teardown"]
    assert inst.calls[-2:] == ["migrate", "aclose"]


def test_stop_phase_bounds_a_hung_handoff():
    """Each phase is bounded: a handoff that never returns gives up at the
    drain timeout and the snapshot and teardown still run."""
    class Hung(FakeInstance):
        async def migrate_keys(self, old_hosts, new_hosts):
            self.calls.append("migrate")
            await asyncio.sleep(600)

    async def body():
        inst = Hung()
        d = _daemon(daemon_mod, inst, with_snapshot_task=True,
                    loop=asyncio.get_running_loop())
        d.conf.drain_timeout = 0.05
        await asyncio.wait_for(d.stop(), timeout=10)
        return d, inst

    d, inst = asyncio.run(body())
    assert d.shutdown_phases == SURVIVING
    assert inst.calls[-3:] == ["migrate", "snapshot", "aclose"]


@pytest.mark.parametrize("mod,conf", [(daemon_mod, DaemonConfig),
                                      (jdaemon_mod, JDaemonConfig)],
                         ids=["port", "jax"])
def test_stop_without_instance_is_a_noop_walk(mod, conf):
    async def body():
        d = mod.Daemon(conf())
        await asyncio.wait_for(d.stop(), timeout=5)
        return d

    assert asyncio.run(body()).shutdown_phases == [
        "monitor_stop", "drain", "global_flush", "teardown"]


def test_sigterm_drives_the_full_graceful_stop(monkeypatch):
    """End to end: a real SIGTERM to the process walks _amain into
    Daemon.stop() and the phase contract holds."""
    built = []

    class WiredDaemon(Daemon):
        async def start(self):
            self.instance = FakeInstance(peers=("self:1", "peer:2"))
            self.monitor = FakeMonitor(self.instance.calls)
            built.append(self)

    monkeypatch.setattr(daemon_mod, "Daemon", WiredDaemon)

    async def body():
        loop = asyncio.get_running_loop()
        task = loop.create_task(daemon_mod._amain(DaemonConfig()))
        try:
            await asyncio.sleep(0.05)  # let _amain install its handlers
            os.kill(os.getpid(), signal.SIGTERM)
            await asyncio.wait_for(task, timeout=15)
        finally:
            task.cancel()
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    loop.remove_signal_handler(sig)
                except (ValueError, RuntimeError):
                    pass

    asyncio.run(body())
    (d,) = built
    assert d.shutdown_phases == ["monitor_stop", "drain", "global_flush",
                                 "handoff", "teardown"]
    assert d.instance.calls == ["monitor_stop", "drain", "global_flush",
                                "migrate", "aclose"]


# ------------------------------------------------------ real daemons, CPU


SMALL = {"GUBER_TORCH_DEVICE": "cpu",
         "GUBER_HTTP_ADDRESS": "127.0.0.1:0",
         "GUBER_TPU_CAPACITY_PER_SHARD": "256",
         "GUBER_TPU_BATCH_PER_SHARD": "64",
         "GUBER_TPU_GLOBAL_CAPACITY": "16",
         "GUBER_HEARTBEAT_INTERVAL_MS": "50"}


@pytest.fixture
def clean_env(monkeypatch):
    saved = dict(os.environ)
    for k in list(os.environ):
        if k.startswith("GUBER_"):
            monkeypatch.delenv(k)
    yield monkeypatch
    os.environ.clear()
    os.environ.update(saved)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _confs(clean_env, extra):
    addrs = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    confs = []
    for a in addrs:
        for k, v in {**SMALL, **extra, "GUBER_GRPC_ADDRESS": a,
                     "GUBER_STATIC_PEERS": ",".join(addrs)}.items():
            clean_env.setenv(k, v)
        confs.append(pconfig.config_from_env())
    return addrs, confs


def _reqs(n=64):
    return [RateLimitReq(name="bye", unique_key=f"k{i}", hits=1, limit=5,
                         duration=60 * Second) for i in range(n)]


@pytest.mark.parametrize("native", ["1", "0"], ids=["router", "tables"])
def test_daemon_leaving_a_ring_hands_its_keys_to_the_survivor(clean_env,
                                                              native):
    """Two daemons with GUBER_STATIC_PEERS, each running its heartbeat
    detector.  The first stops: its phases are the JAX daemon's with a
    handoff.  On the Python tables (GUBER_NATIVE=0) the handoff ships its
    keys, so the survivor answers them where the departed node left
    them; on the native router the handoff fails as in the JAX package
    (a logged RuntimeError) and those keys restart cold there."""
    addrs, confs = _confs(clean_env, {"GUBER_NATIVE": native})
    reqs = _reqs()

    async def body():
        ds = [Daemon(c) for c in confs]
        for d in ds:
            await d.start()
        try:
            assert all(d.monitor is not None for d in ds)
            await _rings_settle(ds, addrs)
            assert ds[0].instance.monitor is ds[0].monitor
            owner = ds[0].instance.get_peer
            mine = [r for r in reqs
                    if owner(r.hash_key()).host == addrs[0]]
            client = AsyncClient(addrs[0])
            await client.get_rate_limits(reqs)
            await client.close()
            await ds[0].stop()
            # the survivor re-homes once it confirms the departed node down
            for _ in range(200):
                if len(ds[1].instance.peer_list()) == 1:
                    break
                await asyncio.sleep(0.05)
            client = AsyncClient(addrs[1])
            after = await client.get_rate_limits(mine)
            await client.close()
            return ds, mine, after
        finally:
            await ds[1].stop()

    ds, mine, after = asyncio.run(body())
    assert mine
    assert ds[0].shutdown_phases == SURVIVING[:-2] + ["teardown"]
    assert len(ds[1].instance.peer_list()) == 1
    assert all(r.error == "" for r in after)
    want = 3 if native == "0" else 4
    assert [r.remaining for r in after] == [want] * len(mine)
    assert ds[1].shutdown_phases == ["monitor_stop", "drain", "global_flush",
                                     "handoff_skipped", "teardown"]
