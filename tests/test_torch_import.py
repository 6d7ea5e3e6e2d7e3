"""The PyTorch port stands alone: importing it loads no JAX, nothing of the
JAX package, and none of grpc, protobuf, aiohttp and prometheus_client
(only the transport modules import those; the peer ring's modules load
without them and build their gRPC transport on first use); its wire enums equal the JAX
package's; its entry points refuse a CUDA device that is not there."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gubernator_tpu.api.types as jtypes
import gubernator_tpu.core.engine as jengine
import gubernator_tpu_torch as gt
from gubernator_tpu_torch.core.engine import (
    RateLimitEngine,
    resolve_device,
    shard_of,
)

pytestmark = pytest.mark.torch_port

_ENTRY_MODULES = ("gubernator_tpu_torch", "gubernator_tpu_torch.core.service",
                  "gubernator_tpu_torch.core.engine",
                  "gubernator_tpu_torch.ops.drain_kernel",
                  "gubernator_tpu_torch.ops.global_kernel",
                  "gubernator_tpu_torch.ops.stats_kernel",
                  "gubernator_tpu_torch.ops.window_math_kernel",
                  "gubernator_tpu_torch.config",
                  "gubernator_tpu_torch.ops.analytics",
                  "gubernator_tpu_torch.observability.analytics",
                  "gubernator_tpu_torch.native",
                  "gubernator_tpu_torch.core.window_buffers",
                  "gubernator_tpu_torch.core.pipeline",
                  "gubernator_tpu_torch.qos.fairness",
                  "gubernator_tpu_torch.core.batcher",
                  "gubernator_tpu_torch.server",
                  "gubernator_tpu_torch.state.snapshot",
                  "gubernator_tpu_torch.state.tiers",
                  "gubernator_tpu_torch.algorithms",
                  "gubernator_tpu_torch.algorithms.leases",
                  "gubernator_tpu_torch.algorithms.oracles",
                  "gubernator_tpu_torch.qos",
                  "gubernator_tpu_torch.qos.admission",
                  "gubernator_tpu_torch.qos.congestion",
                  "gubernator_tpu_torch.qos.breaker",
                  "gubernator_tpu_torch.net.peers",
                  "gubernator_tpu_torch.net.faults",
                  "gubernator_tpu_torch.core.global_sync",
                  "gubernator_tpu_torch.parallel.router",
                  "gubernator_tpu_torch.observability.tracing",
                  "gubernator_tpu_torch.discovery.static",
                  "gubernator_tpu_torch.net.health",
                  "gubernator_tpu_torch.state.migrate",
                  "gubernator_tpu_torch.frontdoor",
                  "gubernator_tpu_torch.frontdoor_replay",
                  "gubernator_tpu_torch.core.shm_ring",
                  "gubernator_tpu_torch.observability.introspect",
                  "gubernator_tpu_torch.observability.devprof",
                  "gubernator_tpu_torch.observability",
                  "gubernator_tpu_torch.cmd.cli",
                  "gubernator_tpu_torch.cmd.cluster_main")


@pytest.mark.parametrize("module", _ENTRY_MODULES)
def test_import_loads_no_jax_grpc_or_protobuf(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'gubernator_tpu', 'grpc', 'aiohttp', "
        "'prometheus_client') "
        "or m.startswith('google.protobuf')]\n"
        "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"{module} pulled in {res.stdout}"


@pytest.mark.parametrize("module", [
    "gubernator_tpu_torch.observability.devprof",
    "gubernator_tpu_torch.observability.introspect",
    "gubernator_tpu_torch.observability",
    "gubernator_tpu_torch.cmd.cli",
])
def test_profiling_modules_and_the_cli_load_no_torch(module):
    """The device profiler's modules import torch only where a capture or
    a census runs, and the operator CLI never: `python -m
    gubernator_tpu_torch.cmd.cli` runs on a box with no card."""
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "print(','.join(sorted({m.split('.')[0] for m in sys.modules}\n"
        "      & {'torch', 'jax', 'jaxlib', 'gubernator_tpu'})))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", f"{module} pulled in {res.stdout}"


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """chip_smoke.py exits at once without a card, so its imports are read
    from its source: torch, numpy, the standard library and the port."""
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    roots = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "gubernator_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "gubernator_tpu", "grpc", "google",
                        "aiohttp", "prometheus_client"}


@pytest.mark.parametrize("name", ["Algorithm", "Behavior", "Status"])
def test_enum_values_match_jax_package(name):
    port, ref = getattr(gt, name), getattr(jtypes, name)
    assert {m.name: int(m) for m in port} == {m.name: int(m) for m in ref}


def test_duration_constants_and_hash_key_match():
    assert (gt.Millisecond, gt.Second, gt.Minute, gt.Hour) == (
        jtypes.Millisecond, jtypes.Second, jtypes.Minute, jtypes.Hour)
    assert (gt.RateLimitReq(name="n", unique_key="k").hash_key()
            == jtypes.RateLimitReq(name="n", unique_key="k").hash_key())


def test_shard_of_matches_jax_package():
    keys = [f"n_k{i}" for i in range(200)] + ["", "ü-ключ", "a" * 300]
    for S in (1, 3, 8):
        assert [shard_of(k, S) for k in keys] == [
            jengine.shard_of(k, S) for k in keys]


def test_default_device_is_cuda_or_raises():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RateLimitEngine(capacity_per_shard=8, batch_per_shard=8)
    assert resolve_device("cpu").type == "cpu"


def test_peer_client_connects_without_grpc_through_its_transport_seam():
    """In a fresh interpreter where grpc and protobuf cannot be imported,
    a ring of PeerClients over an in-process transport forwards, batches
    and pushes GLOBAL updates: nothing above the transport seam needs
    either library."""
    code = (
        "import sys, asyncio\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('grpc', 'google', 'jax',\n"
        "                                  'gubernator_tpu'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from gubernator_tpu_torch.api.types import RateLimitReq, "
        "RateLimitResp\n"
        "from gubernator_tpu_torch.config import BehaviorConfig\n"
        "from gubernator_tpu_torch.net.peers import PeerClient\n"
        "class T:\n"
        "    errors = ()\n"
        "    async def get_peer_rate_limits(self, reqs, timeout, metadata):\n"
        "        return [RateLimitResp(remaining=r.limit - r.hits) "
        "for r in reqs]\n"
        "    async def update_peer_globals(self, g, timeout): self.g = g\n"
        "    async def close(self): pass\n"
        "async def main():\n"
        "    t = T()\n"
        "    p = PeerClient(BehaviorConfig(), 'h:1', transport=t)\n"
        "    out = await asyncio.gather(*(p.get_peer_rate_limit(\n"
        "        RateLimitReq(name='n', unique_key=str(i), hits=i, "
        "limit=9)) for i in range(3)))\n"
        "    await p.update_peer_globals(['x'])\n"
        "    await p.close()\n"
        "    print([r.remaining for r in out], t.g)\n"
        "asyncio.run(main())\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[9, 8, 7] ['x']"


# what a front-door worker process imports (frontdoor.py worker_main,
# frontdoor_replay.py replay_main and the calls they make)
_WORKER_IMPORTS = ("gubernator_tpu_torch.frontdoor",
                   "gubernator_tpu_torch.frontdoor_replay",
                   "gubernator_tpu_torch.core.shm_ring",
                   "gubernator_tpu_torch.native",
                   "gubernator_tpu_torch.api.pb",
                   "gubernator_tpu_torch.api.grpc_api",
                   "gubernator_tpu_torch.api.types",
                   "gubernator_tpu_torch.qos.admission",
                   "gubernator_tpu_torch.observability.tracing")


def test_front_door_worker_imports_load_no_torch_jax_or_jax_package():
    """In a fresh interpreter, the front door worker's import set (gRPC
    and protobuf included) loads neither torch, jax nor the JAX package."""
    code = (
        "import sys, importlib\n"
        f"for m in {_WORKER_IMPORTS!r}:\n"
        "    importlib.import_module(m)\n"
        "from gubernator_tpu_torch import native\n"
        "native.prebuilt_only()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'jaxlib', 'gubernator_tpu')]\n"
        "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "", res.stdout


def test_front_door_hub_engine_side_loads_no_grpc():
    """The hub's engine side (frontdoor.py with server.py and the
    Instance) loads no grpc: a hub is built on a CPU Instance and its
    context shim aborts with integer codes."""
    code = (
        "import sys, asyncio\n"
        "from gubernator_tpu_torch.core.service import Instance\n"
        "from gubernator_tpu_torch.config import EngineConfig\n"
        "from gubernator_tpu_torch.frontdoor import (FrontdoorHub,\n"
        "    FrontdoorAbort, _EngineContext)\n"
        "import gubernator_tpu_torch.server\n"
        "inst = Instance(engine_config=EngineConfig(capacity_per_shard=64,\n"
        "    batch_per_shard=16, num_shards=1), device='cpu')\n"
        "hub = FrontdoorHub(inst, 2, 4, 1 << 16, '127.0.0.1:0')\n"
        "try:\n"
        "    asyncio.run(gubernator_tpu_torch.server._abort(\n"
        "        _EngineContext(), 'OUT_OF_RANGE', 'x'))\n"
        "except FrontdoorAbort as e:\n"
        "    print(e.code)\n"
        "inst.close()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] == 'grpc']\n"
        "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[:2] == ["11", ""], res.stdout
