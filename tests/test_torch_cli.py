"""The port's operator CLI (gubernator_tpu_torch/cmd/cli.py) against the
JAX package's (gubernator_tpu/cmd/cli.py): both run against the same port
gateway, on an Instance with traffic analytics, the SLO engine, metrics
and tracing, and print the same for `debug`, `slo`, `top` and `kernels
--no-census`; `snapshot` and `restore` round-trip the blob byte for byte,
the JAX CLI pulling the same bytes; and the CLI runs as `python -m`
without loading torch or jax."""

import asyncio
import json
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest

from gubernator_tpu.cmd import cli as jcli
from gubernator_tpu_torch.api.http_gateway import HttpGateway
from gubernator_tpu_torch.cmd import cli
from gubernator_tpu_torch.config import (
    AnalyticsConfig,
    EngineConfig,
    SLOConfig,
)
from gubernator_tpu_torch.core import engine as engine_mod
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.observability.metrics import Metrics
from gubernator_tpu_torch.observability.tracing import Tracer

pytestmark = pytest.mark.torch_port

T0 = 1_760_000_000_000


class _Gateway:
    """A port Instance behind its HTTP gateway on an event loop of its
    own thread, so the CLIs' blocking urllib calls run in the test's."""

    def __init__(self):
        self.inst = Instance(
            engine_config=EngineConfig(
                capacity_per_shard=256, batch_per_shard=64, num_shards=2,
                global_capacity=64, global_batch_per_shard=8,
                max_global_updates=8),
            device="cpu", metrics=Metrics(),
            analytics=AnalyticsConfig(enabled=True, topk=8),
            slo=SLOConfig(enabled=True),
            tracer=Tracer(sample=1.0, export="", node="cli"))
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.gw = HttpGateway(self.inst, "127.0.0.1:0")
        self._run(self.gw.start())
        self.address = f"127.0.0.1:{self.gw.port}"

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def post(self, path: str, body: dict) -> dict:
        req = urllib.request.Request(
            f"http://{self.address}{path}", method="POST",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    def close(self):
        self._run(self.gw.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.inst.close()


@pytest.fixture(scope="module")
def gw():
    g = _Gateway()
    for i in range(6):
        g.post("/v1/GetRateLimits", {"requests": [
            {"name": f"cli{j % 3}", "uniqueKey": f"k{(i * 7 + j) % 40}",
             "hits": "1", "limit": "5", "duration": "3600000"}
            for j in range(30)]})
    yield g
    g.close()


def _run_cli(module, argv, capsys) -> tuple:
    """(exit code, stdout) of one CLI command."""
    try:
        module.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["debug"], ["slo"], ["top", "-n", "5"], ["kernels", "--no-census"],
], ids=["debug", "slo", "top", "kernels"])
def test_cli_prints_as_the_jax_cli(gw, capsys, argv):
    cmd = argv[:1] + [gw.address] + argv[1:]
    mine = _run_cli(cli, cmd, capsys)
    theirs = _run_cli(jcli, cmd, capsys)
    assert mine[0] == 0, mine[1]
    assert mine == theirs
    assert mine[1].strip()


def test_snapshot_restore_round_trip_byte_for_byte(gw, capsys, tmp_path,
                                                   monkeypatch):
    # a pinned export clock: the blob carries its export time
    monkeypatch.setattr(engine_mod, "millisecond_now", lambda: T0)
    a, b, c = (str(tmp_path / n) for n in ("a.snap", "b.snap", "c.snap"))
    code, out = _run_cli(cli, ["snapshot", gw.address, "-o", a], capsys)
    assert code == 0 and "wrote" in out
    assert _run_cli(jcli, ["snapshot", gw.address, "-o", b], capsys)[0] == 0
    blob = Path(a).read_bytes()
    assert blob == Path(b).read_bytes()
    mine = _run_cli(cli, ["restore", gw.address, a], capsys)
    theirs = _run_cli(jcli, ["restore", gw.address, a], capsys)
    assert mine == theirs and mine[0] == 0
    assert mine[1].startswith("restored ") and mine[1].strip() != \
        "restored 0 keys"
    assert _run_cli(cli, ["snapshot", gw.address, "-o", c], capsys)[0] == 0
    assert Path(c).read_bytes() == blob
    # a bad blob is refused with the gateway's error, exit 1
    bad = tmp_path / "bad.snap"
    bad.write_bytes(b"not a snapshot")
    assert _run_cli(cli, ["restore", gw.address, str(bad)], capsys)[0] == 1


def test_python_m_cli_loads_neither_torch_nor_jax(gw):
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['cli', 'debug', {gw.address!r}]\n"
        "try:\n"
        "    runpy.run_module('gubernator_tpu_torch.cmd.cli',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'jaxlib', 'gubernator_tpu', 'numpy'))\n"
        "print('LOADED', ','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
    assert "standalone=True" in res.stdout
    assert res.stdout.strip().splitlines()[-1] == "LOADED"
