"""Two port daemons in mesh mode on the CPU (`python -m
gubernator_tpu_torch.daemon`, each a process with a time limit of its own),
configured as the JAX daemon is (gubernator_tpu/daemon.py:100-233):
GUBER_MESH_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID join the gloo group,
GUBER_MESH_PEERS names both gRPC addresses in rank order,
GUBER_GLOBAL_KEYS_FILE registers a GLOBAL key on both at the agreed epoch,
GUBER_LOCKSTEP_STACK=2 stacks each tick's step, GUBER_SNAPSHOT_DIR holds
each rank's own file (saved by the tick loop every
GUBER_SNAPSHOT_INTERVAL_MS of ticks and once more at the stop), and
GUBER_FRONTDOOR_WORKERS is ignored with a warning.  A key of rank 1's shard sent to rank 0 is answered by rank 1 (its
answer names the owner); a GLOBAL hit on rank 0 reads back on rank 1 (the
all-reduce brought it, no GlobalManager RPC runs); SIGTERM to both stops
them at one agreed tick (the lockstep_stop phase), each exits 0, and the
two ranks' files carry one stamp, the agreed final tick's time, and one
GLOBAL part (state/snapshot.py global_digest), as a restore requires.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from gubernator_tpu_torch.api.types import Behavior, RateLimitReq
from gubernator_tpu_torch.core.engine import shard_of
from gubernator_tpu_torch.state import snapshot as snapmod

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read_until(proc, marker, seconds):
    # a thread reads the lines: a select on the pipe would wait for more
    # bytes while the text buffer already holds the marker's line
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


def test_two_mesh_daemons_serve_one_arena_and_stop_together(tmp_path):
    grpc = pytest.importorskip("grpc")
    del grpc
    from gubernator_tpu_torch.client import Client
    addrs = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    coord = _free_port()
    keys = tmp_path / "globals.jsonl"
    keys.write_text(json.dumps(dict(key="dm_g", limit=30, duration=60_000,
                                    algorithm=0)) + "\n")
    snaps = tmp_path / "snaps"
    procs, logs = [], [[], []]
    for rank, a in enumerate(addrs):
        conf = tmp_path / f"rank{rank}.conf"
        conf.write_text("".join(f"{k}={v}\n" for k, v in {
            "GUBER_TORCH_DEVICE": "cpu", "GUBER_GRPC_ADDRESS": a,
            "GUBER_HTTP_ADDRESS": "127.0.0.1:0",
            "GUBER_TPU_CAPACITY_PER_SHARD": "256",
            "GUBER_TPU_BATCH_PER_SHARD": "64",
            "GUBER_TPU_GLOBAL_CAPACITY": "16",
            "GUBER_BATCH_WAIT": "0.005",
            "GUBER_MESH_COORDINATOR": f"127.0.0.1:{coord}",
            "GUBER_MESH_NUM_PROCESSES": "2",
            "GUBER_MESH_PROCESS_ID": str(rank),
            "GUBER_MESH_PEERS": ",".join(addrs),
            "GUBER_GLOBAL_KEYS_FILE": str(keys),
            "GUBER_LOCKSTEP_STACK": "2",
            "GUBER_SNAPSHOT_DIR": str(snaps),
            "GUBER_SNAPSHOT_INTERVAL_MS": "100",
            "GUBER_FRONTDOOR_WORKERS": "2"}.items()))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("GUBER_")}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gubernator_tpu_torch.daemon", "--config",
             str(conf)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        for rank, p in enumerate(procs):
            logs[rank] += _read_until(p, "HTTP gateway listening",
                                      CHILD_TIMEOUT_S)
        c0, c1 = Client(addrs[0]), Client(addrs[1])
        remote = next(f"k{i}" for i in range(1000)
                      if shard_of(f"dm_k{i}", 2) == 1)
        fwd = [c0.get_rate_limits([RateLimitReq(
            name="dm", unique_key=remote, hits=1, limit=2,
            duration=60_000)], timeout=30)[0] for _ in range(3)]
        g = c0.get_rate_limits([RateLimitReq(
            name="dm", unique_key="g", hits=2, limit=30, duration=60_000,
            behavior=Behavior.GLOBAL)], timeout=30)[0]
        probe = None
        for _ in range(200):
            probe = c1.get_rate_limits([RateLimitReq(
                name="dm", unique_key="g", hits=0, limit=30,
                duration=60_000, behavior=Behavior.GLOBAL)], timeout=30)[0]
            if probe.remaining == 28:
                break
            time.sleep(0.02)
        health = c1.health_check(timeout=10)
        c0.close()
        c1.close()
        for p in procs:
            p.send_signal(signal.SIGTERM)
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    text = ["".join(lg) + out for lg, out in zip(logs, outs)]
    assert [p.returncode for p in procs] == [0, 0], text
    assert [(r.remaining, int(r.status), r.error) for r in fwd] == [
        (1, 0, ""), (0, 0, ""), (0, 1, "")]
    assert all(r.metadata.get("owner") == addrs[1] for r in fwd)
    assert (g.remaining, g.error) == (28, "")
    assert (probe.remaining, probe.error) == (28, "")
    assert health.status == "healthy"
    for t in text:
        assert "mesh mode: 2 processes, 2 global shards" in t
        assert "torch.distributed backend gloo" in t
        assert "registered 1 GLOBAL keys" in t
        assert "GUBER_FRONTDOOR_WORKERS ignored in mesh mode" in t
    stops = [re.search(r"lockstep stopped at the agreed tick (\d+)", t)
             for t in text]
    assert all(stops) and stops[0].group(1) == stops[1].group(1), text
    assert sorted(os.listdir(snaps)) == ["arena-r0.snap", "arena-r1.snap"]
    # periodic tick snapshots, then the final one
    assert all(t.count("snapshot: ") >= 2 for t in text), text
    files = [snapmod.load(str(snaps / f"arena-r{r}.snap")) for r in (0, 1)]
    assert files[0].now == files[1].now
    assert snapmod.global_digest(files[0]) == snapmod.global_digest(files[1])
