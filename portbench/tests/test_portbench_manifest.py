"""The manifest: every cell of BENCHMARK.json resolves to its files and
readers; a cell, a configuration, a traffic mix of a new shape (its
driver, draw and rule) and a metric added as new files and entries run
with no edit; a stated setting that nothing reads is refused;
BENCHMARK.json keeps the contract's shape."""

import json
import re
import shutil

import numpy as np
import pytest

from portbench import harness, loadgen, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = manifest.load_cell(cell)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.reader(m["name"]))
    assert c.config["reduced"] == []
    assert len(c.config["source"]) <= 200


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert c["file"].startswith("portbench/")
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    metrics = set()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in metrics
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        metrics.add(m["name"])
    assert len(json.dumps(BENCH)) < 64 * 1024


BURSTS = '''"""Callers that send `burst` RPCs one after another, then pause."""

import asyncio
import time
from pathlib import Path

from portbench import manifest
from portbench.loadgen import Sent

ROOT = Path(__file__).resolve().parent.parent.parent


def pool(ks, items, rng, prefix, groups, seconds, items_per_caller, burst,
         pause_s):
    closed = manifest.piece("drivers", "closed_loop", ROOT)
    p = closed.pool(ks, items, rng, prefix, groups, seconds,
                    items_per_caller)
    p.burst, p.pause_s = burst, pause_s
    return p


async def drive(serve, pool, seconds, keep=frozenset()):
    log, stop = [], time.perf_counter() + seconds

    async def caller(c):
        stream, i = pool.streams[c], 0
        while time.perf_counter() < stop:
            for _ in range(pool.burst):
                e = stream[i % len(stream)]
                i += 1
                t0 = time.perf_counter()
                out = await serve(pool.datas[e])
                log.append(Sent(e, t0, time.perf_counter(), True,
                                out if pool.group[e] in keep else None))
            await asyncio.sleep(pool.pause_s)

    await asyncio.gather(*(caller(c) for c in range(len(pool.streams))))
    return log
'''
HOTSET = '''"""A share of the draws on a group's first `hot` keys, the rest
uniform over the group."""


def draw(rng, n, count, group=0, groups=1, hot=4, share=0.5):
    span = (count - group + groups - 1) // groups
    j = rng.integers(0, span, n)
    on_hot = rng.random(n) < share
    j[on_hot] = rng.integers(0, min(hot, span), int(on_hot.sum()))
    return group + groups * j
'''
THRESHOLD = '''"""`below` for key indices under `at`, `above` from it on."""

import numpy as np


def values(idx, at, below, above):
    return np.where(np.asarray(idx) < at, below, above).astype(np.int64)
'''


def new_shape_bench(root):
    """A copy of the benchmark's files under `root` with, added as files
    and entries only: a driver of a new shape (bursts and pauses), a draw
    (a hot set), a rule (a threshold), a configuration with QoS off that
    uses them, a traffic mix, a per-layer metric and a cell."""
    for kind in ("configs", "traffic", "metrics", "drivers", "draws",
                 "rules"):
        shutil.copytree(manifest.HERE / kind, root / "portbench" / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (root / "portbench/drivers/bursts.py").write_text(BURSTS)
    (root / "portbench/draws/hotset.py").write_text(HOTSET)
    (root / "portbench/rules/threshold.py").write_text(THRESHOLD)
    cfg = json.loads((manifest.HERE / "configs/mixed-10m.json").read_text())
    cfg["instance"]["engine_config"]["capacity_per_shard"] = 4096
    cfg["instance"]["qos"] = dict(enabled=False)
    cfg["keys"].update(count=8192,
                       draw=dict(name="hotset", hot=3, share=0.6),
                       algorithm=dict(rule="threshold", at=4096, below=0,
                                      above=1))
    (root / "portbench/configs/hot-8k.json").write_text(json.dumps(cfg))
    (root / "portbench/traffic/bursts8.json").write_text(json.dumps(dict(
        why="8 callers in bursts of 3 RPCs with pauses", driver="bursts",
        groups=8, check_groups=3,
        params=dict(items_per_caller=1000, burst=3, pause_s=0.002),
        warmup=dict(seconds=0.2, params=dict(items_per_caller=200, burst=2,
                                             pause_s=0.001)))))
    (root / "portbench/metrics/rpcs_per_s.py").write_text(
        "def read(run):\n    return run.rpcs / run.window_s\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(name="hot-8k", source="x",
                                 file="portbench/configs/hot-8k.json",
                                 reduced=[], why="x"))
    bench["workloads"].append(dict(name="hot-8k.bursts", config="hot-8k",
                                   traffic="bursts8", chips=1, why="x"))
    bench["per_layer"].append(dict(
        name="rpcs_per_s.bursts", unit="rpcs/s", better="higher",
        source="host_clock", layer="wire", moves="device_us_per_kdec",
        workloads=["hot-8k.bursts"]))
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("hot-8k.bursts")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_files_are_found_with_no_edit(tmp_path):
    """A cell whose traffic has a new shape, drawn and ruled by new files,
    is found, runs and is checked with no edit to any file there."""
    new_shape_bench(tmp_path)
    c = manifest.load_cell("hot-8k.bursts", tmp_path)
    assert c.traffic["driver"] == "bursts"
    assert [m["name"] for m in c.per_layer] == ["rpcs_per_s.bursts"]
    assert {m["name"] for m in c.end_to_end} == {"device_us_per_kdec",
                                                 "setup_s"}
    ks = loadgen.Keyspace(c.config, tmp_path)
    idx = ks.draw_keys(np.random.default_rng(1), 20_000, 2, 8)
    assert (idx % 8 == 2).all() and (idx < 8192).all()
    assert np.isin(idx, [2, 10, 18]).mean() > 0.55
    assert ks.algos(np.array([0, 4095, 4096, 8191])).tolist() == [0, 0, 1, 1]
    # a run on the CPU has no device trace: device_us_per_kdec reads none
    for trace, names in ((False, {"setup_s"}),
                         (True, {"rpcs_per_s.bursts"})):
        res = harness.run_cell(c, 2 ** 31 + 3, 0.6, trace, device="cpu",
                               log=lambda *a, **k: None)
        assert res["correct"], res["checks"]
        assert set(res["metrics"]) == names
    # the cells that were there still resolve from the copy
    for w in BENCH["workloads"]:
        assert manifest.load_cell(w["name"], tmp_path).name == w["name"]


@pytest.mark.parametrize("where,change", [
    ("config", lambda c, t: c.update(deployment={"analytics": "on"})),
    ("instance", lambda c, t: c["instance"].update(analytic={})),
    ("setting", lambda c, t: c["instance"]["analytics"].update(enabeld=1)),
    ("engine", lambda c, t: c["instance"]["engine_config"].update(
        shards=8)),
    ("traffic", lambda c, t: t.update(loop="open")),
    ("driver", lambda c, t: t["params"].update(rate=5)),
    ("behavior", lambda c, t: c["keys"].update(
        behavior=dict(rule="constant", value=2))),
])
def test_a_stated_setting_nothing_reads_is_refused(where, change):
    cell = manifest.load_cell("mixed-10m.sat")
    cell.config["instance"]["engine_config"]["capacity_per_shard"] = 4096
    cell.config["keys"]["count"] = 8192
    cell.traffic.update(groups=8, check_groups=3,
                        params=dict(items_per_caller=200),
                        warmup=dict(seconds=0.1,
                                    params=dict(items_per_caller=100)))
    change(cell.config, cell.traffic)
    with pytest.raises(harness.RunError):
        harness.run_cell(cell, 5, 0.2, False, device="cpu",
                         log=lambda *a, **k: None)


def test_instance_settings_reach_the_instance():
    from gubernator_tpu_torch.config import AnalyticsConfig, EngineConfig
    from gubernator_tpu_torch.core.service import Instance
    spec = manifest.load_cell("lb-1m-zipf.sat").config["instance"]
    kw = harness.instance_kwargs(Instance, spec)
    assert kw["engine_config"] == EngineConfig(
        num_shards=8, capacity_per_shard=2 ** 21, batch_per_shard=1024,
        use_native="on")
    assert kw["analytics"].enabled is False
    kw = harness.instance_kwargs(Instance, dict(analytics=dict(enabled=True,
                                                               topk=8)))
    assert kw["analytics"] == AnalyticsConfig(enabled=True, topk=8)
