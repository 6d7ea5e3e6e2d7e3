"""Find a cell's pieces by the names BENCHMARK.json and its files give.

A cell (an entry of `workloads`) names a configuration, whose `file`
BENCHMARK.json gives, and a traffic mix, the data file
`traffic/<traffic>.json` beside this module.  The metrics a cell reports
are BENCHMARK.json's: with --trace 0 its end-to-end metrics, with
--trace 1 its per-layer ones; each is computed by the reader
`metrics/<base>.py`, where <base> is the metric's name up to its first
dot (`.sat` names the quantity in the saturated cells).

The code the data names is found the same way, each piece in a file of
its own: a traffic mix's `driver` is `drivers/<driver>.py`, a
configuration's key draw is `draws/<name>.py`, and each per-key value
(algorithm, limit, behavior) is computed by `rules/<rule>.py`.  Adding a
cell, a configuration, a traffic mix of a new shape, a draw, a rule or a
metric is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its configuration and
    traffic files read, and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = _by_name(bench["workloads"], name, "workload")
    c = _by_name(bench["configs"], w["config"], "configuration")
    config = json.loads((root / c["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer,
                root)


_modules: Dict[Path, ModuleType] = {}


def piece(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module `portbench/<kind>/<name>.py` of `root`, loaded once."""
    path = root / "portbench" / kind / f"{name}.py"
    if path not in _modules:
        if not path.is_file():
            raise KeyError(f"no {kind} named {name!r} ({path} is missing)")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The `read(run)` function of metrics/<base>.py for `metric`."""
    return piece("metrics", metric.split(".")[0], root).read
