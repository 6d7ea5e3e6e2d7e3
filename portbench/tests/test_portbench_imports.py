"""What the benchmark loads: nothing of JAX or the JAX package in the
harness's process, nothing of the program in the reference, and a run
that cannot measure exits without a result."""

import json
import os
import shutil
import subprocess
import sys

from portbench import manifest

ROOT = manifest.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "gubernator_tpu"}


def loaded_top_names(code):
    """The top-level names (before the first dot) of every module a fresh
    interpreter holds after running `code`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_the_port_load_no_jax():
    names = loaded_top_names(
        "import importlib.util, glob\n"
        "spec = importlib.util.spec_from_file_location('pb_run', "
        "'portbench/run.py')\n"
        "run = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(run)\n"
        "from portbench import harness, manifest, control\n"
        "harness.load_program()\n"
        "import torch.profiler\n"
        "for f in glob.glob('portbench/*/*.py'):\n"
        "    kind, name = f.split('/')[-2:]\n"
        "    if kind in ('metrics', 'drivers', 'draws', 'rules'):\n"
        "        manifest.piece(kind, name[:-3])\n"
        "assert not run.forbidden_modules()\n")
    assert "gubernator_tpu_torch" in names and "portbench" in names
    # compared whole: the port's name begins with the JAX package's
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = loaded_top_names("import portbench.reference.buckets")
    assert not names & (FORBIDDEN | {"gubernator_tpu_torch", "torch"})
    for f in (ROOT / "portbench" / "reference").glob("*.py"):
        for line in f.read_text().splitlines():
            if line.lstrip().startswith(("import ", "from ")):
                assert "gubernator" not in line


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lb-1m-zipf.sat",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_with_only_the_benchmarks_files_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "lb-1m-zipf.sat",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
