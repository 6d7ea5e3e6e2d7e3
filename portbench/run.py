"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic and the metrics it reports are
found by name through BENCHMARK.json (portbench/manifest.py).  Every
run traces its window with torch.profiler.  With --trace 0 the last line
of standard output holds the cell's end-to-end metrics, with --trace 1
its per-layer ones read from that trace, the harness's clocks and the
pipeline's counters.  The run exits with a
code other than 0, and prints no result, when no CUDA device is there,
when the port or its native router cannot serve the raw-bytes lane, or
when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# compared whole, by the part of a module's name before its first dot: the
# port's own name begins with the JAX package's
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "gubernator_tpu"))


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def _finite(x):
    """The result with non-finite numbers as null (JSON has none)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    # the program's settings come from the cell's configuration alone
    for k in [k for k in os.environ if k.startswith("GUBER_")]:
        del os.environ[k]
    from portbench import harness, manifest
    cell = manifest.load_cell(args.workload, ROOT)
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START,
                                  log=print)
    except harness.RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, (value, rel, limit) in result["checks"].items():
        print(f"check {name}: {value} (must be {rel} {limit})",
              file=sys.stderr, flush=True)
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
