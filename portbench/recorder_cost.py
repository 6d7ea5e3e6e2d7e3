"""What the port's drain timeline and router clocks cost on this host.

    python3 portbench/recorder_cost.py [--rounds 400]

Prints one JSON object, each cost the median over `rounds` rounds, in ns:

- `row_ns`, `hold_ns`: one DrainRing row write (`add_drain` of a
  populated drain result) and one hold segment (`add_hold`);
- `timed_call_ns`: what a RouterClock adds to one router call
  (`fastpath_encode_w` of a 100-item RPC with `clock=` less the same call
  without: the binding's two `time.monotonic_ns()` reads, the out-slot
  argument, the two sums, and the C side's two CLOCK_MONOTONIC reads),
  beside `call_ns`, the untimed call;
- `drain_fixed_ns`: a drain's own clock reads (two RouterClocks, the
  engine thread's `time.thread_time()` and `time.monotonic()` at both ends
  of its fill, and the `submitted` and `committed` stamps).

A drain's cost is then `row_ns + drain_fixed_ns + timed_call_ns` times its
RPCs twice (each RPC's parse and encode).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
ITEMS = 100
# calls a round times, between the two clock reads
BLOCK = 200


def _per_call(fn, n: int = BLOCK) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


def measure(rounds: int) -> dict:
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.core.drain_ring import HOLD_GATE, DrainRing
    from gubernator_tpu_torch.core.pipeline import _DrainResult
    ring = DrainRing()
    res = _DrainResult()
    for k, name in enumerate(("held_since", "submitted", "oldest_enq",
                              "started", "pack_done", "dispatch_done",
                              "wait_start", "fetch_start", "fetch_done")):
        setattr(res, name, 1000.0 + k)
    res.staged = [None] * 10
    res.n_decisions, res.n_lanes, res.k_used = 10_000, 8_000, 2
    res.parse_c_ns = res.parse_wall_ns = 500_000
    res.encode_c_ns = res.encode_wall_ns = 50_000
    res.fill_cpu_s = res.fill_wall_s = 0.008

    r = native.NativeRouter(1, 1 << 12)
    lanes = 1024
    words = np.zeros((1, lanes), np.int64)
    limit = np.full(ITEMS, 10, np.int64)
    row = np.zeros(ITEMS, np.int32)
    lane = np.arange(ITEMS, dtype=np.int32)
    pos = np.full(ITEMS, -1, np.int32)
    buf = np.empty(ITEMS * 64 + 64, np.uint8)
    clock = native.RouterClock()

    def untimed():
        r.fastpath_encode_w(words, limit, 0, lanes, ITEMS, row, lane, pos,
                            buf)

    def timed():
        r.fastpath_encode_w(words, limit, 0, lanes, ITEMS, row, lane, pos,
                            buf, clock=clock)

    def fixed():
        native.RouterClock()
        native.RouterClock()
        time.monotonic()
        time.thread_time()
        time.monotonic()
        time.thread_time()
        time.monotonic()
        time.monotonic()

    cols = {k: [] for k in ("row_ns", "hold_ns", "call_ns", "timed_ns",
                            "drain_fixed_ns")}
    for _ in range(rounds):
        cols["row_ns"].append(_per_call(lambda: ring.add_drain(res, 1e3)))
        cols["hold_ns"].append(_per_call(
            lambda: ring.add_hold(1e3, 1e3 + 1, HOLD_GATE)))
        # the pair in both orders, so that neither gains from going first
        a = _per_call(untimed)
        b = _per_call(timed)
        a = (a + _per_call(untimed)) / 2
        cols["call_ns"].append(a)
        cols["timed_ns"].append(b)
        cols["drain_fixed_ns"].append(_per_call(fixed))
    out = {k: statistics.median(v) for k, v in cols.items()}
    out["timed_call_ns"] = statistics.median(
        b - a for a, b in zip(cols["call_ns"], cols["timed_ns"]))
    del out["timed_ns"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=400)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    print(json.dumps(measure(args.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
