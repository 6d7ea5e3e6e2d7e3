"""The pipeline's drain timeline (core/drain_ring.py) on the CPU.

A raw-bytes-lane pipeline (the router's C parse and encode, the drain
kernel's plain version) serves closed-loop callers: every committed drain
writes one row whose stamps are in order (held_since <= submitted <=
started <= pack_done <= dispatch_done <= fetch_done <= committed), the
launched rows equal the pipeline's drain count and their decisions its
decisions_staged, and each row's C clocks are within its binding walls.
Chained drains carry their chain's fetch window.  The rings keep the
newest rows when they wrap, and the host-state split gives each instant
to the first state that holds there.
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest

from gubernator_tpu_torch import native
from gubernator_tpu_torch.api import pb
from gubernator_tpu_torch.config import BehaviorConfig
from gubernator_tpu_torch.core import drain_ring
from gubernator_tpu_torch.core.batcher import WindowBatcher
from gubernator_tpu_torch.core.drain_ring import (
    HOLD_DEPTH,
    HOLD_GATE,
    DrainRing,
    covered,
    state_seconds,
)
from gubernator_tpu_torch.core.engine import RateLimitEngine

pytestmark = pytest.mark.torch_port

T0 = 1_700_000_000_000
ORDER = ("submitted", "started", "pack_done", "dispatch_done", "fetch_done",
         "committed")


def _batcher(stride=1):
    if not native.available():
        pytest.skip("native router unavailable")
    eng = RateLimitEngine(capacity_per_shard=1024, batch_per_shard=64,
                          global_capacity=16, global_batch_per_shard=8,
                          max_global_updates=8, num_shards=2,
                          use_native="on", device="cpu")
    b = WindowBatcher(eng, BehaviorConfig())
    p = b.pipeline
    assert p is not None and p.enabled
    p.now_fn = b.now_fn = lambda: T0
    if stride > 1:
        p.fetch_stride = stride
        p.fetch_stride_max = max(stride, p.fetch_stride_max)
        p.gate_enabled = False
    return b


def _rpc(caller, i, n=20):
    return pb.GetRateLimitsReq(requests=[
        pb.RateLimitReq(name="ring", unique_key=f"c{caller}k{(i + j) % 50}",
                        hits=1, limit=1000, duration=60_000,
                        algorithm=j % 2)
        for j in range(n)]).SerializeToString()


def _serve(b, callers=12, rounds=6):
    """Closed-loop callers, each its next RPC when the last is answered;
    returns the pipeline's drains, decisions_staged and timeline rows
    before them."""
    p = b.pipeline

    async def caller(c):
        for i in range(rounds):
            out = await b.submit_rpc(_rpc(c, i))
            assert out is not None

    async def run():
        before = (p.drains, p.decisions_staged, p.timeline.drains_written)
        await asyncio.gather(*(caller(c) for c in range(callers)))
        return before

    try:
        before = asyncio.run(run())
    finally:
        b.close()
    return before


@pytest.mark.parametrize("stride", [1, 2], ids=["unchained", "chained"])
def test_rows_are_ordered_and_add_up(stride):
    b = _batcher(stride)
    p = b.pipeline
    drains0, decisions0, seq0 = _serve(b)
    rows = p.timeline.drains(seq0)
    assert len(rows) == p.timeline.drains_written - seq0 > 0
    launched = rows[rows["launched"] == 1]
    assert len(launched) == p.drains - drains0
    assert rows["decisions"].sum() == p.decisions_staged - decisions0
    assert rows["jobs"].sum() == 12 * 6
    for a, c in zip(ORDER, ORDER[1:]):
        assert (rows[a] > 0).all(), a
        assert (rows[a] <= rows[c]).all(), (a, c)
    held = rows["held_since"] > 0
    assert held.any(), "no drain waited through a hold"
    assert (rows["held_since"][held] <= rows["submitted"][held]).all()
    assert (rows["parse_c_ns"] > 0).all() and (rows["encode_c_ns"] > 0).all()
    assert (rows["parse_c_ns"] <= rows["parse_wall_ns"]).all()
    assert (rows["encode_c_ns"] <= rows["encode_wall_ns"]).all()
    assert (rows["fill_cpu_s"] > 0).all()
    assert (rows["fill_wall_s"] >= rows["dispatch_done"]
            - rows["started"]).all()
    if stride > 1:
        chained = rows["chain_fetch_done"] > 0
        assert chained.any()
        c = rows[chained]
        assert (c["chain_fetch_start"] <= c["chain_fetch_done"]).all()
        assert (c["chain_fetch_done"] <= c["fetch_start"]).all()
    holds = p.timeline.holds()
    assert len(holds) == p.timeline.holds_written > 0
    assert (holds["start"] <= holds["end"]).all()
    assert set(holds["reason"].tolist()) <= {HOLD_GATE, HOLD_DEPTH}
    # the segments close in time order and never overlap
    assert (holds["start"][1:] >= holds["end"][:-1]).all()


def _res(i):
    """A committed drain's stand-in: every stamp i + 0.01 x its place."""
    stamps = ("held_since", "submitted", "oldest_enq", "started",
              "pack_done", "dispatch_done", "wait_start", "fetch_start",
              "fetch_done", "chain_fetch_start", "chain_fetch_done")
    r = SimpleNamespace(**{s: i + 0.01 * k for k, s in enumerate(stamps)})
    r.words = object()
    r.staged = [None]
    r.n_decisions, r.n_lanes, r.k_used = 10 * i, 5 * i, 1
    r.parse_c_ns = r.parse_wall_ns = r.encode_c_ns = r.encode_wall_ns = i
    r.fill_cpu_s = r.fill_wall_s = 0.5
    return r


def test_ring_wraps_and_keeps_the_newest_rows():
    ring = DrainRing(capacity=4)
    for i in range(10):
        ring.add_drain(_res(i), committed=i + 0.5)
        ring.add_hold(i, i + 0.25, HOLD_GATE if i % 2 else HOLD_DEPTH)
    assert ring.drains_written == ring.holds_written == 10
    assert ring.drains()["decisions"].tolist() == [60, 70, 80, 90]
    assert ring.drains(8)["decisions"].tolist() == [80, 90]
    assert ring.drains(10).size == 0
    assert ring.holds()["start"].tolist() == [6, 7, 8, 9]
    assert ring.holds(9)["reason"].tolist() == [HOLD_GATE]
    summary = ring.summary(last=2)
    assert summary["drains"] == 2
    assert summary["decisions_per_drain"] == 85.0
    assert summary["decisions_per_lane"] == 2.0
    assert summary["jobs_per_drain"] == summary["windows_per_drain"] == 1
    assert abs(sum(summary["host_state_pct"].values()) - 100.0) < 1e-9
    assert ring.stage_snapshot(last=2)["window_fill"]["count"] == 2


def test_covered_is_the_union_length():
    assert covered([0, 1, 5], [2, 3, 6], 0, 10) == pytest.approx(4.0)
    assert covered([0, 1, 5], [2, 3, 6], 2.5, 5.5) == pytest.approx(1.0)
    assert covered([3], [3], 0, 10) == 0.0
    assert covered([], [], 0, 10) == 0.0
    rng = np.random.default_rng(3)
    s = rng.uniform(0, 100, 200)
    e = s + rng.uniform(0, 3, 200)
    grid = np.linspace(0, 100, 200_001)[:-1] + 0.00025
    inside = ((grid[:, None] >= s) & (grid[:, None] < e)).any(axis=1)
    assert covered(s, e, 0, 100) == pytest.approx(inside.mean() * 100,
                                                  abs=0.01)


def test_host_states_are_exclusive_by_priority():
    """Drain A queues 0.5-1, fills 1-3 and is answered to 6; drain B
    queues 2-4, fills 4-5 and is answered to 8; a gate hold 5-7 and a
    depth hold 6.5-9.  Over 0-10: fill 1-3 and 4-5 (3 s), engine_queue
    0.5-1 and 3-4 (1.5), gate 5-7 (2), depth 7-9 (2), answer nothing
    left, no_work 0-0.5 and 9-10 (1.5)."""
    rows = np.zeros(2, drain_ring.DRAIN_DTYPE)
    rows["submitted"] = [0.5, 2]
    rows["started"] = [1, 4]
    rows["pack_done"] = [2, 4.5]
    rows["dispatch_done"] = [3, 5]
    rows["committed"] = [6, 8]
    holds = np.zeros(2, drain_ring.HOLD_DTYPE)
    holds["start"], holds["end"] = [5, 6.5], [7, 9]
    holds["reason"] = [HOLD_GATE, HOLD_DEPTH]
    sec = state_seconds(rows, holds, 0.0, 10.0)
    assert sec == pytest.approx({"fill": 3.0, "engine_queue": 1.5,
                                 "gate": 2.0, "depth": 2.0, "answer": 0.0,
                                 "no_work": 1.5})
    assert tuple(sec) == drain_ring.HOST_STATES
    # outside busy intervals (the card's): 2.5-3.75 and 6.5-7.5 leave
    # fill 2.5 (less 0.5), engine_queue 0.75 (less 0.75), gate 1.5 (less
    # 0.5), depth 1.5 (less 0.5), no_work 1.5
    busy = (np.array([2.5, 6.5]), np.array([3.75, 7.5]))
    idle = state_seconds(rows, holds, 0.0, 10.0, busy)
    assert idle == pytest.approx({"fill": 2.5, "engine_queue": 0.75,
                                  "gate": 1.5, "depth": 1.5, "answer": 0.0,
                                  "no_work": 1.5})
