"""The port's device-time flight recorder (observability/devprof.py on
torch.profiler), one test for each of the JAX package's
tests/test_devprof.py:

  * trace parsing: malformed and empty traces degrade to a logged no-op;
    self-time nesting and the arm join on torch-profiler-shaped events
    (kernels on a device track, `gpu_user_annotation` ranges, launches by
    `correlation`), CPU captures by containment;
  * the kernel table keyed by arm and name, held against the JAX table on
    the same rows;
  * the census join: every serving arm's census (the wrappers'
    `plain_calls` a window on the CPU) and a measured ms/window from a
    real CPU capture of the port's plain versions;
  * the window clock, held against the JAX clock on the same observations;
  * the shm trace region and the worker's traceparent;
  * `/v1/admin/kernels` and one periodic-controller cycle on a live
    Instance.
"""

import asyncio
import gzip
import json
import os
import threading
import time

import pytest
from aiohttp.test_utils import TestClient, TestServer

from gubernator_tpu.observability import devprof as jdevprof
from gubernator_tpu.observability.metrics import Metrics as JMetrics
from gubernator_tpu_torch.api import http_gateway as gateway_mod
from gubernator_tpu_torch.api.http_gateway import build_app
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.config import EngineConfig
from gubernator_tpu_torch.core import shm_ring
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.observability.devprof import (
    ARM_ANALYTICS,
    ARM_DRAIN,
    ARM_FETCH,
    ARM_FULL,
    ARM_FUSED,
    ARM_OTHER,
    CAPTURE_SPAN,
    CaptureRoll,
    Devprof,
    DevprofController,
    KernelTable,
    WindowClock,
    build_census_arms,
    census_of,
    census_table,
    hand_kernel_events,
    is_hand_kernel,
    kernel_base,
    load_trace_events,
    measure_census_arms,
    parse_run_dir,
    self_times,
)
from gubernator_tpu_torch.observability import devprof as devprof_mod
from gubernator_tpu_torch.observability.metrics import Metrics
from gubernator_tpu_torch.observability.tracing import Tracer

pytestmark = pytest.mark.torch_port

# the JAX census classes and the port's arm for each (compact32_xla's
# math is a Mosaic workaround the port does not carry)
ARM_OF_JAX = {"int64_xla": ARM_FULL, "fused_window": ARM_FUSED,
              "composed_drain": ARM_DRAIN,
              "composed_mixed_algos": "composed_mixed_algos",
              "composed_analytics": ARM_ANALYTICS}
CENSUS_CLASSES = tuple(ARM_OF_JAX.values())


# --------------------------------------------------------------- trace parsing


def test_malformed_and_empty_traces_degrade(tmp_path):
    run = tmp_path / "cap"
    run.mkdir()
    bad = run / "host.pt.trace.json"
    bad.write_bytes(b"definitely not json")
    assert load_trace_events(str(bad)) == []
    badgz = run / "h1.pt.trace.json.gz"
    badgz.write_bytes(b"\x1f\x8b not gzip past the magic")
    assert load_trace_events(str(badgz)) == []
    no_events = run / "h2.pt.trace.json"
    no_events.write_text(json.dumps({"displayTimeUnit": "ms"}))
    assert load_trace_events(str(no_events)) == []
    # a gzip export: garbage entries filtered, one valid X event kept
    mixed = run / "h3.pt.trace.json.gz"
    with gzip.open(mixed, "wt", encoding="utf-8") as fh:
        fh.write(json.dumps({"traceEvents": [
            "junk", {"ph": "M", "name": "meta"},
            {"ph": "X", "name": "neg", "ts": 1, "dur": -5},
            {"ph": "X", "name": "nodur", "ts": 1},
            {"ph": "X", "cat": "kernel", "name": "drain_compact_kernel(long)",
             "ts": 10.0, "dur": 2.5},
        ]}))
    evs = load_trace_events(str(mixed))
    assert [e["name"] for e in evs] == ["drain_compact_kernel(long)"]
    assert [e["name"] for e in parse_run_dir(str(run))] == [
        "drain_compact_kernel(long)"]
    # a directory with no trace file at all
    assert parse_run_dir(str(tmp_path / "nothing-here")) == []
    # folding an empty capture is a counted no-op, never an error
    t = KernelTable()
    assert t.fold([]) == 0
    assert t.ms_per_window() == {}
    snap = t.snapshot()
    assert snap["rows"] == [] and snap["folds"] == 0


def _x(name, ts, dur, cat, pid=1, tid=1, **args):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
         "pid": pid, "tid": tid}
    if args:
        e["args"] = {k.replace("_", " ") if k == "External_id" else k: v
                     for k, v in args.items()}
    return e


def test_self_times_nesting_and_arm_attribution():
    gpu = dict(pid=0, tid=7)
    events = [
        # engine thread (1, 1): annotations and launches, host clock
        _x("guber_drain", 0.0, 50.0, "user_annotation"),
        _x("cudaLaunchKernel", 10.0, 5.0, "cuda_runtime", correlation=1),
        _x("guber_fetch", 60.0, 20.0, "user_annotation"),
        _x("cuLaunchKernel", 65.0, 5.0, "cuda_driver", correlation=2),
        _x("guber_window", 100.0, 30.0, "user_annotation"),
        _x("aten::copy_", 105.0, 10.0, "cpu_op", External_id=9),
        _x("cudaLaunchKernel", 110.0, 3.0, "cuda_runtime", correlation=3),
        # the device track: a kernel inside its annotation's device range
        _x("guber_drain", 200.0, 40.0, "gpu_user_annotation", **gpu),
        _x("(anonymous namespace)::drain_compact_kernel(long const*, "
           "(anonymous namespace)::Layout)", 205.0, 30.0, "kernel",
           correlation=1, **gpu),
        # ran long after its annotation closed on the host: joined by its
        # launch's correlation, not by the host clock
        _x("Memcpy DtoH (Device -> Pinned)", 300.0, 8.0, "gpu_memcpy",
           correlation=2, **gpu),
        # a torch op's kernel, joined through its launch inside
        # guber_window
        _x("void at::native::copy_kernel<long>(int)", 400.0, 4.0, "kernel",
           correlation=3, External_id=9, **gpu),
        # under no annotation: the torch shoulder
        _x("stray_kernel", 500.0, 2.0, "kernel", correlation=77, **gpu),
        # host ops are not device rows on a card's capture
        _x("aten::add", 0.0, 1000.0, "cpu_op", pid=1, tid=2),
    ]
    rows = {name: (ms, arm) for name, ms, arm in self_times(events)}
    drain = ("(anonymous namespace)::drain_compact_kernel(long const*, "
             "(anonymous namespace)::Layout)")
    assert is_hand_kernel(drain) and not is_hand_kernel("stray_kernel")
    assert kernel_base("void at::native::copy_kernel<long>(int)") == (
        "copy_kernel")
    assert set(rows) == {drain,
                         "Memcpy DtoH (Device -> Pinned)",
                         "void at::native::copy_kernel<long>(int)",
                         "stray_kernel"}
    assert rows[drain] == (0.03, ARM_DRAIN)
    assert rows["Memcpy DtoH (Device -> Pinned)"] == (0.008, ARM_FETCH)
    assert rows["void at::native::copy_kernel<long>(int)"] == (
        0.004, ARM_FUSED)
    assert rows["stray_kernel"] == (0.002, ARM_OTHER)
    hinted = {arm for _n, _ms, arm in
              self_times(events, arm_hint="fused_window")}
    assert hinted == {"fused_window"}
    # a CPU capture: the CPU ops are the rows, nested children's time
    # leaves the parent's self time, containment on the same thread
    cpu = [
        _x("guber_drain", 0.0, 200.0, "user_annotation"),
        _x("aten::where", 10.0, 80.0, "cpu_op"),
        _x("aten::empty", 20.0, 30.0, "cpu_op"),
        _x("aten::add", 150.0, 20.0, "cpu_op"),
        _x("aten::mul", 300.0, 10.0, "cpu_op"),
        _x("aten::sub", 50.0, 10.0, "cpu_op", tid=2),
        _x("PyTorch Profiler (0)", 0.0, 900.0, "python_function"),
    ]
    rows = {name: (ms, arm) for name, ms, arm in self_times(cpu)}
    assert rows == {"aten::where": (0.05, ARM_DRAIN),
                    "aten::empty": (0.03, ARM_DRAIN),
                    "aten::add": (0.02, ARM_DRAIN),
                    "aten::mul": (0.01, ARM_OTHER),
                    "aten::sub": (0.01, ARM_OTHER)}
    # a capture's counted span: only the device work launched inside it
    # is read (a drain before it, in the roll, is not), and on the CPU
    # only the ops inside it
    span = _x(CAPTURE_SPAN, 8.0, 100.0, "user_annotation")
    rows = {n for n, _ms, _a in self_times(events + [span])}
    assert rows == {drain, "Memcpy DtoH (Device -> Pinned)"}
    rows = {n for n, _ms, _a in self_times(
        cpu + [_x(CAPTURE_SPAN, 140.0, 60.0, "user_annotation")])}
    assert rows == {"aten::add"}


def _card_capture(kept):
    """A card's capture: the engine thread (1, 1) launches a drain kernel
    in the roll before its counted span and two inside it, another thread
    (1, 2) one more; `kept` names the correlations whose device events the
    profiler kept."""
    gpu = dict(pid=0, tid=7)
    ev = [_x(CAPTURE_SPAN, 100.0, 100.0, "user_annotation")]
    for corr, ts, tid in ((1, 10.0, 1), (2, 120.0, 1), (3, 150.0, 1),
                          (4, 130.0, 2)):
        ev.append(_x("cudaLaunchKernel", ts, 2.0, "cuda_runtime", tid=tid,
                     correlation=corr))
        if corr in kept:
            ev.append(_x("drain_compact_kernel(long)", ts + 5.0, 3.0,
                         "kernel", correlation=corr, **gpu))
    # a torch kernel is not a hand kernel
    ev.append(_x("cudaLaunchKernel", 160.0, 2.0, "cuda_runtime",
                 correlation=5))
    ev.append(_x("void at::native::fill_kernel(int)", 170.0, 2.0, "kernel",
                 correlation=5, **gpu))
    return ev


def test_capture_roll_adapts_to_lost_and_kept_kernels():
    """The roll grows when a capture lost a counted hand kernel (the
    capture is incomplete), shrinks when it kept every one its thread
    launched, the roll's first included, and holds otherwise; a capture
    with nothing counted (the CPU) is complete and leaves it alone."""
    assert hand_kernel_events(_card_capture({1, 2, 3, 4})) == (2, 3)
    assert hand_kernel_events(_card_capture({3})) == (1, 1)
    roll = CaptureRoll(2.0)
    # lost the roll's kernel only: complete, the roll holds
    assert roll.judge(_card_capture({2, 3, 4}), counted=2, launched=3)
    assert roll.seconds == 2.0 and roll.lost == 0
    # kept all three of the thread's: halves
    assert roll.judge(_card_capture({1, 2, 3}), counted=2, launched=3)
    assert roll.seconds == 1.0
    # lost a counted one: doubles, incomplete
    assert not roll.judge(_card_capture({1, 3, 4}), counted=2, launched=3)
    assert roll.seconds == 2.0 and roll.lost == 1
    # unknown thread total: no shrink
    assert roll.judge(_card_capture({1, 2, 3}), counted=2, launched=None)
    assert roll.seconds == 2.0
    # nothing counted (a CPU capture): complete, untouched
    assert roll.judge([], counted=None, launched=None)
    assert roll.seconds == 2.0
    # bounded: at least 0.25 s after a loss from 0, at most ROLL_MAX_S;
    # below 10 ms a shrink lands on 0
    small = CaptureRoll(0.0)
    assert not small.judge(_card_capture(set()), counted=2)
    assert small.seconds == 0.25
    for _ in range(10):
        small.judge(_card_capture(set()), counted=2)
    assert small.seconds == devprof_mod.ROLL_MAX_S
    tiny = CaptureRoll(0.03)
    tiny.judge(_card_capture({1, 2, 3}), counted=2, launched=3)
    assert tiny.seconds == 0.015
    tiny.judge(_card_capture({1, 2, 3}), counted=2, launched=3)
    assert tiny.seconds == 0.0


def test_kernel_table_keys_by_arm_and_name():
    # the same kernel name from two arms does not collapse, and the table
    # equals the JAX table fed the same rows
    ev = [{"ph": "X", "pid": 0, "tid": 0, "name": "fusion.1",
           "ts": 0.0, "dur": 100.0}]
    t, j = KernelTable(), jdevprof.KernelTable()
    for table in (t, j):
        assert table.fold(ev, windows=1, arm_hint="composed_drain") == 1
        assert table.fold(ev, windows=1, arm_hint="fused_window") == 1
    mpw = t.ms_per_window()
    assert set(mpw) == {"composed_drain", "fused_window"}
    assert mpw["composed_drain"] == pytest.approx(0.05)
    assert mpw["fused_window"] == pytest.approx(0.05)
    assert {r["arm"] for r in t.snapshot()["rows"]} == {
        "composed_drain", "fused_window"}
    assert t.snapshot() == j.snapshot()


# ------------------------------------------------------- measured census join


def test_every_census_class_gets_measured_time():
    """Every serving arm gets a census (the wrappers' plain_calls a window
    of one run) and a nonzero measured ms/window from a real parsed CPU
    capture of the same arm; the admin payload joins them per arm."""
    arms = build_census_arms(k=2, device="cpu")
    assert {s["name"] for s in arms} == set(CENSUS_CLASSES)
    census = {s["name"]: census_of(s) for s in arms}
    # one drain a K-window stack; the analytics drain adds the finisher
    assert census == {ARM_FULL: 1.0, ARM_FUSED: 1.0, ARM_DRAIN: 0.5,
                      "composed_mixed_algos": 0.5, ARM_ANALYTICS: 1.0}
    dev = Devprof()
    out = measure_census_arms(arms=arms, iters=1, table=dev.table)
    for name in CENSUS_CLASSES:
        row = out["arms"][name]
        assert row["kernel_events"] > 0, f"{name}: no events parsed"
        assert row["measured_ms_per_window"] > 0, f"{name}: zero time"
        assert row["census_kernels_per_window"] == census[name]
    kt = out["kernel_table"]
    assert kt["rows"] and kt["windows"] > 0
    snap = dev.kernels_snapshot(census=census)
    for name in CENSUS_CLASSES:
        slot = snap["arms"][name]
        assert slot["census_kernels_per_window"] > 0
        assert slot["measured_ms_per_window"] > 0
    json.dumps(snap)
    # the cached table counts the same census at the default K
    table = census_table(device="cpu")
    assert set(table) == set(CENSUS_CLASSES)
    assert table[ARM_DRAIN] == 0.125 and table[ARM_FULL] == 1.0


# ---------------------------------------------------------------- window clock


def _clock_snap(clk):
    snap = clk.snapshot()
    for rec in snap["slow_windows"]:
        rec.pop("at")
    return snap


def test_window_clock_ewma_and_first_observation_never_slow():
    clk = WindowClock(metrics=None, ring=4, slow_ms=0.0)
    assert clk.observe("composed_drain", 5.0) is False
    assert clk.snapshot()["arms"]["composed_drain"]["ewma_ms"] == 5000.0
    # the exact EWMA step, as the JAX clock takes it
    clk2 = WindowClock(metrics=None, ring=4, slow_ms=0.0)
    jclk = jdevprof.WindowClock(metrics=None, ring=4, slow_ms=0.0)
    for c in (clk2, jclk):
        c.observe("a", 0.010)
        c.observe("a", 0.020)
    arms = clk2.snapshot()["arms"]
    assert arms["a"]["ewma_ms"] == pytest.approx(12.0)
    assert arms["a"]["count"] == 2
    assert clk2.snapshot() == jclk.snapshot()


def test_window_clock_exemplars_are_lazy_and_ring_is_bounded():
    clk = WindowClock(metrics=Metrics(), ring=2, slow_ms=10.0)
    jclk = jdevprof.WindowClock(metrics=JMetrics(), ring=2, slow_ms=10.0)

    def boom():
        raise AssertionError("exemplar thunk ran on a fast window")

    for c in (clk, jclk):
        c.observe("arm", 0.001, trace_ids=boom)
        c.observe("arm", 0.001, trace_ids=boom)
        assert c.observe("arm", 5.0, trace_ids=lambda: ["t-1", "t-2"],
                         windows=3) is True
    rec = clk.snapshot()["slow_windows"][-1]
    assert rec["trace_ids"] == ["t-1", "t-2"]
    assert rec["arm"] == "arm" and rec["windows"] == 3
    for c in (clk, jclk):
        for _ in range(6):
            c.observe("arm", 0.000001)
            c.observe("arm", 50.0, trace_ids=list)
    assert len(clk.snapshot()["slow_windows"]) == 2
    assert _clock_snap(clk) == _clock_snap(jclk)


def test_window_clock_feeds_metrics():
    m = Metrics()
    clk = WindowClock(metrics=m, ring=4, slow_ms=1000.0)
    clk.observe("composed_drain", 0.004)
    g = m.registry.get_sample_value
    assert g("guber_tpu_device_window_ms_count",
             {"arm": "composed_drain"}) == 1.0
    assert g("guber_tpu_device_window_ewma_ms",
             {"arm": "composed_drain"}) == pytest.approx(4.0)
    assert clk.total() == 1


# ------------------------------------------------------------ shm trace region


def test_shm_trace_region_roundtrip():
    name = f"gtt-{os.getpid()}"
    ch = shm_ring.WorkerChannel.create(name, slots=4, slab_bytes=1 << 15)
    try:
        slot = ch.alloc()
        hi, lo, span = (0xDEADBEEF00000001, 0x8000000000000002,
                        0xFFFF0000ABCD0003)
        ch.set_trace(slot, hi, lo, span)
        ch.commit_cols(slot, req_id=7, n=0, key_len=0)
        ch.submit(slot)
        (rec,) = ch.pop()
        assert rec.trace == (hi, lo, span)
        # the next record without a traceparent clears the words
        ch.clear_trace(slot)
        ch.commit_cols(slot, req_id=8, n=0, key_len=0)
        ch.submit(slot)
        (rec2,) = ch.pop()
        assert rec2.trace is None
        # RAW records carry no trace region at all
        s2 = ch.alloc()
        assert ch.write_raw(s2, shm_ring.KIND_RAW, 9, b"payload")
        ch.submit(s2)
        (rec3,) = ch.pop()
        assert rec3.trace is None
    finally:
        ch.close()


def test_worker_traceparent_parses_invocation_metadata():
    from gubernator_tpu_torch.frontdoor import _Worker

    class _Ctx:
        def __init__(self, md):
            self._md = md

        def invocation_metadata(self):
            return self._md

    tp = f"00-{'ab' * 16}-{'cd' * 8}-01"
    got = _Worker.traceparent(None, _Ctx([("traceparent", tp)]))
    assert got == (int("ab" * 8, 16), int("ab" * 8, 16), int("cd" * 8, 16))
    assert _Worker.traceparent(
        None, _Ctx([("traceparent", tp.encode())])) == got
    assert _Worker.traceparent(None, _Ctx([])) is None
    assert _Worker.traceparent(
        None, _Ctx([("traceparent", "garbage")])) is None
    assert _Worker.traceparent(
        None, _Ctx([("traceparent", tp[:-2] + "00")])) is None
    assert _Worker.traceparent(None, object()) is None


# ------------------------------------------------ live instance: clock + admin


@pytest.fixture(scope="module")
def inst():
    inst = Instance(
        engine_config=EngineConfig(
            capacity_per_shard=256, batch_per_shard=64, num_shards=2,
            global_capacity=64, global_batch_per_shard=8,
            max_global_updates=8, use_native="auto"),
        device="cpu", metrics=Metrics(), tracer=Tracer(sample=1.0))
    yield inst
    inst.close()


def _reqs(n=8, pfx="dp"):
    return [RateLimitReq(name="dp", unique_key=f"{pfx}{i}", hits=1,
                         limit=1 << 20, duration=60_000)
            for i in range(n)]


def test_admin_kernels_endpoint(inst, tmp_path):
    assert inst.batcher.pipeline is not None, "native router unavailable"

    async def body():
        client = TestClient(TestServer(build_app(inst)))
        await client.start_server()
        try:
            payload = {"requests": [{"name": "dk", "uniqueKey": "k1",
                                     "hits": "1", "limit": "10",
                                     "duration": "60000"}]}
            r = await client.post("/v1/GetRateLimits", json=payload)
            assert r.status == 200
            r = await client.get("/v1/admin/kernels?census=0")
            assert r.status == 200
            out = await r.json()
            json.dumps(out)
            assert set(out) >= {"arms", "table", "windows", "clock"}
            arms = out["clock"]["arms"]
            assert arms, "no window-clock observation for a served request"
            for arm, stats in arms.items():
                assert arm in (ARM_DRAIN, ARM_ANALYTICS)
                assert stats["count"] >= 1 and stats["ewma_ms"] >= 0.0
            # a measure request conflicts with an armed capture
            assert inst.batcher.profile.arm(4, str(tmp_path))["armed"]
            r = await client.get("/v1/admin/kernels?measure=1&census=0")
            assert r.status == 409
            inst.batcher.profile.cancel()
            r = await client.get("/v1/admin/kernels?measure=1&iters=x")
            assert r.status == 400
            # the measured pass runs off the engine thread, holding the
            # profiler: an operator's arm and a periodic cycle are refused
            # meanwhile, and a second pass conflicts
            seen = {}
            real = gateway_mod.measure_census_arms

            def spy(**kw):
                seen["thread"] = threading.current_thread().name
                prof = inst.batcher.profile
                seen["armed"] = prof.armed
                seen["arm"] = prof.arm(2, str(tmp_path))["armed"]
                seen["shed"] = DevprofController(
                    prof, KernelTable(), interval=60.0).run_once()
                return real(**kw)

            gateway_mod.measure_census_arms = spy
            try:
                r = await client.get("/v1/admin/kernels?measure=1&census=0"
                                     "&iters=1")
            finally:
                gateway_mod.measure_census_arms = real
            assert r.status == 200
            out = await r.json()
            assert out["measured"][ARM_DRAIN]["measured_ms_per_window"] > 0
            assert not seen["thread"].startswith("guber-device"), seen
            assert seen["armed"] and not seen["arm"] and not seen["shed"]
            assert not inst.batcher.profile.armed
            assert inst.batcher.profile.hold()
            try:
                r = await client.get("/v1/admin/kernels?measure=1&census=0")
                assert r.status == 409
            finally:
                inst.batcher.profile.release()
            # the census rides the payload and the gauge
            r = await client.get("/v1/admin/kernels")
            assert r.status == 200
            out = await r.json()
            assert out["arms"][ARM_DRAIN]["census_kernels_per_window"] \
                == 0.125
            assert inst.metrics.registry.get_sample_value(
                "guber_tpu_kernels_per_window") == 0.125
            # the device profiler's status rides the debug snapshot
            r = await client.get("/v1/admin/debug")
            assert r.status == 200
            snap = await r.json()
            assert snap["devprof"]["mode"] == "off"
            assert snap["devprof"]["table"]["folds"] >= 0
            assert snap["profile"]["active"] is False
        finally:
            await client.close()
    asyncio.run(body())


def test_controller_run_once_folds_real_drains(inst, tmp_path):
    """One periodic cycle: arm a 2-drain capture, serve real traffic, and
    the controller folds the parsed trace into its table, then removes
    the trace directory."""
    table = KernelTable()
    ctl = DevprofController(
        inst.batcher.profile, table, interval=60.0, drains=2,
        metrics=inst.metrics,
        windows_fn=lambda: int(inst.engine.windows_processed))
    result = {}
    th = threading.Thread(
        target=lambda: result.update(ok=ctl.run_once(capture_timeout=30.0)))
    th.start()

    async def drive():
        deadline = time.monotonic() + 25.0
        i = 0
        while th.is_alive() and time.monotonic() < deadline:
            await inst.get_rate_limits(_reqs(pfx=f"c{i}"))
            i += 1
            await asyncio.sleep(0.01)

    asyncio.run(drive())
    th.join(timeout=35.0)
    assert not th.is_alive()
    assert result.get("ok") is True, ctl.status()
    assert ctl.cycles == 1 and ctl.kernel_rows > 0
    snap = table.snapshot()
    assert snap["windows"] >= 1 and snap["rows"]
    assert ARM_DRAIN in table.ms_per_window()
    assert inst.metrics.registry.get_sample_value(
        "guber_tpu_devprof_captures_total", {"status": "folded"}) >= 1.0
    # a second cycle sheds while an operator capture is armed
    assert inst.batcher.profile.arm(8, str(tmp_path / "op"))["armed"]
    try:
        assert ctl.run_once() is False
        assert ctl.sheds == 1
    finally:
        inst.batcher.profile.cancel()
