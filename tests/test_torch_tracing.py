"""The port's request tracing (observability/tracing.py, a copy of the
JAX module) and the peer plane's spans: the unit tests of
tests/test_tracing.py (:47-141, the stage quantile snapshot of :144-165
and the stage histogram of :167) on the port's tracer and metrics, and
the stitched
cross-node trace of `test_forwarded_request_yields_one_stitched_trace`
on a three-node port cluster over real gRPC: a request dialed at a
non-owner yields one trace whose spans cover the non-owner's `rpc` root,
its `peer_forward` hop and the owner's `peer_rpc` root, stitched by the
`traceparent` metadata the peer lane sends, the owner's drain-stage spans
among them.  The drain-stage spans of tests/test_tracing.py:260-470: an
owned request's enqueue, admission_wait, window_fill, device_dispatch and
drain_commit spans; the stage histograms' sums against the end-to-end RPC
total; the debug snapshot; chain_fetch accounting at stride 4; the profile
endpoint.  The HTTP gateway continues and echoes `traceparent`.
"""

import asyncio
import json
import time

import pytest
from aiohttp.test_utils import TestClient, TestServer

from gubernator_tpu_torch import cluster as cluster_mod
from gubernator_tpu_torch import native
from gubernator_tpu_torch.api.http_gateway import build_app
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    Second,
)
from gubernator_tpu_torch.client import AsyncClient
from gubernator_tpu_torch.config import BehaviorConfig, EngineConfig
from gubernator_tpu_torch.core.batcher import WindowBatcher
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.observability.metrics import Metrics
from gubernator_tpu_torch.observability.tracing import (
    NOOP_SPAN,
    TRACEPARENT,
    SpanContext,
    Tracer,
    current_context,
    parse_traceparent,
)

pytestmark = pytest.mark.torch_port

# the drain's stage spans (JAX tests/test_tracing.py DRAIN_STAGES)
DRAIN_STAGES = ("window_fill", "device_dispatch", "drain_commit")


# --------------------------------------------------------------- unit: tracer


def test_traceparent_roundtrip():
    ctx = SpanContext("ab" * 16, "cd" * 8)
    tp = ctx.traceparent()
    assert tp == f"00-{'ab' * 16}-{'cd' * 8}-01"
    back = parse_traceparent(tp)
    assert back is not None
    assert back.trace_id == ctx.trace_id
    assert back.span_id == ctx.span_id


@pytest.mark.parametrize("bad", [
    None, "", "garbage", "00-short-cd-01",
    f"00-{'zz' * 16}-{'cd' * 8}-01",       # non-hex trace id
    f"00-{'ab' * 16}-{'cd' * 8}-00",       # unsampled flag: honored as off
])
def test_traceparent_rejects(bad):
    assert parse_traceparent(bad) is None


def test_sampling_off_is_noop():
    t = Tracer(sample=0.0, export="")
    assert not t.enabled
    assert t.start_trace("rpc") is NOOP_SPAN
    assert t.span("child") is NOOP_SPAN
    assert current_context() is None
    assert t.spans() == []


def test_root_and_child_record_one_trace():
    t = Tracer(sample=1.0, export="", node="n1")
    with t.start_trace("rpc") as root:
        assert current_context() is root.ctx
        with t.span("peer_forward") as child:
            child.set_attr("peer", "host:81")
    assert current_context() is None
    spans = t.spans()
    assert [s.name for s in spans] == ["peer_forward", "rpc"]
    fwd, rpc = spans
    assert fwd.trace_id == rpc.trace_id
    assert fwd.parent_id == rpc.span_id
    assert rpc.parent_id == ""
    assert fwd.attrs == {"peer": "host:81"}
    assert all(s.node == "n1" for s in spans)


def test_propagated_traceparent_continues_trace():
    t1 = Tracer(sample=1.0, export="", node="a")
    t2 = Tracer(sample=0.0, export="", node="b")  # sampling off locally
    with t1.start_trace("rpc") as root:
        tp = root.ctx.traceparent()
    # the upstream already paid the sampling dice roll: the downstream
    # node continues the trace even with local sampling off
    with t2.start_trace("peer_rpc", tp) as cont:
        assert cont.ctx is not None
        assert cont.ctx.trace_id == root.ctx.trace_id
    (span,) = t2.spans()
    assert span.parent_id == root.ctx.span_id


def test_record_span_explicit_timestamps():
    t = Tracer(sample=1.0, export="")
    ctx = SpanContext("ab" * 16, "cd" * 8)
    t.record_span(ctx, "drain_commit", 10.0, 10.25)
    (span,) = t.spans()
    assert span.name == "drain_commit"
    assert span.trace_id == ctx.trace_id
    assert span.parent_id == ctx.span_id
    assert abs(span.duration - 0.25) < 1e-9
    # None ctx (unsampled request) records nothing
    t.record_span(None, "drain_commit", 0.0, 1.0)
    assert len(t.spans()) == 1


def test_recent_traces_summary():
    t = Tracer(sample=1.0, export="", node="n")
    with t.start_trace("rpc"):
        with t.span("window_fill"):
            pass
    (summary,) = t.recent_traces()
    assert summary["root"] == "rpc"
    assert summary["spans"] == 2
    assert summary["nodes"] == ["n"]
    assert summary["duration_ms"] >= 0.0


def test_span_ring_is_bounded():
    t = Tracer(sample=1.0, export="", max_spans=16)
    for i in range(64):
        ctx = SpanContext("ab" * 16, "cd" * 8)
        t.record_span(ctx, f"s{i}", 0.0, 1.0)
    assert len(t.spans()) == 16
    assert t.spans()[-1].name == "s63"


# ------------------------------------------------------------ unit: stages


def test_stage_snapshot_quantiles():
    """The rolling per-stage quantiles /v1/admin/debug reads (JAX
    tests/test_tracing.py:144-157)."""
    from gubernator_tpu_torch.observability.metrics import Metrics
    m = Metrics()
    for v in range(1, 101):  # 1..100 ms
        m.observe_stage("drain_commit", v / 1000.0)
    snap = m.stage_snapshot()
    assert set(snap) == {"drain_commit"}
    s = snap["drain_commit"]
    assert s["count"] == 100
    assert abs(s["p50_ms"] - 50.0) < 1.01
    assert abs(s["p95_ms"] - 95.0) < 1.01
    assert abs(s["p99_ms"] - 99.0) < 1.01
    # a negative observation clamps instead of corrupting the ring
    m.observe_stage("enqueue", -1.0)
    assert m.stage_snapshot()["enqueue"]["p99_ms"] == 0.0


def test_stage_snapshot_orders_canonically():
    """Stages come back in the JAX package's canonical order
    (tests/test_tracing.py:160-165), the names equal to its STAGES."""
    from gubernator_tpu.observability.metrics import STAGES as JSTAGES
    from gubernator_tpu_torch.observability.metrics import STAGES, Metrics
    assert STAGES == JSTAGES
    m = Metrics()
    for stage in reversed(STAGES):
        m.observe_stage(stage, 0.001)
    m.observe_stage("zz_custom", 0.001)
    assert list(m.stage_snapshot()) == list(STAGES) + ["zz_custom"]


def test_stage_histogram_exposed():
    """The peer plane's stages land in the stage histogram under the JAX
    package's name."""
    from gubernator_tpu_torch.observability.metrics import Metrics
    m = Metrics()
    m.observe_stage("peer_forward", 0.002)
    m.observe_stage("global_broadcast", -1.0)  # clamps at 0
    text = m.expose().decode("utf-8")
    assert 'guber_tpu_stage_duration_ms_bucket{' in text
    assert 'stage="peer_forward"' in text
    assert m.registry.get_sample_value(
        "guber_tpu_stage_duration_ms_count",
        {"stage": "peer_forward"}) == 1.0
    assert m.registry.get_sample_value(
        "guber_tpu_stage_duration_ms_sum",
        {"stage": "global_broadcast"}) == 0.0


def test_instance_tracer_reads_the_env_and_labels_its_node(monkeypatch):
    monkeypatch.setenv("GUBER_TRACE_SAMPLE", "0.25")
    inst = Instance(device="cpu", advertise_address="10.0.0.1:81")
    try:
        assert inst.tracer.sample == 0.25
        assert inst.tracer.node == "10.0.0.1:81"
    finally:
        inst.close()


# ------------------------------------------------------------------- cluster


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


@pytest.fixture(scope="module")
def cluster(loop):
    c = loop.run_until_complete(cluster_mod.start(3, device="cpu"))
    for i in range(3):
        c.instance_at(i).tracer.sample = 1.0
    yield c
    loop.run_until_complete(c.stop())


def run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout=60))


def test_forwarded_request_yields_one_stitched_trace(cluster, loop):
    async def body():
        owner_idx = await cluster.owner_index_of("tr_stitch_account:7")
        non_owner_idx = (owner_idx + 1) % len(cluster.addresses)
        non_owner = cluster.instance_at(non_owner_idx)
        owner = cluster.instance_at(owner_idx)

        client = AsyncClient(cluster.peer_at(non_owner_idx))
        rs = await client.get_rate_limits([RateLimitReq(
            name="tr_stitch", unique_key="account:7", hits=1, limit=2,
            duration=Second)])
        assert rs[0].error == ""
        assert rs[0].metadata["owner"] == cluster.peer_at(owner_idx)
        await client.close()

        # non-owner side: the root rpc span and the forward hop
        fwd = [s for s in non_owner.tracer.spans()
               if s.name == "peer_forward"]
        assert fwd, "peer_forward span missing on the non-owner"
        tid = fwd[-1].trace_id
        mine = [s for s in non_owner.tracer.spans() if s.trace_id == tid]
        roots = [s for s in mine if s.name == "rpc"]
        assert roots and roots[0].parent_id == ""
        assert fwd[-1].parent_id == roots[0].span_id
        assert fwd[-1].attrs["peer"] == cluster.peer_at(owner_idx)

        # owner side: the same trace id, rooted at the peer hop's server
        # span under the forward span
        theirs = [s for s in owner.tracer.spans() if s.trace_id == tid]
        peer_roots = [s for s in theirs if s.name == "peer_rpc"]
        assert peer_roots
        assert peer_roots[0].parent_id == fwd[-1].span_id
        their_names = {s.name for s in theirs}
        assert their_names & set(DRAIN_STAGES), (
            f"no drain-stage span on the owner; got {their_names}")

        # distinct node labels on the two halves
        assert {s.node for s in mine} == {cluster.peer_at(non_owner_idx)}
        assert {s.node for s in theirs} == {cluster.peer_at(owner_idx)}

        # the stitched trace shows up in the owner's recent-trace summary
        summaries = [t for t in owner.tracer.recent_traces(limit=50)
                     if t["trace_id"] == tid]
        assert summaries and summaries[0]["spans"] == len(theirs)
    run(loop, body())


def req(name, key, hits=1, limit=10, duration=Second):
    return RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                        duration=duration, algorithm=Algorithm.TOKEN_BUCKET,
                        behavior=Behavior.BATCHING)


def test_owned_request_records_drain_stage_spans(cluster, loop):
    async def body():
        owner_idx = await cluster.owner_index_of("tr_local_account:1")
        inst = cluster.instance_at(owner_idx)
        client = AsyncClient(cluster.peer_at(owner_idx))
        rs = await client.get_rate_limits([req("tr_local", "account:1")])
        assert rs[0].error == ""
        await client.close()
        # the newest trace rooted at this node's rpc span carries the
        # drain's whole decomposition
        rpc_spans = [s for s in inst.tracer.spans() if s.name == "rpc"]
        assert rpc_spans
        tid = rpc_spans[-1].trace_id
        names = {s.name for s in inst.tracer.spans() if s.trace_id == tid}
        for stage in DRAIN_STAGES:
            assert stage in names, f"missing {stage} in {names}"
        assert "enqueue" in names
        assert "admission_wait" in names
    run(loop, body())


def test_stage_sums_match_e2e_duration(cluster, loop):
    """The sum of the drain stages' histogram totals stays within slack of
    the end-to-end grpc_request_duration_milliseconds total on the same
    node (stages overlap pipelined requests, so the bound is generous)."""
    async def body():
        owner_idx = await cluster.owner_index_of("tr_sum_account:1")
        inst = cluster.instance_at(owner_idx)
        reg = inst.metrics.registry

        def stage_sum():
            return sum(reg.get_sample_value(
                "guber_tpu_stage_duration_ms_sum", {"stage": st}) or 0.0
                for st in ("admission_wait", "window_fill",
                           "device_dispatch", "drain_commit"))

        def e2e_sum():
            return reg.get_sample_value(
                "grpc_request_duration_milliseconds_sum",
                {"method": "/pb.gubernator.V1/GetRateLimits"}) or 0.0

        s0, e0 = stage_sum(), e2e_sum()
        client = AsyncClient(cluster.peer_at(owner_idx))
        for _ in range(20):
            rs = await client.get_rate_limits([req("tr_sum", "account:1")])
            assert rs[0].error == ""
        await client.close()
        ds, de = stage_sum() - s0, e2e_sum() - e0
        assert de > 0.0
        assert ds > 0.0, "no stage time recorded for served requests"
        assert ds >= de * 0.02, (ds, de)
        assert ds <= de * 2.0 + 50.0, (ds, de)
    run(loop, body())


# --------------------------------------------------------------- admin plane


@pytest.fixture(scope="module")
def admin(loop):
    inst = Instance(
        engine_config=EngineConfig(
            capacity_per_shard=256, batch_per_shard=64, num_shards=2,
            global_capacity=64, global_batch_per_shard=8,
            max_global_updates=8),
        device="cpu", metrics=Metrics(),
        tracer=Tracer(sample=1.0, export="", node="admin"))
    client = loop.run_until_complete(_make_client(inst))
    yield client, inst
    loop.run_until_complete(client.close())
    inst.close()


async def _make_client(inst):
    client = TestClient(TestServer(build_app(inst)))
    await client.start_server()
    return client


def test_debug_endpoint_snapshot(admin, loop):
    client, inst = admin

    async def body():
        payload = {"requests": [{"name": "dbg", "uniqueKey": "k1",
                                 "hits": "1", "limit": "10",
                                 "duration": "60000"}]}
        r = await client.post("/v1/GetRateLimits", json=payload)
        assert r.status == 200
        assert "traceparent" in r.headers
        r = await client.get("/v1/admin/debug")
        assert r.status == 200
        snap = await r.json()
        json.dumps(snap)
        assert snap["standalone"] is True
        assert "size" in snap["engine"]
        assert snap["admission"]["max_pending"] > 0
        assert snap["congestion"]["effective_window"] > 0
        assert "window_fill" in snap["stages"]
        assert snap["tracing"]["sample"] == 1.0
        assert snap["tracing"]["recent_traces"]
        assert snap["profile"]["active"] is False
        assert snap["devprof"]["clock"]["arms"]["composed_drain"]["count"]
    run(loop, body())


def test_debug_snapshot_timeline_without_metrics(loop):
    """The always-on drain ring feeds the debug view with no Metrics
    registry (no prometheus_client): its `stages` table holds the drain
    stages on the stage histograms' boundaries, and pipeline.timeline the
    last drains' jobs, decisions, fold factor and windows per drain, the
    router's clocks per 1000 decisions, the fill's CPU share and the
    host-state shares."""
    if not native.available():
        pytest.skip("native router unavailable")
    from gubernator_tpu_torch.core.drain_ring import HOST_STATES
    from gubernator_tpu_torch.observability.introspect import (
        build_debug_snapshot,
    )
    inst = Instance(
        engine_config=EngineConfig(
            capacity_per_shard=256, batch_per_shard=64, num_shards=2,
            global_capacity=64, global_batch_per_shard=8,
            max_global_updates=8, use_native="on"),
        device="cpu")
    assert inst.metrics is None

    async def body():
        for i in range(4):
            out = await asyncio.gather(*(inst.get_rate_limits(
                [req("tl", f"k{i}_{j}_{n}") for n in range(5)])
                for j in range(6)))
            assert all(r.error == "" for rs in out for r in rs)

    try:
        run(loop, body())
        snap = json.loads(json.dumps(build_debug_snapshot(inst)))
    finally:
        inst.close()
    pipe = snap["pipeline"]
    tl = pipe["timeline"]
    assert tl["drains"] == tl["drains_written"] == pipe["drains"] >= 1
    for stage in ("engine_queue", "window_fill", "device_dispatch",
                  "drain_commit"):
        q = snap["stages"][stage]
        assert 0 <= q["p50_ms"] <= q["p95_ms"] <= q["p99_ms"], stage
        assert q["count"] == tl["drains"]
    assert tl["decisions_per_drain"] * tl["drains"] == pytest.approx(
        pipe["decisions_staged"])
    assert tl["decisions_per_lane"] == pytest.approx(
        pipe["decisions_staged"] / pipe["lanes_staged"])
    assert tl["jobs_per_drain"] >= 1 and tl["windows_per_drain"] >= 1
    # get_rate_limits takes the column lane: no router parse or encode
    assert tl["parse_c_us_per_kdec"] == tl["encode_c_us_per_kdec"] == 0
    assert 0 < tl["fill_cpu_pct"] <= 100.0
    assert set(tl["host_state_pct"]) == set(HOST_STATES)
    assert sum(tl["host_state_pct"].values()) == pytest.approx(100.0)
    assert tl["host_state_pct"]["fill"] > 0


def test_chain_fetch_stage_accounting_stride4():
    """With a fetch stride of 4 every chained member reports the shared
    fetch window as one `chain_fetch` span, the stage histogram sees one
    chain_fetch observation a chain (not one a member), and the stages
    reconcile with the burst's wall time."""
    if not native.available():
        pytest.skip("native router unavailable")
    eng = RateLimitEngine(capacity_per_shard=256, batch_per_shard=64,
                          global_capacity=16, global_batch_per_shard=8,
                          max_global_updates=8, use_native="on",
                          device="cpu")
    m = Metrics()
    tr = Tracer(sample=1.0, export="")
    b = WindowBatcher(eng, BehaviorConfig(), metrics=m, tracer=tr)
    p = b.pipeline
    assert p is not None and p.enabled
    p.gate_enabled = False
    p.coalesce_wait = 0.0
    p.depth = 5
    p.fetch_stride = 4
    p.fetch_stride_max = max(4, p.fetch_stride_max)
    p.chain_linger = 5.0
    batches = [[RateLimitReq(name="cf", unique_key=f"s{w}k{i}", hits=1,
                             limit=50, duration=60_000)
                for i in range(8)] for w in range(4)]

    async def run_burst():
        # hold the engine thread so the pumped drains queue up and chain
        p._engine_executor.submit(time.sleep, 0.1)
        tasks = []
        for batch in batches:
            with tr.start_trace("rpc"):
                tasks.append(asyncio.ensure_future(b.submit_now(batch)))
            await asyncio.sleep(0)
        return await asyncio.gather(*tasks)

    t0 = time.monotonic()
    try:
        got = asyncio.run(run_burst())
    finally:
        b.close()
    wall_ms = (time.monotonic() - t0) * 1000.0
    assert all(len(rs) == 8 for rs in got)
    assert p.fetch_elided >= 1, "no chain formed at stride 4"
    chain = [s for s in tr.spans() if s.name == "chain_fetch"]
    assert chain, "no chain_fetch span recorded for chained members"
    assert all(s.duration > 0 for s in chain)
    reg = m.registry
    cf_count = reg.get_sample_value("guber_tpu_stage_duration_ms_count",
                                    {"stage": "chain_fetch"})
    assert cf_count is not None and cf_count >= 1.0
    assert cf_count <= 4 - p.fetch_elided

    def s_sum(stage):
        return reg.get_sample_value("guber_tpu_stage_duration_ms_sum",
                                    {"stage": stage}) or 0.0

    ds = sum(s_sum(st) for st in ("window_fill", "device_dispatch",
                                  "drain_commit", "chain_fetch"))
    assert ds > 0.0
    assert ds <= wall_ms * 2.0 + 50.0, (ds, wall_ms)


class _FakeProfile:
    """Stands in for torch.profiler.profile: records the calls."""

    calls: list = []

    def __init__(self, activities=None):
        self.calls.append(("new", tuple(activities or ())))

    def start(self):
        self.calls.append(("start", None))

    def stop(self):
        self.calls.append(("stop", None))

    def export_chrome_trace(self, path):
        self.calls.append(("export", path))
        with open(path, "w") as fh:
            fh.write('{"traceEvents": []}')


def test_profile_endpoint_arms_capture(admin, loop, monkeypatch, tmp_path):
    client, inst = admin
    import torch.profiler
    _FakeProfile.calls = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    cap = str(tmp_path / "cap")

    async def body():
        r = await client.post(f"/v1/admin/profile?drains=1&dir={cap}")
        assert r.status == 200
        out = await r.json()
        assert out["armed"] is True and out["dir"] == cap
        # a second arm conflicts
        r = await client.post("/v1/admin/profile?drains=1")
        assert r.status == 409
        # the next drain runs under the profiler, then disarms
        payload = {"requests": [{"name": "prof", "uniqueKey": "k1",
                                 "hits": "1", "limit": "10",
                                 "duration": "60000"}]}
        r = await client.post("/v1/GetRateLimits", json=payload)
        assert r.status == 200
        kinds = [k for k, _ in _FakeProfile.calls]
        assert kinds == ["new", "start", "stop", "export"]
        assert _FakeProfile.calls[-1][1].startswith(cap)
        assert inst.batcher.profile.status()["active"] is False
        # a JSON body arms too; a bad count is refused
        r = await client.post("/v1/admin/profile?drains=nope")
        assert r.status == 400
        r = await client.post("/v1/admin/profile", data=b"{not json",
                              headers={"Content-Type": "application/json"})
        assert r.status == 400
    run(loop, body())


def test_http_gateway_continues_and_echoes_traceparent():
    async def body():
        inst = Instance(device="cpu",
                        tracer=Tracer(sample=1.0, export="", node="gw"))
        client = TestClient(TestServer(build_app(inst)))
        await client.start_server()
        try:
            upstream = SpanContext("ab" * 16, "cd" * 8)
            resp = await client.post(
                "/v1/GetRateLimits",
                json={"requests": [{"name": "h", "uniqueKey": "k",
                                    "hits": "1", "limit": "5",
                                    "duration": "1000"}]},
                headers={TRACEPARENT: upstream.traceparent()})
            assert resp.status == 200
            echoed = parse_traceparent(resp.headers[TRACEPARENT])
            plain = await client.post(
                "/v1/GetRateLimits",
                json={"requests": [{"name": "h", "uniqueKey": "k"}]})
            return upstream, echoed, \
                parse_traceparent(plain.headers[TRACEPARENT]), \
                inst.tracer.spans()
        finally:
            await client.close()
            inst.close()

    upstream, echoed, plain, spans = asyncio.run(body())
    # the propagated request continues the caller's trace; the other
    # roots a new one; each echoes its root's context
    assert echoed.trace_id == upstream.trace_id
    assert plain.trace_id != upstream.trace_id
    # the roots, each with its drain's stage spans under it
    cont, root = [s for s in spans if s.name == "http"]
    for r in (cont, root):
        assert {s.name for s in spans if s.parent_id == r.span_id} >= set(
            DRAIN_STAGES)
    assert (cont.name, cont.parent_id) == ("http", upstream.span_id)
    assert (root.name, root.parent_id) == ("http", "")
    assert (cont.span_id, root.span_id) == (echoed.span_id, plain.span_id)
