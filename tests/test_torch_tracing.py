"""The port's request tracing (observability/tracing.py, a copy of the
JAX module) and the peer plane's spans: the unit tests of
tests/test_tracing.py (:47-141, and the stage histogram of :167; its
quantile snapshot, :144-165, waits for ROADMAP item 7) on the port's
tracer and metrics, and the stitched
cross-node trace of `test_forwarded_request_yields_one_stitched_trace`
on a three-node port cluster over real gRPC: a request dialed at a
non-owner yields one trace whose spans cover the non-owner's `rpc` root,
its `peer_forward` hop and the owner's `peer_rpc` root, stitched by the
`traceparent` metadata the peer lane sends.  The owner's drain-stage spans
(window_fill, device_dispatch, drain_commit) are ROADMAP item 7's and are
not asserted here.  The HTTP gateway continues and echoes `traceparent`.
"""

import asyncio

import pytest
from aiohttp.test_utils import TestClient, TestServer

from gubernator_tpu_torch import cluster as cluster_mod
from gubernator_tpu_torch.api.http_gateway import build_app
from gubernator_tpu_torch.api.types import RateLimitReq, Second
from gubernator_tpu_torch.client import AsyncClient
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.observability.tracing import (
    NOOP_SPAN,
    TRACEPARENT,
    SpanContext,
    Tracer,
    current_context,
    parse_traceparent,
)

pytestmark = pytest.mark.torch_port


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


def test_stage_histogram_exposed():
    """The peer plane's stages land in the stage histogram under the JAX
    package's name (its rolling quantile snapshot waits for the
    observability item, ROADMAP item 7)."""
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

        # distinct node labels on the two halves
        assert {s.node for s in mine} == {cluster.peer_at(non_owner_idx)}
        assert {s.node for s in theirs} == {cluster.peer_at(owner_idx)}

        # the stitched trace shows up in the owner's recent-trace summary
        summaries = [t for t in owner.tracer.recent_traces(limit=50)
                     if t["trace_id"] == tid]
        assert summaries and summaries[0]["spans"] == len(theirs)
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
    cont, root = spans
    assert (cont.name, cont.parent_id) == ("http", upstream.span_id)
    assert (root.name, root.parent_id) == ("http", "")
    assert (cont.span_id, root.span_id) == (echoed.span_id, plain.span_id)
