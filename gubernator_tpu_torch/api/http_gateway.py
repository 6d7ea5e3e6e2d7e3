"""HTTP JSON gateway: REST access to the same service.

The port of `gubernator_tpu/api/http_gateway.py`, replacing the
reference's grpc-gateway reverse proxy (gubernator.pb.gw.go:59-148, wired
in cmd/gubernator/main.go:107-116) with a thin aiohttp app speaking the
same proto3-JSON mapping (field names camelCased, enums as strings, via
google.protobuf.json_format, the conversion rules grpc-gateway uses):

  POST /v1/GetRateLimits   body: GetRateLimitsReq JSON
  GET  /v1/HealthCheck
  GET  /metrics            prometheus text format (main.go:113-116)
  GET  /v1/admin/topk      traffic analytics: hot-key top-K + tenants (JSON)
  GET  /v1/admin/snapshot  the state snapshot blob (?layout=int64 |
                           compact32 | auto)
  POST /v1/admin/restore   restore from a snapshot blob (?rebase_to=ms);
                           {"restoredKeys": n}, or 400 {"error", "code": 3}
                           for a bad blob
  GET  /v1/admin/debug     the runtime introspection snapshot (JSON,
                           observability/introspect.py)
  POST /v1/admin/profile   arm a torch.profiler capture of the next N
                           drains (?drains=N&dir=path, or a JSON body);
                           409 while one is armed, 400 on a bad argument
  GET  /v1/admin/kernels   census x measured ms/window per serving arm,
                           the rolling kernel table and the window clock
                           (observability/devprof.py); ?census=0 skips the
                           census, ?measure=1&iters=N runs the measured
                           pass (409 while a capture is armed or
                           another pass runs)

The gateway calls the Instance in-process and observes its requests under
the gRPC method names when the Instance has metrics.  With QoS on (the
default) an X-Guber-Timeout-Ms header carries the client's remaining
budget into admission as the request's deadline, and one that is not a
number is refused with 400, as in the JAX gateway.  A `traceparent`
header continues the caller's trace (or the Instance's tracer samples a
new `http` root) and the root's context is echoed back in the same
header.  The census runs on the engine thread.  The measured pass runs on
a thread of its own while serving drains go on: its counts are that
thread's, its rows only the work launched inside its counted spans, and
it holds the process's one profiler (ProfileCapture.hold), so a capture
armed meanwhile gets 409 and a periodic cycle sheds.  The body
cap is 1 GiB, as in the JAX gateway: a full arena's snapshot is far past
aiohttp's 1 MiB default.
"""

from __future__ import annotations

import asyncio
import time

from aiohttp import web
from google.protobuf import json_format

from gubernator_tpu_torch.api import pb
from gubernator_tpu_torch.core.service import BatchTooLargeError, Instance
from gubernator_tpu_torch.observability.devprof import (
    census_table,
    measure_census_arms,
)
from gubernator_tpu_torch.observability.introspect import build_debug_snapshot
from gubernator_tpu_torch.observability.metrics import CONTENT_TYPE_LATEST
from gubernator_tpu_torch.observability.tracing import TRACEPARENT
from gubernator_tpu_torch.state.snapshot import SnapshotError


def build_app(instance: Instance) -> web.Application:
    def observe(method: str, start: float, ok: bool) -> None:
        if instance.metrics is not None:
            instance.metrics.observe_rpc(method, start, ok=ok)

    async def get_rate_limits(request: web.Request) -> web.Response:
        # the HTTP leg of trace propagation: continue an incoming
        # traceparent (or sample a new root) and echo the context back
        tracer = instance.tracer
        if tracer is None or not tracer.enabled:
            return await _get_rate_limits(request)
        with tracer.start_trace(
                "http", request.headers.get(TRACEPARENT)) as root:
            resp = await _get_rate_limits(request)
            if root.ctx is not None:
                resp.headers[TRACEPARENT] = root.ctx.traceparent()
            return resp

    async def _get_rate_limits(request: web.Request) -> web.Response:
        start = time.monotonic()
        ok = False
        try:
            try:
                body = await request.text()
                msg = json_format.Parse(body, pb.GetRateLimitsReq())
            except json_format.ParseError as e:
                return web.json_response({"error": str(e), "code": 3},
                                         status=400)
            # QoS deadline propagation: X-Guber-Timeout-Ms carries the
            # client's remaining budget (grpc-gateway's grpc-timeout
            # analog); admission sheds what cannot be served in time
            deadline = None
            if instance.qos is not None:
                timeout_ms = request.headers.get("X-Guber-Timeout-Ms")
                timeout_s = None
                if timeout_ms:
                    try:
                        timeout_s = float(timeout_ms) / 1000.0
                    except ValueError:
                        return web.json_response(
                            {"error": "invalid X-Guber-Timeout-Ms header",
                             "code": 3}, status=400)
                deadline = instance.qos.deadline_from_timeout(timeout_s)
            try:
                resps = await instance.get_rate_limits(
                    [pb.req_from_pb(r) for r in msg.requests],
                    deadline=deadline)
            except BatchTooLargeError as e:
                return web.json_response({"error": str(e), "code": 11},
                                         status=400)
            ok = True
            out = pb.GetRateLimitsResp(
                responses=[pb.resp_to_pb(r) for r in resps])
            return web.json_response(
                json_format.MessageToDict(out,
                                          preserving_proto_field_name=False))
        finally:
            # every request is observed, unexpected 500s included
            observe("/pb.gubernator.V1/GetRateLimits", start, ok)

    async def health_check(request: web.Request) -> web.Response:
        start = time.monotonic()
        h = await instance.health_check()
        observe("/pb.gubernator.V1/HealthCheck", start, True)
        msg = pb.HealthCheckResp(
            status=h.status, message=h.message, peer_count=h.peer_count)
        return web.json_response(
            json_format.MessageToDict(msg, preserving_proto_field_name=False))

    async def metrics(request: web.Request) -> web.Response:
        if instance.metrics is None:
            return web.json_response(
                {"error": "metrics disabled (Instance(metrics=None))",
                 "code": 12}, status=404)
        # the full prometheus content type, charset parameter included:
        # aiohttp's content_type argument rejects parameters
        return web.Response(
            body=instance.metrics.expose(),
            headers={"Content-Type": CONTENT_TYPE_LATEST},
        )

    async def admin_debug(request: web.Request) -> web.Response:
        return web.json_response(build_debug_snapshot(instance))

    async def admin_topk(request: web.Request) -> web.Response:
        # hot-key view of the traffic analytics: 404 when the subsystem
        # is off, so a client can say why
        an = instance.analytics
        if an is None:
            return web.json_response(
                {"error": "analytics disabled (set GUBER_ANALYTICS=1)",
                 "code": 12}, status=404)
        try:
            n = int(request.query.get("n", an.conf.topk))
        except ValueError:
            return web.json_response({"error": "invalid n", "code": 3},
                                     status=400)
        snap = an.snapshot()
        snap["topk"] = an.topk_snapshot(n)
        return web.json_response(snap)

    async def admin_profile(request: web.Request) -> web.Response:
        body = {}
        if request.can_read_body:
            try:
                body = await request.json()
            except Exception:
                return web.json_response(
                    {"error": "malformed JSON body", "code": 3}, status=400)
        drains = body.get("drains", request.query.get("drains", 1))
        trace_dir = body.get("dir", request.query.get("dir", ""))
        try:
            drains = int(drains)
        except (TypeError, ValueError):
            return web.json_response({"error": "invalid drains", "code": 3},
                                     status=400)
        out = instance.batcher.profile.arm(drains, trace_dir)
        # already armed is a conflict, not a new capture
        return web.json_response(out,
                                 status=200 if out.get("armed") else 409)

    async def admin_kernels(request: web.Request) -> web.Response:
        """Census and measured ms/window per serving arm, the rolling
        kernel table and the window clock (observability/devprof.py)."""
        devprof = instance.devprof
        q = request.query
        loop = asyncio.get_running_loop()
        engine_thread = instance.batcher._executor
        dev = instance.engine.device
        census = None
        if q.get("census", "1") not in ("0", "false"):
            census = await loop.run_in_executor(
                engine_thread, lambda: census_table(device=dev))
            # keep the gauge current (the daemon's boot publishes it too)
            kpw = census.get(instance.census_arm())
            if instance.metrics is not None and kpw:
                instance.metrics.kernels_per_window.set(kpw)
        measured = None
        if q.get("measure") in ("1", "true"):
            try:
                iters = max(1, int(q.get("iters", 2)))
            except (TypeError, ValueError):
                return web.json_response(
                    {"error": "invalid iters", "code": 3}, status=400)
            # the pass runs on a thread of its own, so serving drains go
            # on: its counts are that thread's and its rows the work
            # launched inside its counted spans, and it holds the
            # profiler so that no capture starts meanwhile
            profile = instance.batcher.profile
            if not profile.hold():
                return web.json_response(
                    {"error": "capture already in progress", "code": 10},
                    status=409)
            try:
                measured = await loop.run_in_executor(
                    None, lambda: measure_census_arms(
                        iters=iters, table=devprof.table, device=dev))
            finally:
                profile.release()
        out = devprof.kernels_snapshot(census=census)
        if measured is not None:
            out["measured"] = measured["arms"]
            for arm, row in measured["arms"].items():
                slot = out["arms"].setdefault(
                    arm, {"census_kernels_per_window": None,
                          "measured_ms_per_window": None})
                slot["measured_ms_per_window"] = row["measured_ms_per_window"]
        return web.json_response(out)

    # the state lifecycle's admin plane: the blob travels as it is (it is
    # versioned and checksummed already)
    async def admin_snapshot(request: web.Request) -> web.Response:
        data = await instance.export_snapshot_bytes(
            layout=request.query.get("layout", "auto"))
        return web.Response(body=data,
                            content_type="application/octet-stream")

    async def admin_restore(request: web.Request) -> web.Response:
        data = await request.read()
        rebase = request.query.get("rebase_to")
        try:
            n = await instance.restore_snapshot_bytes(
                data, rebase_to=int(rebase) if rebase else None)
        except SnapshotError as e:
            return web.json_response({"error": str(e), "code": 3},
                                     status=400)
        return web.json_response({"restoredKeys": n})

    # a full arena's snapshot is hundreds of MB, far past aiohttp's 1 MiB
    # default body cap, which would refuse every real admin restore
    app = web.Application(client_max_size=1 << 30)
    app.router.add_post("/v1/GetRateLimits", get_rate_limits)
    app.router.add_get("/v1/HealthCheck", health_check)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/v1/admin/snapshot", admin_snapshot)
    app.router.add_post("/v1/admin/restore", admin_restore)
    app.router.add_get("/v1/admin/topk", admin_topk)
    app.router.add_get("/v1/admin/debug", admin_debug)
    app.router.add_post("/v1/admin/profile", admin_profile)
    app.router.add_get("/v1/admin/kernels", admin_kernels)
    return app


class HttpGateway:
    def __init__(self, instance: Instance, address: str):
        self.app = build_app(instance)
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self._runner: web.AppRunner | None = None

    async def start(self) -> None:
        self._runner = web.AppRunner(self.app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        if self.port == 0:
            # an OS-assigned port: read back the one bound
            self.port = self._runner.addresses[0][1]

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
