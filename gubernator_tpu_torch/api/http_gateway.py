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

The gateway calls the Instance in-process and observes its requests under
the gRPC method names when the Instance has metrics.  With QoS on (the
default) an X-Guber-Timeout-Ms header carries the client's remaining
budget into admission as the request's deadline, and one that is not a
number is refused with 400, as in the JAX gateway.  A `traceparent`
header continues the caller's trace (or the Instance's tracer samples a
new `http` root) and the root's context is echoed back in the same
header.  The profile and kernels routes wait for the port of device
profiling (ROADMAP item 7).  The body cap is 1 GiB, as in the JAX
gateway: a full arena's snapshot is far past aiohttp's 1 MiB default.
"""

from __future__ import annotations

import time

from aiohttp import web
from google.protobuf import json_format

from gubernator_tpu_torch.api import pb
from gubernator_tpu_torch.core.service import BatchTooLargeError, Instance
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
