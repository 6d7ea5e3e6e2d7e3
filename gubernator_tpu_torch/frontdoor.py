"""Multi-process front door: SO_REUSEPORT-sharded gRPC acceptors with a
shared-memory columnar hand-off to the engine process.

The port of `gubernator_tpu/frontdoor.py`.  Serving splits into N frontend
WORKER processes and the one ENGINE process:

  * every worker binds the SAME public port via SO_REUSEPORT (the kernel
    balances accepted connections across workers); when the kernel or a
    port collision refuses that, a worker falls back to an ephemeral port
    of its own, published in the status block (`debug_snapshot`);
  * each worker runs its own event loop and parses GetRateLimitsReq bytes
    once, in C (native frontdoor_parse_req), straight into request columns
    inside a shared-memory slab (core/shm_ring.py);
  * the engine keeps sole ownership of the card, the arenas and GLOBAL
    sync.  COLS records ride the pipeline as ColsJobs (core/pipeline.py):
    pack_stack_fast packs the slab's columns and the job rides a
    drain_compact drain.  Everything else (small RPCs, requests the parser
    refuses, GLOBAL items, the PeersV1 plane) ships as RAW bytes and runs
    the same server.py serve_* bodies the in-process servicers run;
  * the response direction mirrors the request one
    (GUBER_FRONTDOOR_ENCODE=worker, the default): the engine's completion
    writes the decision columns (status, limit, remaining, reset and a
    shed flag) into the slab and the WORKER encodes the protobuf
    (native frontdoor_encode_resp, protobuf as its fallback).  Responses
    columns cannot express (error strings, other metadata) are serialized
    on the engine side and counted (`encode_fallbacks`);
  * workers coalesce wire reads (GUBER_FRONTDOOR_BATCH_READS): RPCs that
    land in the same event-loop tick parse into ONE slab as a
    KIND_BATCH_COLS record (one ring publish, one pipeline job) and the
    completion's columns split back per RPC by the counts region;
  * workers answer HealthCheck from the engine-heartbeated status block
    and shed in-band, with no round trip, on the shared draining and
    saturation flags and when every slab is in flight (shed_reason
    ring_full);
  * the hub respawns a dead worker with exponential backoff, bumping its
    epoch: the ring is reset before the respawn, so no partial commit
    survives, and a completion of the dead epoch is never written into
    the new worker's slabs.

Two rules of the port.  The worker processes load neither torch nor jax
and never touch the card: a worker starts as a fresh interpreter running
`worker_main` (`_WorkerProcess`: the isolation of the spawn start method,
without its re-import of the parent's main module, which would load
torch), calls native.prebuilt_only() so it loads the router library the
engine built and never builds it, and imports only core/shm_ring.py,
native/, api/pb.py, api/grpc_api.py, api/types.py, qos/admission.py (its
sheds) and observability/tracing.py (traceparent parsing).  And the hub's
engine side loads without grpc: FrontdoorAbort and _EngineContext carry
integer status codes, and this module imports grpc only in the worker's
servicers and where a worker aborts an RPC.  server.py and everything that
reaches core/service.py are imported inside the hub, never at module top.

The worker's transport-free core (_Worker and its V1 servicer) also
serves frontdoor_replay.py, which drives a hub's rings from a recorded
RPC script without gRPC.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from gubernator_tpu_torch.core import shm_ring
from gubernator_tpu_torch.core.shm_ring import (
    FLAG_COLS_OK,
    FLAG_DRAINING,
    FLAG_SATURATED,
    KIND_APPLY_GREG,
    KIND_BATCH_COLS,
    KIND_COLS,
    KIND_PEER_RL,
    KIND_RAW,
    KIND_REGISTER,
    KIND_TRANSFER,
    KIND_UPDATE_GLOBALS,
    MAX_BATCH_RPCS,
    SHED_CODE_REASONS,
    SHED_REASON_CODES,
    FrontdoorStatus,
    WorkerChannel,
)
from gubernator_tpu_torch.qos.admission import (
    SHED_DRAINING,
    SHED_QUEUE_FULL,
    SHED_RING_FULL,
)

log = logging.getLogger("gubernator.frontdoor")

_PREFIX_SEQ = itertools.count()

# gRPC status codes (grpc.StatusCode values) the engine side completes with
_INTERNAL = 13
_UNIMPLEMENTED = 12
_INVALID_ARGUMENT = 3
_RESOURCE_EXHAUSTED = 8


_GET_RATE_LIMITS = "/pb.gubernator.V1/GetRateLimits"
# server.py's MAX_RECEIVE_BYTES (1 MB, the reference's), kept here: a
# worker must not import server.py, which loads the engine and torch
_MAX_RECEIVE_BYTES = 1024 * 1024
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FrontdoorAbort(Exception):
    """Engine-side analog of grpc context.abort(): carries the integer
    status code the worker must abort the client RPC with."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = int(code)
        self.message = message


class _EngineContext:
    """The slice of grpc.aio's ServicerContext the server.py serve_*
    bodies touch, backed by a shm record.  `integer_codes` tells server.py
    to abort with integer status codes (no grpc on the engine side)."""

    integer_codes = True

    def __init__(self, deadline: float = 0.0):
        self._deadline = deadline  # absolute time.monotonic(); 0 = none

    def time_remaining(self) -> Optional[float]:
        if not self._deadline:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def invocation_metadata(self):
        return ()

    async def abort(self, code, message: str = ""):
        raise FrontdoorAbort(getattr(code, "value", (code,))[0], message)


def _grpc_code(status: int):
    """grpc.StatusCode of an integer code (worker side only)."""
    import grpc
    for c in grpc.StatusCode:
        if c.value[0] == status:
            return c
    return grpc.StatusCode.INTERNAL


async def _abort_rpc(context, status: int, message: str) -> None:
    """Abort a worker's RPC with an integer status code.  A context that
    takes integer codes (frontdoor_replay.py's) gets the integer."""
    if getattr(context, "integer_codes", False):
        await context.abort(status, message)
    else:
        await context.abort(_grpc_code(status), message)


# =========================================================== worker process


class _Worker:
    """Per-process state of one frontdoor worker (runs in the worker
    process; never imports the engine, torch or grpc)."""

    def __init__(self, worker_id: int, chan: WorkerChannel,
                 status: FrontdoorStatus, fastpath_min: int,
                 encode_mode: str = "worker", batch_reads: int = 8):
        self.worker_id = worker_id
        self.chan = chan
        self.status = status
        self.fastpath_min = fastpath_min
        self.encode_mode = encode_mode
        # coalescing implies worker-side encode: a batch completion is
        # columnar (or per-RPC parts), never one engine-encoded buffer
        self.batch_reads = batch_reads if encode_mode == "worker" else 0
        from gubernator_tpu_torch import native
        self.native = native
        self.native_ok = native.available()
        self._req_id = 0
        self._waiters: Dict[int, asyncio.Future] = {}
        self._batches: Dict[int, tuple] = {}  # rid -> (futs, counts)
        self._pending: List[tuple] = []       # (data, fut, deadline, tp)
        self._ebuf: Optional[np.ndarray] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # worker-side microseconds spent in the C parse and encode (the
        # replay driver reports them)
        self.parse_s = 0.0
        self.encode_s = 0.0

    def _bump(self, field: int, n: int = 1) -> None:
        self.status.bump_w(self.worker_id, field, n)

    def traceparent(self, context) -> Optional[tuple]:
        """The RPC's sampled W3C traceparent as shm trace-region ints
        (trace_id_hi, trace_id_lo, span_id), or None when absent,
        malformed or unsampled."""
        md = getattr(context, "invocation_metadata", None)
        if not callable(md):
            return None
        raw = None
        for k, v in (md() or ()):
            if k == "traceparent":
                raw = v if isinstance(v, str) else \
                    bytes(v).decode("ascii", "replace")
                break
        if not raw:
            return None
        from gubernator_tpu_torch.observability.tracing import (
            parse_traceparent,
        )
        ctx = parse_traceparent(raw)
        if ctx is None:
            return None
        return (int(ctx.trace_id[:16], 16), int(ctx.trace_id[16:], 16),
                int(ctx.span_id, 16))

    # -------------------------------------------------------- response encode

    def encode_cols(self, st, li, re, rs, fl, off: int, n: int) -> bytes:
        """Serialize n decisions starting at column offset `off`: the
        native encoder first (byte-compatible with the engine's
        fastpath_encode_w), protobuf as the fallback."""
        t0 = time.perf_counter()
        try:
            if self.native_ok:
                need = n * 96 + 64
                if self._ebuf is None or self._ebuf.nbytes < need:
                    self._ebuf = np.empty(max(need, 1 << 16), np.uint8)
                m = self.native.frontdoor_encode_resp(
                    st[off:off + n], li[off:off + n], re[off:off + n],
                    rs[off:off + n], fl[off:off + n], n, self._ebuf)
                if m >= 0:
                    return bytes(self._ebuf[:m])
            from gubernator_tpu_torch.api import pb, types
            resps = []
            for i in range(off, off + n):
                code = int(fl[i])
                md = ({"shed": "true",
                       "shed_reason": SHED_CODE_REASONS[code]}
                      if code else {})
                resps.append(types.RateLimitResp(
                    status=int(st[i]), limit=int(li[i]),
                    remaining=int(re[i]), reset_time=int(rs[i]),
                    metadata=md))
            return pb.GetRateLimitsResp(responses=[
                pb.resp_to_pb(r) for r in resps]).SerializeToString()
        finally:
            self.encode_s += time.perf_counter() - t0

    def parse(self, data: bytes, slot: int, base: int = 0,
              koff: int = 0) -> int:
        """frontdoor_parse_req into the slab's columns from item `base`
        and key byte `koff` on (timed)."""
        t0 = time.perf_counter()
        kb, ke, hi, li, du, al, nl = self.chan.cols_views(slot)
        n = self.native.frontdoor_parse_req(
            data, kb[koff:], ke[base:], hi[base:], li[base:], du[base:],
            al[base:], nl[base:], self.chan.cap_items - base)
        self.parse_s += time.perf_counter() - t0
        return n

    # ------------------------------------------------------------- transport

    async def roundtrip(self, slot: int, req_id: int, context) -> bytes:
        """Submit a written slab and await its completion; abort the
        client RPC when the engine said to."""
        fut = self._loop.create_future()
        self._waiters[req_id] = fut
        self.chan.submit(slot)
        try:
            status, payload = await fut
        finally:
            self._waiters.pop(req_id, None)
        if status != 0:
            await _abort_rpc(context, status,
                             payload.decode("utf-8", "replace"))
        self._bump(shm_ring.W_RPCS)
        return payload

    async def poll_loop(self) -> None:
        """Completion pump: the only consumer of the completion ring.
        Columnar completions (length < 0) are encoded here, while the
        worker still owns the slab; the slot is freed only after its
        response has been materialized."""
        while True:
            comps = self.chan.poll_completions_raw()
            if comps:
                for slot, req_id, status, length in comps:
                    try:
                        self._deliver(slot, req_id, status, length)
                    finally:
                        self.chan.free_slot(slot)
                await asyncio.sleep(0)
            else:
                await asyncio.sleep(0.0005)

    def _deliver(self, slot: int, req_id: int, status: int,
                 length: int) -> None:
        batch = self._batches.pop(req_id, None)
        if batch is not None:
            self._deliver_batch(batch, slot, status, length)
            return
        fut = self._waiters.pop(req_id, None)
        if fut is None or fut.done():
            return
        if length < 0:  # decision columns: worker-side encode
            n = -length
            st, li, re, rs, fl = self.chan.resp_views(slot)
            payload = self.encode_cols(st, li, re, rs, fl, 0, n)
            self._bump(shm_ring.W_ENCODES)
            fut.set_result((0, payload))
        else:
            if status == 0:
                self._bump(shm_ring.W_ENC_FALLBACK)
            fut.set_result((status, bytes(self.chan.slab(slot)[:length])))

    def _deliver_batch(self, batch: tuple, slot: int, status: int,
                       length: int) -> None:
        futs, counts = batch
        if status != 0:  # an abort fans out to every coalesced RPC
            payload = bytes(self.chan.slab(slot)[:length])
            for f in futs:
                if not f.done():
                    f.set_result((status, payload))
            return
        if length < 0:  # concatenated decision columns, split by counts
            st, li, re, rs, fl = self.chan.resp_views(slot)
            off = 0
            for f, cnt in zip(futs, counts):
                payload = self.encode_cols(st, li, re, rs, fl, off, cnt)
                off += cnt
                self._bump(shm_ring.W_ENCODES)
                if not f.done():
                    f.set_result((0, payload))
        else:  # bytes-form fallback: per-RPC serialized parts
            lengths, view = self.chan.batch_payload(slot, len(futs), length)
            off = 0
            for f, ln in zip(futs, lengths):
                payload = bytes(view[off:off + ln])
                off += ln
                self._bump(shm_ring.W_ENC_FALLBACK)
                if not f.done():
                    f.set_result((0, payload))

    def flush_batch(self) -> None:
        """Coalesce this tick's pending GetRateLimits RPCs into ONE
        KIND_BATCH_COLS slab and ONE ring publish.  RPCs the C parser
        refuses (or that overflow the slab) resolve to None and rerun the
        single-record path in their handler."""
        pending = self._pending
        self._pending = []
        if not pending:
            return
        if len(pending) == 1:  # nothing to amortize
            if not pending[0][1].done():
                pending[0][1].set_result(None)
            return
        slot = self.chan.alloc()
        if slot is None:  # handlers shed ring_full on their own alloc
            for _, fut, _, _ in pending:
                if not fut.done():
                    fut.set_result(None)
            return
        ke = self.chan.cols_views(slot)[1]
        counts: List[int] = []
        futs: List[asyncio.Future] = []
        tps: List[Optional[tuple]] = []
        singles: List[asyncio.Future] = []
        base, koff = 0, 0
        dmin = 0.0
        for data, fut, deadline, tp in pending:
            n = -1
            if base < self.chan.cap_items and len(counts) < MAX_BATCH_RPCS:
                n = self.parse(data, slot, base, koff)
            if n <= 0:
                singles.append(fut)
                continue
            if koff:
                ke[base:base + n] += koff
            koff = int(ke[base + n - 1])
            base += n
            counts.append(n)
            futs.append(fut)
            tps.append(tp)
            if deadline and (dmin == 0.0 or deadline < dmin):
                dmin = deadline
        # ONE trace region a record: the first traced member's context
        # rides the slab; every other traced member is a counted drop
        carried = next((t for t in tps if t is not None), None)
        extra = sum(1 for t in tps if t is not None) - (1 if carried else 0)
        if extra > 0:
            self._bump(shm_ring.W_TRACE_DROPS, extra)
        if not counts:
            self.chan.unalloc(slot)
        else:
            rid = self.next_id()
            if carried is not None:
                self.chan.set_trace(slot, *carried)
            else:
                self.chan.clear_trace(slot)
            if len(counts) == 1:  # degenerate: a plain COLS record
                self.chan.commit_cols(slot, rid, counts[0], koff, dmin)
                self._waiters[rid] = futs[0]
            else:
                self.chan.commit_batch(slot, rid, counts, koff, dmin)
                self._batches[rid] = (futs, counts)
                self._bump(shm_ring.W_BATCH_FLUSHES)
                self._bump(shm_ring.W_BATCH_RPCS, len(counts))
            self.chan.submit(slot)
        for fut in singles:
            if not fut.done():
                fut.set_result(None)

    def next_id(self) -> int:
        self._req_id += 1
        return self._req_id

    def shed_bytes(self, data: bytes, reason: str) -> Optional[bytes]:
        """In-band worker-local shed: the items qos/admission.py's
        shed_response builds, encoded here, with no ring trip.  None for
        bytes that do not parse (the caller aborts INVALID_ARGUMENT)."""
        from gubernator_tpu_torch.api import pb
        from gubernator_tpu_torch.qos.admission import shed_response
        try:
            req = pb.GetRateLimitsReq.FromString(data)
        except Exception:
            return None
        self._bump(shm_ring.W_SHEDS, max(1, len(req.requests)))
        return pb.GetRateLimitsResp(responses=[
            pb.resp_to_pb(shed_response(pb.req_from_pb(r), reason))
            for r in req.requests
        ]).SerializeToString()


def _deadline_of(context) -> float:
    tr = getattr(context, "time_remaining", None)
    if callable(tr):
        rem = tr()
        if rem is not None:
            return time.monotonic() + rem
    return 0.0


class _WorkerV1:
    """pb.gubernator.V1 in a worker process."""

    def __init__(self, w: _Worker):
        self.w = w

    async def _shed(self, data: bytes, reason: str, context):
        out = self.w.shed_bytes(data, reason)
        if out is None:
            await _abort_rpc(context, _INVALID_ARGUMENT,
                             "malformed GetRateLimitsReq")
        return out

    async def GetRateLimits(self, data: bytes, context):
        w = self.w
        st = w.status
        reason = None
        slot = None
        use_batch = (w.batch_reads > 1 and w.native_ok
                     and st.flag(FLAG_COLS_OK))
        if st.flag(FLAG_DRAINING):
            reason = SHED_DRAINING
        elif st.flag(FLAG_SATURATED):
            reason = SHED_QUEUE_FULL
        elif not use_batch:  # batching defers alloc to the flush
            slot = w.chan.alloc()
            if slot is None:
                # every slab in flight: the producer-side stall signal
                w._bump(shm_ring.W_STALLS)
                reason = SHED_RING_FULL
        if reason is not None:
            return await self._shed(data, reason, context)
        deadline = _deadline_of(context)
        tp = w.traceparent(context)
        if use_batch:
            # batched wire reads: park this RPC for the tick's flush; RPCs
            # of any size coalesce into one slab and one publish.  None:
            # the parser refused it (or the batch filled); it reruns the
            # single-record path below
            fut = w._loop.create_future()
            w._pending.append((data, fut, deadline, tp))
            if len(w._pending) == 1:
                w._loop.call_soon(w.flush_batch)
            elif len(w._pending) >= min(w.batch_reads, MAX_BATCH_RPCS):
                w.flush_batch()
            res = await fut
            if res is not None:
                status, payload = res
                if status != 0:
                    await _abort_rpc(context, status,
                                     payload.decode("utf-8", "replace"))
                w._bump(shm_ring.W_RPCS)
                return payload
            slot = w.chan.alloc()
            if slot is None:
                w._bump(shm_ring.W_STALLS)
                return await self._shed(data, SHED_RING_FULL, context)
        rid = w.next_id()
        if (w.native_ok and st.flag(FLAG_COLS_OK)
                and len(data) >= w.fastpath_min):
            # the zero-copy lane: the C parse writes the request columns
            # straight into the slab.  A refusal (GLOBAL or CONCURRENCY
            # items, values outside the compact ranges, malformed bytes)
            # ships RAW, so the engine decides as the in-process path does
            n = w.parse(data, slot)
            if n > 0:
                if tp is not None:
                    w.chan.set_trace(slot, *tp)
                else:
                    w.chan.clear_trace(slot)
                ke = w.chan.cols_views(slot)[1]
                w.chan.commit_cols(slot, rid, n, int(ke[n - 1]), deadline)
                return await w.roundtrip(slot, rid, context)
        if tp is not None:
            # a RAW record carries the request bytes, not the trace region
            w._bump(shm_ring.W_TRACE_DROPS)
        if not w.chan.write_raw(slot, KIND_RAW, rid, data, deadline):
            w.chan.unalloc(slot)
            await _abort_rpc(context, _RESOURCE_EXHAUSTED,
                             "request exceeds shm slab")
        return await w.roundtrip(slot, rid, context)

    async def HealthCheck(self, request, context):
        # answered from the engine-heartbeated status block: a probe never
        # waits behind a saturated engine loop
        from gubernator_tpu_torch.api import pb
        w = self.w
        w._bump(shm_ring.W_HEALTHCHECKS)
        status, message, peer_count = w.status.health()
        if w.status.heartbeat_age() > 15.0:
            status, message = 1, "engine heartbeat stale"
        return pb.HealthCheckResp(
            status="healthy" if status == 0 else "unhealthy",
            message=message, peer_count=peer_count)


class _WorkerPeers:
    """pb.gubernator.PeersV1 in a worker process: every RPC ships RAW."""

    def __init__(self, w: _Worker):
        self.w = w

    async def _raw(self, kind: int, data: bytes, context) -> bytes:
        w = self.w
        slot = w.chan.alloc()
        if slot is None:
            w._bump(shm_ring.W_STALLS)
            await _abort_rpc(context, _RESOURCE_EXHAUSTED,
                             "frontdoor ring full")
        rid = w.next_id()
        if not w.chan.write_raw(slot, kind, rid, data,
                                _deadline_of(context)):
            w.chan.unalloc(slot)
            await _abort_rpc(context, _RESOURCE_EXHAUSTED,
                             "request exceeds shm slab")
        return await w.roundtrip(slot, rid, context)

    async def GetPeerRateLimits(self, data: bytes, context):
        return await self._raw(KIND_PEER_RL, data, context)

    async def TransferBuckets(self, data: bytes, context):
        return await self._raw(KIND_TRANSFER, data, context)

    async def UpdatePeerGlobals(self, request, context):
        from gubernator_tpu_torch.api import pb
        out = await self._raw(KIND_UPDATE_GLOBALS,
                              request.SerializeToString(), context)
        return pb.UpdatePeerGlobalsResp.FromString(out)


def attach_worker(worker_id: int, prefix: str, slots: int, slab_bytes: int,
                  fastpath_min: int, encode_mode: str = "worker",
                  batch_reads: int = 8) -> _Worker:
    """Attach to a hub's segments as worker `worker_id` (inside the
    worker's event loop)."""
    from gubernator_tpu_torch import native
    native.prebuilt_only()
    chan = WorkerChannel.attach(f"{prefix}_r{worker_id}", slots, slab_bytes)
    status = FrontdoorStatus.attach(f"{prefix}_st",
                                    workers=port_hint_workers(prefix))
    w = _Worker(worker_id, chan, status, fastpath_min,
                encode_mode=encode_mode, batch_reads=batch_reads)
    w._loop = asyncio.get_running_loop()
    return w


async def _worker_amain(worker_id: int, prefix: str, slots: int,
                        slab_bytes: int, listen_host: str, port_hint: int,
                        fastpath_min: int, encode_mode: str = "worker",
                        batch_reads: int = 8) -> None:
    import grpc

    from gubernator_tpu_torch.api.grpc_api import (
        add_peers_servicer,
        add_v1_servicer,
    )
    w = attach_worker(worker_id, prefix, slots, slab_bytes, fastpath_min,
                      encode_mode, batch_reads)
    status = w.status
    server = grpc.aio.server(options=[
        ("grpc.max_receive_message_length", _MAX_RECEIVE_BYTES),
        ("grpc.so_reuseport", 1),
    ])
    add_v1_servicer(server, _WorkerV1(w))
    add_peers_servicer(server, _WorkerPeers(w))

    if worker_id == 0:
        port = server.add_insecure_port(f"{listen_host}:{port_hint}")
    else:
        # wait for worker 0 to publish the shared port, then join it via
        # SO_REUSEPORT; a refused bind falls back to an ephemeral port
        p0 = 0
        for _ in range(300):
            p0 = status.get_w(0, shm_ring.W_PORT)
            if p0:
                break
            await asyncio.sleep(0.05)
        port = 0
        if p0:
            try:
                port = server.add_insecure_port(f"{listen_host}:{p0}")
            except RuntimeError:
                port = 0
        if port == 0:
            port = server.add_insecure_port(f"{listen_host}:0")
    if port == 0:
        log.error("frontdoor worker %d could not bind", worker_id)
        return
    await server.start()
    status.set_w(worker_id, shm_ring.W_PORT, port)

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    import signal as _signal
    for sig in (_signal.SIGINT, _signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            pass
    poller = asyncio.create_task(w.poll_loop())

    ppid = os.getppid()
    while not stop.is_set():
        try:
            await asyncio.wait_for(stop.wait(), timeout=1.0)
        except asyncio.TimeoutError:
            pass
        # orphan guard: the engine died without stopping us
        if os.getppid() != ppid or status.heartbeat_age() > 30.0:
            break
    poller.cancel()
    await server.stop(grace=0.25)
    w.chan.close()
    status.close()


def port_hint_workers(prefix: str) -> int:
    """The worker count, encoded in the segment prefix by the hub so the
    status block can be attached without an extra argument."""
    return int(prefix.rsplit("_w", 1)[1])


def worker_main(worker_id: int, prefix: str, slots: int, slab_bytes: int,
                listen_host: str, port_hint: int, fastpath_min: int,
                encode_mode: str = "worker", batch_reads: int = 8) -> None:
    """A gRPC worker process's entry point (started by _WorkerProcess)."""
    logging.basicConfig(level=logging.INFO)
    asyncio.run(_worker_amain(worker_id, prefix, slots, slab_bytes,
                              listen_host, port_hint, fastpath_min,
                              encode_mode, batch_reads))


class _WorkerProcess:
    """A worker started as a fresh interpreter running `entry(*args)`
    (entry: "module:function" of this package).  It inherits nothing of
    the engine process, its main module included, so it loads no torch;
    the package's root is put on its PYTHONPATH.  The subset of
    multiprocessing.Process the hub uses: pid, is_alive, terminate, kill,
    join."""

    def __init__(self, entry: str, args: tuple):
        mod, fn = entry.split(":")
        code = f"from {mod} import {fn}; {fn}(*{args!r})"
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH", "")) if p)
        self._p = subprocess.Popen([sys.executable, "-c", code], env=env,
                                   stdin=subprocess.DEVNULL)
        self.pid = self._p.pid

    def is_alive(self) -> bool:
        return self._p.poll() is None

    def terminate(self) -> None:
        if self.is_alive():
            self._p.terminate()

    def kill(self) -> None:
        if self.is_alive():
            self._p.kill()

    def join(self, timeout: Optional[float] = None) -> None:
        try:
            self._p.wait(timeout)
        except subprocess.TimeoutExpired:
            pass


# ============================================================ engine process


def columnify_resps(resps):
    """Pack a list of RateLimitResp into decision columns for a
    complete_cols completion (worker-side encode), or None when a
    response cannot be expressed as columns: an error string, or
    metadata other than exactly qos/admission.py's shed shape; the hub
    then serializes on the engine side (counted in encode_fallbacks)."""
    n = len(resps)
    st = np.empty(n, np.int64)
    li = np.empty(n, np.int64)
    re = np.empty(n, np.int64)
    rs = np.empty(n, np.int64)
    fl = np.zeros(n, np.int32)
    for i, r in enumerate(resps):
        if r.error:
            return None
        md = r.metadata
        if md:
            code = (SHED_REASON_CODES.get(md.get("shed_reason", ""))
                    if len(md) == 2 and md.get("shed") == "true" else None)
            if code is None:
                return None
            fl[i] = code
        st[i] = r.status
        li[i] = r.limit
        re[i] = r.remaining
        rs[i] = r.reset_time
    return st, li, re, rs, fl


class FrontdoorHub:
    """Engine-side owner of the front door: creates the shm segments,
    starts, watches and restarts the workers, consumes every submission
    ring on its own thread, and serves each record on the Instance's
    event loop through the same server.py serve_* bodies the in-process
    servicers run.

    `worker_entry` names the workers' entry point ("module:function",
    called with worker_main's arguments); frontdoor_replay.py passes its
    own to drive the rings without gRPC."""

    def __init__(self, instance, workers: int, ring_slots: int,
                 slab_bytes: int, listen_address: str,
                 encode: str = "worker", batch_reads: int = 8,
                 worker_entry: str = "gubernator_tpu_torch.frontdoor:"
                                     "worker_main",
                 worker_args: tuple = ()):
        self.instance = instance
        self.workers = workers
        self.ring_slots = ring_slots
        self.slab_bytes = slab_bytes
        self.encode = encode if encode in ("worker", "engine") else "worker"
        self.batch_reads = batch_reads
        self.worker_entry = worker_entry
        self.worker_args = tuple(worker_args)
        # responses that could NOT be columnified (error strings, other
        # metadata) and were serialized on the engine side
        self.encode_fallbacks = 0
        host, _, port = listen_address.rpartition(":")
        self._listen_host = host or "localhost"
        self._port_hint = int(port or 0)
        # pid + per-process sequence keeps segment names unique even when
        # several hubs coexist in one engine process (tests)
        self.prefix = f"gfd{os.getpid()}x{next(_PREFIX_SEQ)}_w{workers}"
        self.status: Optional[FrontdoorStatus] = None
        self.chans: List[WorkerChannel] = []
        self.procs: List[Optional[_WorkerProcess]] = []
        self.epochs: List[int] = []
        self.restarts = 0
        self.records_served = 0
        # records popped, by kind (the engine side's census)
        self.records_by_kind: Dict[int, int] = {}
        self.address = ""
        self.port = 0
        self._locks: List[threading.Lock] = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop_evt = threading.Event()
        self._consumer: Optional[threading.Thread] = None
        self._tasks: List[asyncio.Task] = []
        # engine-thread seconds by step (ring pop, completion write), read
        # by chip_smoke.py phase 14
        self.pop_s = 0.0
        self.complete_s = 0.0

    # ------------------------------------------------------------- lifecycle

    def _spawn(self, i: int) -> None:
        from gubernator_tpu_torch.server import FASTPATH_MIN_BYTES
        args = (i, self.prefix, self.ring_slots, self.slab_bytes,
                # after the first bind a respawn re-claims the SAME public
                # port (an ephemeral hint of 0 would move it)
                self._listen_host, self.port or self._port_hint,
                FASTPATH_MIN_BYTES, self.encode,
                self.batch_reads) + self.worker_args
        p = _WorkerProcess(self.worker_entry, args)
        self.procs[i] = p
        self.status.set_w(i, shm_ring.W_PID, p.pid)
        self.status.set_w(i, shm_ring.W_EPOCH, self.epochs[i])

    async def start(self) -> None:
        from gubernator_tpu_torch import native
        self._loop = asyncio.get_running_loop()
        # the engine builds the router library the workers load (they
        # never build it, so no two of them race a compile)
        native.available()
        self.status = FrontdoorStatus.create(f"{self.prefix}_st",
                                             self.workers)
        self.status.beat()
        self._refresh_flags()
        self.chans = [
            WorkerChannel.create(f"{self.prefix}_r{i}", self.ring_slots,
                                 self.slab_bytes)
            for i in range(self.workers)
        ]
        self._locks = [threading.Lock() for _ in range(self.workers)]
        self.procs = [None] * self.workers
        self.epochs = [0] * self.workers
        try:
            for i in range(self.workers):
                self._spawn(i)
            self._stop_evt = threading.Event()
            self._consumer = threading.Thread(target=self._consume_loop,
                                              name="frontdoor-consumer",
                                              daemon=True)
            self._consumer.start()
            self._tasks = [
                asyncio.create_task(self._status_loop()),
                asyncio.create_task(self._monitor_loop()),
            ]
            # the public address is worker 0's bound port (every worker
            # shares it under SO_REUSEPORT; stragglers publish their
            # fallback ports in the status block)
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                self.port = self.status.get_w(0, shm_ring.W_PORT)
                if self.port:
                    break
                await asyncio.sleep(0.05)
            if not self.port:
                raise RuntimeError("frontdoor worker 0 never bound its port")
        except BaseException:
            await self.stop()
            raise
        self.address = f"{self._listen_host}:{self.port}"

    def set_draining(self) -> None:
        if self.status is not None:
            self.status.set_flag(FLAG_DRAINING, True)

    async def stop(self) -> None:
        self.set_draining()
        for t in self._tasks:
            t.cancel()
        self._tasks = []
        for p in self.procs:
            if p is not None:
                p.terminate()
        joins = [p for p in self.procs if p is not None]
        if joins:
            def _join():
                for p in joins:
                    p.join(timeout=3.0)
                    if p.is_alive():
                        p.kill()
                        p.join(timeout=1.0)
            await self._loop.run_in_executor(None, _join)
        self.procs = []
        self._stop_evt.set()
        if self._consumer is not None:
            self._consumer.join(timeout=2.0)
            self._consumer = None
        # the hub owns every segment: a hard-killed worker's are unlinked
        # here too
        for ch in self.chans:
            ch.close()
        self.chans = []
        if self.status is not None:
            self.status.close()
            self.status = None

    # ----------------------------------------------------- engine-side loops

    def _refresh_flags(self) -> None:
        inst = self.instance
        st = self.status
        st.beat()
        saturated = (inst.qos is not None
                     and inst.qos.admission.saturated)
        st.set_flag(FLAG_SATURATED, bool(saturated))
        pl = getattr(inst.batcher, "pipeline", None)
        cols_ok = bool(
            pl is not None and pl.enabled and pl.rpc_enabled
            and inst.engine._compact_enabled
            and not pl._ring_peers and not inst.mesh_mode)
        st.set_flag(FLAG_COLS_OK, cols_ok)

    async def _status_loop(self) -> None:
        from gubernator_tpu_torch.core.service import HEALTHY
        while True:
            try:
                self._refresh_flags()
                h = await self.instance.health_check()
                self.status.set_health(0 if h.status == HEALTHY else 1,
                                       h.message, h.peer_count)
            except Exception:
                log.exception("frontdoor status refresh failed")
            await asyncio.sleep(0.2)

    async def _monitor_loop(self) -> None:
        backoff = [0.5] * self.workers
        next_ok = [0.0] * self.workers
        while True:
            await asyncio.sleep(0.5)
            for i, p in enumerate(self.procs):
                if p is None or p.is_alive():
                    backoff[i] = 0.5
                    continue
                now = time.monotonic()
                if now < next_ok[i]:
                    continue
                # exponential respawn backoff: a worker that dies at boot
                # (a bad port, a broken environment) must not spin
                next_ok[i] = now + backoff[i]
                backoff[i] = min(5.0, backoff[i] * 2)
                # crash-restart: a dead worker's in-flight records died
                # with its connections.  Bump the epoch so late
                # completions drop, and reset the rings BEFORE the respawn
                # so the new worker sees empty queues: no partial commit
                # survives the boundary
                log.warning("frontdoor worker %d (pid %s) died; restarting",
                            i, p.pid)
                self.restarts += 1
                self.epochs[i] += 1
                self.status.bump_w(i, shm_ring.W_RESTARTS)
                with self._locks[i]:
                    self.chans[i].reset()
                self._spawn(i)

    def _consume_loop(self) -> None:
        """Submission-ring consumer thread: pops records and hands each to
        the engine event loop.  The pop is lock-free against the worker;
        the per-channel lock serializes it against monitor resets."""
        while not self._stop_evt.is_set():
            got = False
            for i in range(self.workers):
                t0 = time.perf_counter()
                with self._locks[i]:
                    recs = self.chans[i].pop()
                    epoch = self.epochs[i]
                if recs:
                    self.pop_s += time.perf_counter() - t0
                for rec in recs:
                    got = True
                    self.records_by_kind[rec.kind] = (
                        self.records_by_kind.get(rec.kind, 0) + 1)
                    asyncio.run_coroutine_threadsafe(
                        self._serve(i, epoch, rec), self._loop)
            if not got:
                time.sleep(0.0005)

    # -------------------------------------------------------------- serving

    async def _serve(self, wid: int, epoch: int, rec) -> None:
        try:
            payload = await self._dispatch(rec)
            status = 0
        except FrontdoorAbort as e:
            status = e.code
            payload = e.message.encode()
        except Exception as e:  # an engine fault: INTERNAL to the caller
            log.exception("frontdoor record failed (kind %d)", rec.kind)
            status = _INTERNAL
            payload = str(e).encode()
        self.records_served += 1
        # epoch guard: after a crash-restart the slot belongs to the NEW
        # worker's free pool; a stale completion (bytes or columns) must
        # not touch it
        if self.epochs[wid] != epoch or not self.chans:
            return
        t0 = time.perf_counter()
        ch = self.chans[wid]
        if status == 0 and isinstance(payload, tuple):
            if payload[0] == "cols":  # worker-side encode
                st, li, re, rs, fl = payload[1]
                ch.complete_cols(rec.slot, rec.req_id, st, li, re, rs, fl)
            else:  # "bparts": per-RPC serialized parts of a batch
                ch.complete_batch_bytes(rec.slot, rec.req_id, payload[1])
        else:
            ch.complete(rec.slot, rec.req_id, status, payload)
        self.complete_s += time.perf_counter() - t0

    async def _dispatch(self, rec):
        from gubernator_tpu_torch import server as srv
        inst = self.instance
        ctx = _EngineContext(rec.deadline)
        if rec.kind == KIND_COLS:
            return await self._serve_cols(rec, ctx)
        if rec.kind == KIND_BATCH_COLS:
            return await self._serve_batch(rec, ctx)
        if rec.kind == KIND_RAW:
            # one response path: the protobuf path's responses ship as
            # columns like the COLS lane's (worker-encode mode)
            kind, val = await srv.serve_get_rate_limits_inner(
                inst, rec.payload, ctx)
            if kind == "bytes":
                return val
            return self._finish_resps(val)
        if rec.kind == KIND_PEER_RL:
            return await srv.serve_peer_rate_limits(inst, rec.payload, ctx)
        if rec.kind == KIND_TRANSFER:
            return await srv.serve_transfer_buckets(inst, rec.payload, ctx)
        if rec.kind == KIND_UPDATE_GLOBALS:
            from gubernator_tpu_torch.api import pb
            req = pb.UpdatePeerGlobalsReq.FromString(rec.payload)
            out = await srv.serve_update_peer_globals(inst, req, ctx)
            return out.SerializeToString()
        if rec.kind in (KIND_REGISTER, KIND_APPLY_GREG):
            raise FrontdoorAbort(_UNIMPLEMENTED,
                                 "mesh GLOBAL registration is not served")
        raise FrontdoorAbort(_UNIMPLEMENTED,
                             f"unknown frontdoor record kind {rec.kind}")

    def _traced(self, rec):
        """The `rpc` root of a COLS record that carried the caller's
        traceparent (the worker stamps the shm trace region), as the
        in-process servicer roots one; None when the record carried none
        or tracing is off."""
        tr = getattr(self.instance, "tracer", None)
        if rec.trace is None or tr is None or not tr.enabled:
            return None
        hi, lo, span = rec.trace
        return tr.start_trace("rpc", f"00-{hi:016x}{lo:016x}-{span:016x}-01")

    async def _submit_cols(self, rec, want_cols: bool):
        """The record's columns through the pipeline (ColsJob): bytes,
        decision columns, the response list of an engine.process
        fallback, or None for the protobuf path."""
        qos = self.instance.qos
        if qos is not None and qos.admission.saturated:
            return None
        submit = self.instance.batcher.submit_cols(
            rec.cols, rec.name_lens, rec.n, want_cols=want_cols)
        root = self._traced(rec)
        if root is None:
            return await submit
        with root:
            return await submit

    async def _serve_cols(self, rec, ctx: _EngineContext):
        """Worker-parsed columns: serve_get_rate_limits with the C parse
        done.  The columns passed frontdoor_parse_req's acceptance rules,
        so the pipeline takes them; the protobuf path below runs only on
        saturation or a closed gate, on requests rebuilt from the
        columns."""
        from gubernator_tpu_torch.server import _observe
        inst = self.instance
        start = time.monotonic()
        want_cols = self.encode == "worker"
        out = await self._submit_cols(rec, want_cols)
        if out is None:
            out = await self._py_fallback(rec, ctx, start)
        else:
            _observe(inst, _GET_RATE_LIMITS, start, True)
        if isinstance(out, list):
            return self._finish_resps(out)
        if want_cols:  # (status, limit, remaining, reset) arrays
            return ("cols", (*out, None))
        return out

    async def _py_fallback(self, rec, ctx: _EngineContext, start):
        """Rebuild the record's requests from its columns and run the
        Instance's full path (shared by COLS and BATCH fallbacks)."""
        from gubernator_tpu_torch.core.pipeline import requests_from_cols
        from gubernator_tpu_torch.core.service import BatchTooLargeError
        from gubernator_tpu_torch.server import _observe
        inst = self.instance
        reqs = requests_from_cols(rec.cols, rec.name_lens, rec.n)
        deadline = None
        if inst.qos is not None:
            deadline = inst.qos.deadline_from_timeout(ctx.time_remaining())
        try:
            resps = await inst.get_rate_limits(reqs, deadline=deadline)
        except BatchTooLargeError as e:
            _observe(inst, _GET_RATE_LIMITS, start, False)
            raise FrontdoorAbort(11, str(e))  # OUT_OF_RANGE
        _observe(inst, _GET_RATE_LIMITS, start, True)
        return resps

    async def _serve_batch(self, rec, ctx: _EngineContext):
        """A KIND_BATCH_COLS record: several coalesced RPCs' columns as
        ONE pipeline job, completed as ONE columnar entry the worker
        splits back per RPC by the counts region (or per-RPC bytes parts
        when a response cannot be columns)."""
        from gubernator_tpu_torch.server import _observe
        inst = self.instance
        start = time.monotonic()
        out = await self._submit_cols(rec, True)
        if out is not None and not isinstance(out, list):
            for _ in rec.counts:
                _observe(inst, _GET_RATE_LIMITS, start, True)
            return ("cols", (*out, None))
        resps = out if out is not None else await self._py_fallback(
            rec, ctx, start)
        cols = columnify_resps(resps)
        if cols is not None:
            return ("cols", cols)
        from gubernator_tpu_torch.api import pb
        parts = []
        off = 0
        for cnt in rec.counts:
            parts.append(pb.GetRateLimitsResp(responses=[
                pb.resp_to_pb(r) for r in resps[off:off + cnt]
            ]).SerializeToString())
            off += cnt
        self.encode_fallbacks += 1
        return ("bparts", parts)

    def _finish_resps(self, resps):
        """The response tail of every GetRateLimits fallback: columns for
        the worker to encode, or (engine mode, or responses columns cannot
        express) bytes serialized here and counted."""
        if self.encode == "worker":
            cols = columnify_resps(resps)
            if cols is not None:
                return ("cols", cols)
            self.encode_fallbacks += 1
        from gubernator_tpu_torch.api import pb
        return pb.GetRateLimitsResp(
            responses=[pb.resp_to_pb(r) for r in resps]).SerializeToString()

    # -------------------------------------------------------- observability

    _STAT_FIELDS = (("rpcs", shm_ring.W_RPCS), ("sheds", shm_ring.W_SHEDS),
                    ("healthchecks", shm_ring.W_HEALTHCHECKS),
                    ("stalls", shm_ring.W_STALLS),
                    ("encodes", shm_ring.W_ENCODES),
                    ("enc_fallbacks", shm_ring.W_ENC_FALLBACK),
                    ("batch_rpcs", shm_ring.W_BATCH_RPCS),
                    ("batch_flushes", shm_ring.W_BATCH_FLUSHES),
                    ("trace_drops", shm_ring.W_TRACE_DROPS))

    def stats(self) -> dict:
        """Aggregates for the metrics scrape hook (watch_frontdoor)."""
        s = {"workers": self.workers, "restarts": self.restarts,
             "depth": 0, "inflight": 0,
             "engine_encode_fallbacks": self.encode_fallbacks}
        for name, _ in self._STAT_FIELDS:
            s[name] = 0
        if self.status is None:
            return s
        for i in range(self.workers):
            for name, field in self._STAT_FIELDS:
                s[name] += self.status.get_w(i, field)
        for ch in self.chans:
            s["depth"] += ch.sub_depth()
            s["inflight"] += ch.inflight()
        return s

    def debug_snapshot(self) -> dict:
        st = self.status
        ports = ([st.get_w(i, shm_ring.W_PORT) for i in range(self.workers)]
                 if st else [])
        rows = []
        for i in range(self.workers if st else 0):
            row = {"pid": st.get_w(i, shm_ring.W_PID), "port": ports[i],
                   "epoch": self.epochs[i],
                   "restarts": st.get_w(i, shm_ring.W_RESTARTS)}
            for name, field in self._STAT_FIELDS:
                row[name] = st.get_w(i, field)
            row["ring_depth"] = self.chans[i].sub_depth() if self.chans else 0
            row["inflight"] = self.chans[i].inflight() if self.chans else 0
            rows.append(row)
        return {
            "workers": self.workers,
            "address": self.address,
            "port_mode": ("reuseport"
                          if len(set(p for p in ports if p)) <= 1
                          else "per-worker-ports"),
            "ring_slots": self.ring_slots,
            "slab_bytes": self.slab_bytes,
            "restarts": self.restarts,
            "records_served": self.records_served,
            "encode_mode": self.encode,
            "batch_reads": self.batch_reads,
            "engine_encode_fallbacks": self.encode_fallbacks,
            "per_worker": rows,
        }
