"""Pipelined serving drain: pending requests -> stacked compact windows ->
one launch of the drain kernel -> an asynchronous fetch -> decode.

The single-node form of `gubernator_tpu/core/pipeline.py` DispatchPipeline
on PyTorch.  Every pending request list is packed by the native router
(gubernator_tpu_torch/native) into ONE stack of K compact windows in a
host arena, filling windows to the lane cap across job boundaries (the
router spills a shard's lanes to later windows with monotonic cursors,
which keeps each key's requests in order through the drain).  The stack
crosses to the device in one non-blocking copy from pinned memory and runs
as one launch of the window-drain kernel (`engine.pipeline_dispatch`:
drain_compact); with traffic analytics on, the drain is the stats drain
plus the finisher (`engine.pipeline_dispatch_global` with
`analytics_args` and no GLOBAL lanes: drain_compact_stats, stats_finish),
each drain's tenant lanes staged beforehand, and TrafficAnalytics ingests
every drain's stats.  Right after the launch the engine thread queues
non-blocking copies of the response words and mismatch flags (and the
stats) into the arena's pinned buffers and records an event behind them;
a fetch worker waits for that event and decodes, while the engine thread
already packs and launches the next drain.  The stored-limit plane crosses
only when a mismatch flag fired.

Stages run overlapped up to GUBER_PIPELINE_DEPTH drains (default 3): the
engine thread packs drain N+1 while the device runs N and a fetch worker
decodes N-1.  Results commit through ONE ordered completion queue on the
event loop, and all device work and router calls stay on the single
`guber-device` engine thread, so answers are bit-identical to a serial
(depth 1) pipeline whatever order the fetches finish in.  An arena goes
back to its ring only after its drain's event has passed (the device has
read the stack and written the responses); a drain whose dispatch fails
aborts the router's staging, commits nothing and fails only its own jobs.

With a drain in flight, the occupancy gate (GUBER_PIPELINE_GATE, _FRAC)
holds the next dispatch until about gate_frac x S x B lanes are pending
(the queued decisions over the live fold factor); an outstanding
completion always re-pumps and the gate is off at zero in flight, so it
never strands work.  A load with fewer decisions outstanding than that
(fewer clients than S x B / their RPC size) therefore runs one drain at a
time; `gate_holds` and the snapshot's `mean_inflight` show it.  When
nothing is in flight, a small queue waits up to `coalesce_wait` (the
batcher's batch_wait, the reference's 500 us) for more arrivals.
GUBER_FETCH_STRIDE > 1 chains dispatched drains and completes them with
one fetch task; with QoS, GUBER_FETCH_STRIDE_MAX caps how far the
congestion controller's stride may grow it.

With a QoS manager (qos/), each drain's singles are interleaved across
tenants (fair slotting, stable within a tenant) and cut to the congestion
window, the in-flight depth follows that window (effective_depth), the
admission controller sees every in-flight change (note_inflight), and
every completed drain feeds the controller its wall time and stage
times.  The singles the cut defers go first in the next drain, and a job
(submit_many, submit_rpc) submitted after the first of them waits with
them, so it cannot overtake a deferred single on its key (a departure:
the JAX pipeline stages such a job in the same drain, ahead of it;
tests/test_torch_pipeline.py pins both).

Requests outside the compact ranges, GLOBAL requests and every other
algorithm than token and leaky take the batcher's legacy lane
(engine.process on the router).

The raw-RPC lane (`submit_rpc`, RpcJob) serves a whole serialized
GetRateLimitsReq (or GetPeerRateLimitsReq, the same wire shape) with no
Python object per item: the router's C parser stages its items straight
into the drain's stack (fastpath_parse_stack), and the fetch thread
encodes the response bytes from the fetched words in C
(fastpath_encode_w), into a per-fetch-thread buffer.  An RPC the parser
refuses (malformed, GLOBAL, CONCURRENCY, an empty name or key, a value
outside the compact ranges, more than 1000 items, or one that cannot fit
even an empty stack) resolves to None, and the caller answers it through
the protobuf path after the drain.

In a cluster (`install_ring`, JAX pipeline.py:740-760, from the
Instance's set_peers) the parser classifies each item against the
consistent-hash ring: items another peer owns are not staged.  The drain
copies their serialized RateLimitReq frames out of the RPC, and once it
is dispatched `_spawn_forwards` sends them, one spliced
GetPeerRateLimitsReq per owner per drain (chunks of 1000), through that
owner's PeerClient.get_peer_rate_limits_raw, while the local stack's fetch
is in flight; `_assemble_mixed` then splices the owners' framed responses
(metadata['owner'] appended) positionally with the local items' framed
segments (fastpath_encode_parts) into the RPC's response.  A drain whose
every item is forwarded launches nothing.  Forwarded items are the
owner's decisions: they do not count in this node's decisions.  The lane
is gated by `rpc_enabled`, which set_peers closes across the swap of the
ring and the drain re-reads on the engine thread, so an RPC that races a
membership change takes the protobuf path instead of deciding keys this
node no longer owns.  Not ported here: lockstep (mesh) serving.

The front door's column lane (`submit_cols`, ColsJob; frontdoor.py):
request columns a worker process parsed with frontdoor_parse_req into its
shared-memory slab are staged with pack_stack_fast straight from those
views, as a ListJob's columns are, and finish to engine-encoded bytes or,
with want_cols, to four int64 decision columns (status, limit, remaining,
reset) that the worker encodes.  A ColsJob follows the port's order rules
below, not the JAX pipeline's: a leftover goes first in the next drain
(its slab stays valid until its completion), and one no stack takes runs
through engine.process in its turn and resolves to the response list.
The lane is standalone only: with ring peers installed submit_cols
returns None.

Two other departures from the JAX pipeline keep each key's requests in
submission order, which the JAX pipeline loses once one drain's jobs
overflow the stack (tests/test_torch_pipeline.py pins both): the jobs a
full stack leaves over stay on the engine thread and go first in its next
drain (the JAX pipeline requeues them behind singles taken meanwhile), and
a job no stack can take runs through engine.process on the engine thread
in its turn, with the jobs after it waiting for the next drain (the JAX
pipeline hands it to the legacy lane, whose process call can run after
later drains).  The order holds for every job the pipeline decides.  An
RPC the parser refuses leaves it instead, as in the JAX pipeline: it
resolves to None at its drain's dispatch, and the caller's protobuf path
submits its items again behind everything submitted meanwhile, RPCs
staged later in the same drain included, so a key it shares with such an
RPC is decided after it (tests/test_torch_rpc_lane.py pins this).  Only
concurrent RPCs can meet so, and the reference orders those no more.

Observability (JAX pipeline.py:1424-1540, :1605-1622).  Each job carries
the sampled trace context it was submitted under and its enqueue stamp
(a single's, a submit_many batch's, a raw RPC's, and a front-door column
record's whose worker carried a traceparent: the hub's `rpc` root), and
submit records the `enqueue` span.  A drain stamps its boundaries on one
monotonic clock: started, pack_done, dispatch_done, fetch_start and
fetch_done (and a chain's shared fetch window).  At commit, every context
the drain carried gets the `admission_wait` (enqueue -> started),
`window_fill` (started -> pack_done), `device_dispatch` (pack_done ->
dispatch_done) and `drain_commit` (the fetch thread's wait for the
drain's event and the decode, as the JAX stage covers its blocking fetch
and the decode; a chained drain's decode alone) spans, and `chain_fetch`
(the chain's one shared wait) when the drain committed through a chain; the metrics' stage
histograms observe the same intervals once per drain (chain_fetch once per
chain), so the stage sums reconcile with an RPC's end-to-end span at any
stride.  The window, occupancy, depth, overlap, arena and chain metrics
move with them.  The window clock (observability/devprof.py WindowClock)
observes each drain's dispatch_done -> fetch_done under its arm
(`composed_drain`, or `composed_analytics` with analytics), with the
trace IDs of its requests taken only for a slow window.  An armed
ProfileCapture (observability/introspect.py) wraps the engine thread's
drains (`_drain_sync`) in its capture.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    RateLimitResp,
    millisecond_now,
)
from gubernator_tpu_torch.config import (
    CHAIN_LINGER_MS_DEFAULT,
    FETCH_STRIDE_DEFAULT,
    FETCH_STRIDE_MAX_DEFAULT,
    MAX_BATCH_SIZE,
    env_bool,
    env_float,
    env_int,
)
from gubernator_tpu_torch.core.engine import PIPELINE_K_BUCKETS
from gubernator_tpu_torch.core.window_buffers import (
    RequestColumns,
    WindowArenaRing,
)
from gubernator_tpu_torch.net.faults import FAULTS, SEAM_ENGINE_DISPATCH
from gubernator_tpu_torch.observability.devprof import (
    ARM_ANALYTICS,
    ARM_DRAIN,
    WindowClock,
)
from gubernator_tpu_torch.observability.tracing import current_context
from gubernator_tpu_torch.ops import kernel
from gubernator_tpu_torch.ops.analytics import _SLOT_MASK
from gubernator_tpu_torch.qos.fairness import interleave_by_tenant, tenant_of

log = logging.getLogger("gubernator.pipeline")


class ListJob:
    """Already-parsed requests (batcher singles, submit_many batches)
    packed columnar through the stack.  Resolves each request's future
    (singles) or one future with the response list (batch)."""

    __slots__ = ("reqs", "futs", "fut", "row", "lane", "pos", "n", "_cols",
                 "after", "ctxs", "enq")

    def __init__(self, reqs: Sequence[RateLimitReq],
                 futs: Optional[List[asyncio.Future]] = None,
                 fut: Optional[asyncio.Future] = None,
                 ctxs: Optional[List] = None, enq: float = 0.0):
        self.reqs = list(reqs)
        self.futs = futs
        self.fut = fut
        # the sampled trace contexts riding the job (a singles chunk's,
        # aligned with reqs; a batch's one) and its oldest enqueue stamp
        self.ctxs = ctxs
        self.enq = enq
        self.n = len(self.reqs)
        self.row = None
        self.lane = None
        self.pos = None
        self._cols = None
        # singles submitted before this job (DispatchPipeline._take_jobs)
        self.after = 0

    def columns(self):
        if self._cols is None:
            keys = [r.hash_key().encode("utf-8") for r in self.reqs]
            self._cols = (
                np.frombuffer(b"".join(keys), dtype=np.uint8),
                np.cumsum([len(k) for k in keys]).astype(np.int64),
                np.asarray([r.hits for r in self.reqs], np.int64),
                np.asarray([r.limit for r in self.reqs], np.int64),
                np.asarray([r.duration for r in self.reqs], np.int64),
                np.asarray([r.algorithm for r in self.reqs], np.int32),
            )
        return self._cols

    def finish(self, wflat, clflat, now) -> List[RateLimitResp]:
        """Decode the job's items from the fetched words [K * S, B] (row k
        * S + shard); clflat is the stored-limit plane, given only when a
        mismatch flag fired."""
        status, remaining, reset = (
            a.tolist() for a in _decode_words(
                wflat[self.row, self.lane], self.pos, now))
        if clflat is not None:
            limits = clflat[self.row, self.lane].tolist()
        else:
            limits = self.columns()[3].tolist()
        return [
            RateLimitResp(status=status[i], limit=limits[i],
                          remaining=remaining[i], reset_time=reset[i])
            for i in range(self.n)
        ]


def _decode_words(w, pos, now):
    """(status, remaining, reset) of each item from its fetched word w.
    Aggregated items (pos >= 0, host_router.cc decode_word_item): the word
    carries the run's r_start; each item's answer follows from its 0-based
    position in the run (bits 0-29) and the algorithm (bit 30: leaky
    answers reset 0 while under).  Plain items (pos == -1) decode the word
    directly."""
    enc = (w >> 32) & 0xFFFFFFFF
    synth = pos >= 0
    p = np.where(synth, pos & 0x3FFFFFFF, 0)
    algo1 = (pos >> 30) & 1
    r_start = w & 0x7FFFFFFF
    under = p < r_start
    remaining = np.where(
        synth, np.where(under, r_start - p - 1, 0), w & 0x7FFFFFFF)
    status = np.where(synth, np.where(under, 0, 1), (w >> 31) & 1)
    reset = np.where(synth & (algo1 == 1) & under, 0,
                     np.where(enc == 0, 0, now + enc - 1))
    return status, remaining, reset


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _frame(body: bytes) -> bytes:
    """One repeated-field-1 entry (the same framing in GetRateLimitsResp
    and GetPeerRateLimitsResp)."""
    return b"\x0a" + _varint(len(body)) + body


def _read_varint(data: bytes, i: int) -> tuple:
    v = shift = 0
    while True:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v, i
        shift += 7


def _walk_frames(data: bytes) -> List[bytes]:
    """Split a serialized response into its field-1 entry FRAMES (tag +
    length + body), in order; skips other fields."""
    frames = []
    i, n = 0, len(data)
    while i < n:
        start = i
        tag, i = _read_varint(data, i)
        wt = tag & 7
        if wt == 2:
            ln, i = _read_varint(data, i)
            end = i + ln
            if tag >> 3 == 1:
                frames.append(data[start:end])
            i = end
        elif wt == 0:
            _, i = _read_varint(data, i)
        else:
            raise ValueError("unsupported wire type in peer response")
    return frames


# the coordinator annotation the per-item path puts on forwarded responses
# (gubernator.go:151): RateLimitResp.metadata is map<string,string> field
# 6; one entry is a {key=1, value=2} submessage
_META_OWNER_KEY = b"\x0a\x05owner"


def _append_owner(frame: bytes, host: str) -> bytes:
    """Annotate a framed RateLimitResp with metadata['owner'] by appending
    the map entry to its body (protobuf fields concatenate)."""
    ln, i = _read_varint(frame, 1)  # after the tag byte 0x0a
    h = host.encode("utf-8")
    entry = _META_OWNER_KEY + b"\x12" + _varint(len(h)) + h
    return _frame(frame[i:i + ln] + b"\x32" + _varint(len(entry)) + entry)


def _error_frame(message: str) -> bytes:
    """A framed RateLimitResp carrying only `error` (field 5)."""
    m = message.encode("utf-8")
    return _frame(b"\x2a" + _varint(len(m)) + m)


class RpcJob:
    """A whole serialized GetRateLimitsReq served natively: C parse ->
    stacked lanes -> C proto encode.  Resolves to the response BYTES, or
    None when the RPC needs the protobuf path.  peer_mode marks the
    authoritative peer-plane lane (GetPeerRateLimits): the parser ignores
    any ring and takes every item as local.  In a cluster, `remote` holds
    the items the ring gives other peers, as (item index, ring peer
    index, framed RateLimitReq bytes), and `forward_task` resolves to
    their framed responses by item index (_spawn_forwards)."""

    __slots__ = ("data", "fut", "futs", "n", "row", "lane", "pos", "limit",
                 "peer_mode", "after", "remote", "forward_task", "ctx",
                 "enq")

    def __init__(self, data: bytes, fut: asyncio.Future,
                 peer_mode: bool = False):
        self.data = data
        self.fut = fut
        self.futs = None
        self.peer_mode = peer_mode
        # the sampled trace context the RPC rode in on, and its enqueue
        # stamp
        self.ctx = None
        self.enq = 0.0
        self.n = 0
        self.row = None
        self.lane = None
        self.pos = None
        self.limit = None
        self.after = 0
        self.remote = ()
        self.forward_task = None

    def finish(self, pipeline, wflat, clflat, now):
        # the encode target is a per-fetch-thread scratch buffer: bytes()
        # copies out before this thread touches another job
        resp_buf = pipeline._resp_buf(self.n * 64 + 64)
        native = pipeline.engine.native
        if not self.remote:
            m = native.fastpath_encode_w(
                wflat, self.limit, now, wflat.shape[-1], self.n,
                self.row, self.lane, self.pos, resp_buf, climit=clflat)
            return bytes(resp_buf[:m])
        # mixed RPC: the local items as framed per-item segments (a
        # forwarded item's length is 0); _assemble_mixed splices the rest
        item_off = np.empty(self.n, np.int64)
        item_len = np.empty(self.n, np.int32)
        m = native.fastpath_encode_parts(
            wflat, self.limit, now, wflat.shape[-1], self.n,
            self.row, self.lane, self.pos, resp_buf, item_off, item_len,
            climit=clflat)
        return bytes(resp_buf[:m]), item_off, item_len


def requests_from_cols(cols: tuple, name_lens, n: int) -> List[RateLimitReq]:
    """The requests of frontdoor_parse_req's columns, rebuilt: each hash
    key is name + "_" + unique key, split at the name's length."""
    kb, ke, hits, limits, durations, algos = cols
    keys = bytes(kb)
    out = []
    prev = 0
    for j in range(n):
        end = int(ke[j])
        nl = int(name_lens[j])
        k = keys[prev:end]
        out.append(RateLimitReq(
            name=k[:nl].decode("utf-8", "replace"),
            unique_key=k[nl + 1:].decode("utf-8", "replace"),
            hits=int(hits[j]), limit=int(limits[j]),
            duration=int(durations[j]), algorithm=int(algos[j])))
        prev = end
    return out


class ColsJob:
    """Request columns a front-door worker parsed into its shared-memory
    slab (JAX pipeline.py ColsJob): (key_bytes, key_ends, hits, limits,
    durations, algos) zero-copy views, plus the name lengths that split
    each hash key back into name and unique key.  Staged like a ListJob
    (pack_stack_fast over the columns), finished like an RpcJob: to
    response bytes encoded in C, or with want_cols to the decision columns
    (status, limit, remaining, reset int64 arrays) for a complete_cols
    completion.  The parse applied the RpcJob parser's acceptance rules,
    so the router takes every item; a job no stack takes runs through
    engine.process (`reqs` rebuilds its requests) and resolves to the
    response list.

    No _cols slot on purpose: a leftover keeps reading the slab, which
    stays valid until the hub completes the record."""

    __slots__ = ("cols", "name_lens", "fut", "futs", "n", "row", "lane",
                 "pos", "want_cols", "after", "ctxs", "enq")

    def __init__(self, cols: tuple, name_lens, n: int, fut: asyncio.Future,
                 want_cols: bool = False):
        self.cols = cols
        self.name_lens = name_lens
        self.fut = fut
        self.futs = None
        # the record's trace context (the hub's `rpc` root), if it carried
        # a traceparent, and its enqueue stamp
        self.ctxs = None
        self.enq = 0.0
        self.n = n
        self.row = None
        self.lane = None
        self.pos = None
        self.want_cols = want_cols
        self.after = 0

    def columns(self):
        return self.cols

    @property
    def reqs(self) -> List[RateLimitReq]:
        return requests_from_cols(self.cols, self.name_lens, self.n)

    def finish(self, pipeline, wflat, clflat, now):
        if not self.want_cols:
            resp_buf = pipeline._resp_buf(self.n * 64 + 64)
            m = pipeline.engine.native.fastpath_encode_w(
                wflat, self.cols[3], now, wflat.shape[-1], self.n,
                self.row, self.lane, self.pos, resp_buf, climit=clflat)
            return bytes(resp_buf[:m])
        status, remaining, reset = _decode_words(
            wflat[self.row, self.lane], self.pos, now)
        if clflat is not None:
            limits = clflat[self.row, self.lane].astype(np.int64)
        else:
            # a copy: cols[3] views the slab that complete_cols overwrites
            # with these very columns
            limits = self.cols[3][:self.n].astype(np.int64)
        return (status.astype(np.int64), limits,
                remaining.astype(np.int64), reset.astype(np.int64))


def _job_contexts(jobs):
    """The sampled trace contexts the jobs carry (an RpcJob's `ctx`, a
    ListJob's or ColsJob's `ctxs`)."""
    for job in jobs:
        c = getattr(job, "ctx", None)
        if c is not None:
            yield c
        for c in (getattr(job, "ctxs", None) or ()):
            if c is not None:
                yield c


def _pending_items(job) -> int:
    """A queued job's decisions; an RpcJob is unparsed until its drain,
    so its items are estimated from the wire size (at least ~16 bytes an
    item, so this overestimates, as in the JAX pipeline)."""
    return len(job.data) // 16 if isinstance(job, RpcJob) else job.n


class _DrainResult:
    __slots__ = ("words", "limits", "event", "stats", "stats_host",
                 "an_decay", "staged", "fallback", "leftover", "now",
                 "n_decisions", "error", "started", "pack_done",
                 "dispatch_done", "fetch_start", "fetch_done", "arena",
                 "cols_owner", "cfut", "deferred", "carried", "k_used",
                 "ring_peers", "n_lanes", "oldest_enq", "arm",
                 "wait_start", "chain_fetch_start", "chain_fetch_done")

    def __init__(self):
        # the drain's response words and stored limits on the device, the
        # event recorded behind the copies of words and mismatch flags
        # into the arena, and the arena's stats buffer with the analytics
        # stats' host copy
        self.words = None
        self.limits = None
        self.event = None
        self.stats = None
        self.stats_host = None
        self.an_decay = 0
        # staging ownership: the drain's arena (back to the ring only on
        # clean completion), the RequestColumns its singles sliced from,
        # and the fetch future submitted from the engine thread
        self.arena = None
        self.cols_owner = None
        self.cfut = None
        # a deferred-fetch chain member: dispatched, no fetch submitted
        self.deferred = False
        # did this drain take the previous drain's leftover jobs?
        self.carried = False
        self.staged = []
        self.fallback = []
        self.leftover = []
        self.k_used = 0
        # the PeerClients of the ring the drain's parse classified against
        self.ring_peers = ()
        self.now = 0
        self.n_decisions = 0
        self.error = None
        self.n_lanes = 0
        # stage boundaries (monotonic; 0.0 = never reached): window_fill =
        # started -> pack_done, device_dispatch = pack_done ->
        # dispatch_done, drain_commit = wait_start (the fetch thread's
        # wait for the drain's event, unchained drains) or fetch_start ->
        # fetch_done, admission_wait = oldest_enq -> started.  The stage
        # busy seconds and the AIMD read fetch_start -> fetch_done, the
        # decode alone
        self.started = 0.0
        self.pack_done = 0.0
        self.dispatch_done = 0.0
        self.wait_start = 0.0
        self.fetch_start = 0.0
        self.fetch_done = 0.0
        self.oldest_enq = 0.0
        # the devprof arm of the launch (composed_drain or
        # composed_analytics; "" = nothing launched), and the chain's
        # shared fetch window when it committed through one (0.0 = not)
        self.arm = ""
        self.chain_fetch_start = 0.0
        self.chain_fetch_done = 0.0


class DispatchPipeline:
    """Owns the drain/fetch pipeline of ONE engine.

    All router calls and launches run on the caller's single-thread engine
    executor (shared with the batcher's legacy lane, so the order of state
    changes is total); fetch and decode run on the pipeline's own fetch
    threads.  `depth` drains may be in flight at once."""

    def __init__(self, engine, engine_executor: ThreadPoolExecutor,
                 k_max: int = PIPELINE_K_BUCKETS[-1],
                 depth: Optional[int] = None, qos=None, analytics=None,
                 slo=None, metrics=None, tracer=None, profile=None):
        self.engine = engine
        # observability: the Metrics registry (or None), the span recorder
        # (None or disabled: no span), the armable capture shared with the
        # batcher, and the always-on window clock (its histogram only with
        # metrics; the JAX pipeline builds it only with metrics, the port
        # always, since its Instance has no registry by default)
        self.metrics = metrics
        self.tracer = tracer
        self.profile = profile
        self.devclock = WindowClock(metrics=metrics)
        # QoSManager (qos/) or None: tenant-fair slotting and the
        # congestion window's budget of each drain, its in-flight depth
        # and the fetch stride; None keeps every path as without QoS
        self.qos = qos
        # TrafficAnalytics / SLOEngine (observability/analytics.py) or None
        self.analytics = analytics
        self.slo = slo
        self.enabled = engine.native is not None
        self._engine_executor = engine_executor
        self.k_max = k_max
        self.depth = (env_int("GUBER_PIPELINE_DEPTH", 3) if depth is None
                      else depth)
        # occupancy gate: with a drain in flight, hold the next dispatch
        # until ~gate_frac of one window's lanes are pending
        self.gate_enabled = env_bool("GUBER_PIPELINE_GATE", True)
        self.gate_frac = env_float("GUBER_PIPELINE_GATE_FRAC", 1.0)
        # pumps the gate held back
        self.gate_holds = 0
        # injectable clock (tests pin it)
        self.now_fn: Callable[[], int] = millisecond_now
        # the warmed depths (engine.warmup launches PIPELINE_K_BUCKETS)
        self._k_buckets = tuple(
            b for b in PIPELINE_K_BUCKETS if b < k_max) + (k_max,)
        self._closed = False
        # RPC jobs (engine thread): staged, left over to the next drain by
        # a full stack, and refused by the parser (answered by the
        # protobuf path)
        self.rpc_staged = 0
        self.rpc_leftover = 0
        self.rpc_refused = 0
        # the raw-RPC lane's gate (JAX pipeline.py:563): the Instance's
        # set_peers closes it across a ring swap; the drain re-reads it on
        # the engine thread
        self.rpc_enabled = self.enabled
        # the ring's PeerClients, aligned with the parser's peer indices
        # (install_ring), the items forwarded to them, and the Instance's
        # Metrics (cluster_forwarded), when it has one
        self._ring_peers: tuple = ()
        self.forwarded = 0
        self._tasks: set = set()
        if not self.enabled:
            return
        # per-fetch-thread response encode buffer (RpcJob.finish)
        self._tls = threading.local()
        self._fetch_executor = ThreadPoolExecutor(
            max_workers=env_int("GUBER_FETCH_WORKERS", 2),
            thread_name_prefix="guber-fetch")
        self._arena_ring = WindowArenaRing(
            pinned=engine.device.type == "cuda", metrics=metrics)
        self._cols = RequestColumns()
        self._cols_pool: List[RequestColumns] = []
        self._empty_control = engine.empty_drain_control()
        # overlap accounting: per-stage busy seconds and the wall time the
        # pipeline had a drain in flight
        self.stage_busy = {"host_encode": 0.0, "device_dispatch": 0.0,
                           "fetch_decode": 0.0}
        self.active_wall = 0.0
        self._active_since = 0.0
        # the in-flight count integrated over time, and its last change:
        # over active_wall it is the mean depth the pipeline ran at
        self.inflight_seconds = 0.0
        self._inflight_at = 0.0
        # (req, fut, seq, enqueue stamp, trace context, col_idx)
        self._singles: List[tuple] = []
        self._singles_seen = 0            # the next single's seq
        self._jobs: List[object] = []     # ListJob / RpcJob, FIFO
        # jobs a full stack left over: the engine thread keeps them in
        # _carry and packs them first in its next drain, ahead of anything
        # taken since; the loop's copy (_carried) knows they still wait
        self._carry: List[object] = []
        self._carried: List[object] = []
        self._in_flight = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # duplicate-run folding (engine thread): decisions_staged /
        # lanes_staged is the fold factor; drains counts the dispatches
        self.decisions_staged = 0
        self.lanes_staged = 0
        self.drains = 0
        self.windows_staged = 0
        # submit-side coalescing (the reference's BatchWait): with free
        # drain slots and a small queue, wait up to coalesce_wait for more
        self.coalesce_wait = 0.0005
        self.coalesce_min = MAX_BATCH_SIZE
        self._coalesce_handle = None
        # deferred-fetch chain: up to the stride target's dispatched drains
        # complete through one fetch task, in dispatch order.
        # GUBER_FETCH_STRIDE is the floor; GUBER_FETCH_STRIDE_MAX caps how
        # far the QoS stride controller (qos/congestion.py observe_chain)
        # may grow it as the backlog deepens
        self.fetch_stride = max(1, env_int("GUBER_FETCH_STRIDE",
                                           FETCH_STRIDE_DEFAULT))
        self.fetch_stride_max = max(self.fetch_stride,
                                    env_int("GUBER_FETCH_STRIDE_MAX",
                                            FETCH_STRIDE_MAX_DEFAULT))
        self._stride_target = self.fetch_stride
        self.chain_linger = env_float("GUBER_CHAIN_LINGER_MS",
                                      CHAIN_LINGER_MS_DEFAULT) / 1000.0
        self._chain: List[_DrainResult] = []
        self._chain_timer = None
        # drains pumped but not yet through _on_dispatched: the only ones
        # that can still join the chain
        self._predispatch = 0
        self.fetch_elided = 0
        self.chain_flushes = 0

    def _resp_buf(self, size: int) -> np.ndarray:
        """This fetch thread's reusable proto-encode buffer (grown to
        fit; callers bytes()-copy out before returning)."""
        buf = getattr(self._tls, "buf", None)
        if buf is None or buf.nbytes < size:
            buf = self._tls.buf = np.empty(
                max(size, MAX_BATCH_SIZE * 64 + 64), np.uint8)
        return buf

    def _note_inflight(self, delta: int) -> None:
        """Every in-flight transition (event loop only): keeps the count
        and the pipeline-active wall clock consistent."""
        now = time.monotonic()
        if self._in_flight:
            self.inflight_seconds += (self._in_flight
                                      * (now - self._inflight_at))
        self._inflight_at = now
        self._in_flight += delta
        if delta > 0 and self._in_flight == 1:
            self._active_since = now
        elif delta < 0 and self._in_flight == 0 and self._active_since:
            self.active_wall += now - self._active_since
            self._active_since = 0.0
        if self.metrics is not None:
            self.metrics.pipeline_inflight_windows.set(self._in_flight)
        if self.qos is not None:
            self.qos.admission.note_inflight(self._in_flight)

    def overlap_snapshot(self) -> dict:
        """Per-stage busy seconds, pipeline-active wall seconds and their
        ratio (1.0 serial, up to the stage count under full overlap), the
        mean number of drains in flight while any was, the gate's holds,
        and the arena and chain counters."""
        now = time.monotonic()
        wall = self.active_wall
        if self._active_since:
            wall += now - self._active_since
        depth_s = self.inflight_seconds
        if self._in_flight:
            depth_s += self._in_flight * (now - self._inflight_at)
        busy = sum(self.stage_busy.values())
        return {
            "stage_busy_seconds": dict(self.stage_busy),
            "active_wall_seconds": wall,
            "overlap_ratio": (busy / wall) if wall > 0 else 0.0,
            "inflight_windows": self._in_flight,
            "mean_inflight": (depth_s / wall) if wall > 0 else 0.0,
            "gate_holds": self.gate_holds,
            "arena_reuse_events": self._arena_ring.reuse_events,
            "arena_alloc_events": self._arena_ring.alloc_events,
            "fetch_stride": self.fetch_stride,
            "fetch_stride_target": self._stride_target,
            "chained_pending": len(self._chain),
            "fetch_elided": self.fetch_elided,
            "chain_flushes": self.chain_flushes,
        }

    def install_ring(self, points, peer_of, peers, self_idx: int) -> None:
        """Install the cluster ring (engine thread): the C parser's point
        table and the aligned PeerClient list for forwards.  Empty points
        clear it back to standalone (every item local)."""
        self.engine.native.set_ring(points, peer_of, self_idx)
        self._ring_peers = tuple(peers)

    def _spawn(self, coro) -> None:
        t = self._loop.create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    # ------------------------------------------------------------ submit API

    def _enqueued(self) -> tuple:
        """(enqueue stamp, sampled trace context) of a submit, with its
        `enqueue` span recorded."""
        t_enq = time.monotonic()
        ctx = current_context()
        if self.tracer is not None and ctx is not None:
            ctx.enqueued_at = t_enq
            self.tracer.record_span(ctx, "enqueue", t_enq, t_enq)
        return t_enq, ctx

    async def submit_one(self, req: RateLimitReq) -> RateLimitResp:
        self._loop = asyncio.get_running_loop()
        fut = self._loop.create_future()
        t_enq, ctx = self._enqueued()
        self._singles.append((req, fut, self._singles_seen, t_enq, ctx,
                              self._cols.append(req)))
        self._singles_seen += 1
        self._pump()
        return await fut

    async def submit_many(self, reqs: Sequence[RateLimitReq]
                          ) -> List[RateLimitResp]:
        self._loop = asyncio.get_running_loop()
        fut = self._loop.create_future()
        ctx = current_context()
        job = ListJob(reqs, fut=fut, ctxs=[ctx] if ctx is not None else None,
                      enq=time.monotonic())
        job.after = self._singles_seen
        self._jobs.append(job)
        self._pump()
        return await fut

    async def submit_rpc(self, data: bytes,
                         peer_mode: bool = False) -> Optional[bytes]:
        """Serve a whole serialized GetRateLimitsReq (or, with peer_mode,
        a GetPeerRateLimitsReq, the same wire shape) authoritatively; None
        means the caller must run the protobuf path (also while the lane's
        gate is closed)."""
        if (not (self.enabled and self.rpc_enabled
                 and self.engine._compact_enabled) or self._closed):
            return None
        self._loop = asyncio.get_running_loop()
        fut = self._loop.create_future()
        job = RpcJob(data, fut, peer_mode=peer_mode)
        job.enq, job.ctx = self._enqueued()
        job.after = self._singles_seen
        self._jobs.append(job)
        self._pump()
        return await fut

    async def submit_cols(self, cols: tuple, name_lens, n: int,
                          want_cols: bool = False):
        """Serve request columns a front-door worker parsed (ColsJob):
        (key_bytes, key_ends, hits, limits, durations, algos) views into
        its slab, staged straight from there, and each item's name length
        (to rebuild the requests where engine.process must take them).
        Resolves to response bytes, to decision columns with want_cols, or
        to the response list when the job ran through engine.process; None
        means the hub must run the protobuf path (the lane's gate is
        closed, or ring peers are installed: pack_stack_fast never
        consults the ring)."""
        if (not (self.enabled and self.rpc_enabled
                 and self.engine._compact_enabled) or self._closed
                or self._ring_peers):
            return None
        self._loop = asyncio.get_running_loop()
        fut = self._loop.create_future()
        job = ColsJob(cols, name_lens, n, fut, want_cols=want_cols)
        job.enq, ctx = self._enqueued()
        if ctx is not None:
            job.ctxs = [ctx]
        job.after = self._singles_seen
        self._jobs.append(job)
        self._pump()
        return await fut

    def eligible(self, req: RateLimitReq) -> bool:
        """May this request ride the pipeline?  Mirrors the router's range
        checks exactly, so a pipeline job never range-falls-back."""
        return (self.enabled
                and not self._closed
                and req.behavior != Behavior.GLOBAL
                and req.algorithm in (Algorithm.TOKEN_BUCKET,
                                      Algorithm.LEAKY_BUCKET)
                and 0 <= req.hits < kernel.COMPACT_MAX_HITS
                and 0 <= req.limit < kernel.COMPACT_MAX_LIMIT
                and 0 <= req.duration < kernel.COMPACT_MAX_DURATION
                and self.engine._compact_enabled)

    # ------------------------------------------------------------ pump

    def _pending_decisions(self) -> int:
        return (len(self._singles)
                + sum(_pending_items(j) for j in self._jobs)
                + sum(_pending_items(j) for j in self._carried))

    def _take_jobs(self) -> tuple:
        """Snapshot pending work into drain jobs (loop thread).  Returns
        (jobs, cols_owner): cols_owner is the detached RequestColumns the
        singles chunks slice from; it belongs to THIS drain until its
        completion returns it to the pool."""
        jobs: List[object] = []
        cols_owner = None
        cut = None   # the first deferred single's seq
        if self._singles:
            singles, self._singles = self._singles, []
            cols_owner = self._cols
            self._cols = (self._cols_pool.pop() if self._cols_pool
                          else RequestColumns())
            fair = self.qos is not None and self.qos.fair_slotting
            if self.qos is not None:
                if fair:
                    # tenant-fair lane filling: a hot tenant's burst must
                    # not occupy every lane of the drain (stable within a
                    # tenant, so each key keeps its order)
                    singles = interleave_by_tenant(
                        singles, lambda t: tenant_of(t[0]))
                # the congestion window caps decisions a drain; the rest
                # stays queued for the next pump (completions re-pump)
                budget = self.qos.congestion.effective_window()
                if len(singles) > budget:
                    singles, deferred = singles[:budget], singles[budget:]
                    cut = min(t[2] for t in deferred)
                    # the deferred tail goes into the NEW columns (its old
                    # indices die with cols_owner), one gather a column
                    base = self._cols.extend_from(
                        cols_owner, [t[5] for t in deferred])
                    self._singles = [t[:5] + (base + k,)
                                     for k, t in enumerate(deferred)]
            for base in range(0, len(singles), MAX_BATCH_SIZE):
                chunk = singles[base:base + MAX_BATCH_SIZE]
                job = ListJob([t[0] for t in chunk],
                              futs=[t[1] for t in chunk],
                              ctxs=[t[4] for t in chunk],
                              enq=min(t[3] for t in chunk))
                # a chunk in submission order is a contiguous column range
                # (zero-copy); one that fair slotting reordered gathers
                idx = None
                if fair:
                    idx = np.fromiter((t[5] for t in chunk), np.int64,
                                      len(chunk))
                    if len(idx) == 1 or bool((np.diff(idx) == 1).all()):
                        idx = None
                if idx is None:
                    job._cols = cols_owner.take(chunk[0][5],
                                                chunk[-1][5] + 1)
                else:
                    job._cols = cols_owner.take(0, len(idx), idx)
                jobs.append(job)
        # a job submitted after a deferred single waits behind it, so a
        # key's later job cannot overtake it (jobs are FIFO in `after`)
        n = len(self._jobs)
        if cut is not None:
            n = 0
            while n < len(self._jobs) and self._jobs[n].after <= cut:
                n += 1
        jobs.extend(self._jobs[:n])
        del self._jobs[:n]
        return jobs, cols_owner

    def _cols_release(self, cols) -> None:
        """Return a drain's RequestColumns to the pool (loop thread).  The
        device never reads them (the router copies into the arena), so
        error paths release too."""
        if cols is None:
            return
        cols.reset()
        if len(self._cols_pool) < 4:
            self._cols_pool.append(cols)

    def _pump(self, force: bool = False) -> None:
        depth = (self.depth if self.qos is None
                 else self.qos.congestion.effective_depth(self.depth))
        stride = self._stride_target = self._stride_current()
        if stride > 1:
            # the chain needs stride drains pending fetch plus one being
            # packed, or it could never reach its stride
            depth = max(depth, stride + 1)
        if self._closed or self._in_flight >= depth:
            return
        if self.gate_enabled and self._in_flight >= 1 and self.gate_frac > 0:
            # occupancy gate: estimate the pending lanes from the queued
            # decisions through the live fold factor
            fold = (self.decisions_staged / self.lanes_staged
                    if self.lanes_staged > MAX_BATCH_SIZE else 1.0)
            lanes_est = self._pending_decisions() / max(fold, 1.0)
            eng = self.engine
            if lanes_est < (self.gate_frac * eng.batch_per_shard
                            * eng.num_shards):
                self.gate_holds += 1
                return
        if not force and self.coalesce_wait > 0:
            pending = self._pending_decisions()
            if 0 < pending < self.coalesce_min:
                if self._coalesce_handle is None:
                    self._coalesce_handle = self._loop.call_later(
                        self.coalesce_wait, self._coalesce_fire)
                return
        if self._coalesce_handle is not None:
            self._coalesce_handle.cancel()
            self._coalesce_handle = None
        jobs, cols = self._take_jobs()
        # leftover jobs wait on the engine thread: with nothing queued they
        # still need a drain, unless one is already heading there
        carry = bool(self._carried) and self._predispatch == 0
        if not jobs and not carry:
            self._cols_release(cols)
            if self._chain and self._predispatch == 0:
                # nothing queued and nothing heading for dispatch: no
                # drain can join the chain anymore
                self._chain_flush()
            return
        self._note_inflight(1)
        self._predispatch += 1
        fut = self._loop.run_in_executor(self._engine_executor,
                                         self._drain_sync, jobs, None, cols)
        fut.add_done_callback(lambda f: self._on_dispatched(f, jobs))

    def _coalesce_fire(self) -> None:
        self._coalesce_handle = None
        self._pump(force=True)

    # ------------------------------------------------------------ fetch chain

    def _stride_current(self) -> int:
        """Drains a fetch the chain targets now (loop thread).  The floor
        is GUBER_FETCH_STRIDE; the QoS stride controller may grow it with
        the backlog up to GUBER_FETCH_STRIDE_MAX, but never past the
        admission deadline's bound, so a chain's oldest drain still
        commits inside the default deadline."""
        if self.fetch_stride_max <= 1 or self.qos is None:
            return min(self.fetch_stride, self.fetch_stride_max)
        cc = self.qos.congestion
        stride = max(self.fetch_stride, cc.effective_stride())
        bound = cc.stride_bound(self.qos.conf.default_deadline)
        return max(1, min(stride, self.fetch_stride_max, bound))

    def _backlog_windows(self) -> float:
        """Queued decisions behind the pipeline, in windows (loop thread):
        the stride controller's growth signal."""
        fold = (self.decisions_staged / self.lanes_staged
                if self.lanes_staged > MAX_BATCH_SIZE else 1.0)
        eng = self.engine
        lanes = eng.batch_per_shard * eng.num_shards
        return ((self._pending_decisions() / max(fold, 1.0))
                / max(lanes, 1))

    def _chain_add(self, res: _DrainResult) -> None:
        """Append a dispatched, unfetched drain to the chain (loop thread).
        Flush at the stride, or when nothing else is coming (an empty
        queue with no drain heading for dispatch); otherwise the linger
        timer bounds how late a chained commit can be."""
        self._chain.append(res)
        if self.metrics is not None:
            self.metrics.chain_inflight_windows.set(len(self._chain))
        idle = not self._jobs and not self._singles and self._predispatch == 0
        if len(self._chain) >= self._stride_target or idle or self._closed:
            self._chain_flush()
        elif self._chain_timer is None:
            self._chain_timer = self._loop.call_later(
                self.chain_linger, self._chain_flush)

    def _chain_flush(self) -> None:
        """Complete every chained drain with ONE fetch task (loop thread),
        in dispatch order."""
        if self._chain_timer is not None:
            self._chain_timer.cancel()
            self._chain_timer = None
        if not self._chain:
            return
        group, self._chain = self._chain, []
        self.chain_flushes += 1
        self.fetch_elided += len(group) - 1
        if self.metrics is not None:
            m = self.metrics
            m.chain_inflight_windows.set(0)
            m.chain_fetch_stride.set(self._stride_target)
            if len(group) > 1:
                m.chain_fetch_elided.inc(len(group) - 1)
        if self.qos is not None:
            self.qos.congestion.observe_chain(self._backlog_windows(),
                                              self.fetch_stride_max)
        cfut = self._loop.run_in_executor(self._fetch_executor,
                                          self._complete_chain_sync, group)
        cfut.add_done_callback(lambda f: self._on_chain_completed(f, group))

    def _complete_chain_sync(self, group: List[_DrainResult]) -> list:
        """Fetch thread: wait once, for the LAST member's event (one
        stream: every earlier member's copies came before it), then decode
        each member in dispatch order.  The shared wait is each member's
        chain_fetch window; its drain_commit covers its own decode only,
        so the stage sums count the wait once, not stride times."""
        t0 = time.monotonic()
        last = next((r.event for r in reversed(group)
                     if r.event is not None), None)
        if last is not None:
            last.synchronize()
        t_fetched = time.monotonic()
        for res in group:
            res.chain_fetch_start = t0
            res.chain_fetch_done = t_fetched
        return [self._complete_sync(res) for res in group]

    def _on_chain_completed(self, fut, group: List[_DrainResult]) -> None:
        """Loop thread: commit every chained member in dispatch order.  A
        failed group fetch fails every member (one fetch, one failure
        domain; none of their arenas is known to be free)."""
        try:
            pairs = fut.result()
        except Exception as e:
            log.exception("pipeline chain fetch failed")
            for res in group:
                self._fail_completed(res, e)
            return
        if self.metrics is not None and pairs:
            # one observation of the shared fetch a chain, not one a member
            head = pairs[0][0]
            if head.chain_fetch_done > head.chain_fetch_start:
                self.metrics.observe_stage(
                    "chain_fetch",
                    head.chain_fetch_done - head.chain_fetch_start)
        for res, outs in pairs:
            self._commit_completed(res, outs)

    def _on_dispatched(self, fut, jobs) -> None:
        self._predispatch -= 1
        try:
            res: _DrainResult = fut.result()
        except Exception as e:  # the drain itself crashed: fail ITS jobs
            # (with the leftovers it took over: drains arrive in order)
            log.exception("pipeline drain failed")
            self._note_inflight(-1)
            for job in jobs + self._carried:
                self._resolve_error(job, e)
            self._carried = []
            self._chain_flush()
            self._pump(force=True)
            return
        for job, out in res.fallback:
            if isinstance(out, Exception):
                self._resolve_error(job, out)
            else:
                self._resolve(job, out)
        # drains reach here in dispatch order
        if res.carried:
            self._carried = []
        if res.leftover:
            self._carried = list(res.leftover)
        if res.error is not None:
            self._note_inflight(-1)
            self._cols_release(res.cols_owner)
            for job in res.staged:
                self._resolve_error(job, res.error)
            self._chain_flush()
            self._pump(force=True)
            return
        if not res.staged:
            # nothing staged: nothing was launched against the arena
            self._note_inflight(-1)
            self._cols_release(res.cols_owner)
            self._arena_ring.release(res.arena)
            res.arena = None
            self._pump(force=True)
            return
        # start the forwards of the drain's mixed RPCs now, so the peers'
        # round trips overlap the local stack's fetch; the completion
        # callbacks attached below run after this, so each mixed job's
        # forward_task exists when its drain commits
        mixed = [j for j in res.staged if isinstance(j, RpcJob) and j.remote]
        if mixed:
            self._spawn_forwards(mixed, res.ring_peers)
        if res.deferred:
            self._chain_add(res)
        else:
            # the fetch was submitted from the engine thread; completion
            # still lands on the loop, the one ordered completion queue
            res.cfut.add_done_callback(
                lambda f: self._loop.call_soon_threadsafe(
                    self._on_completed, f, res))
        # another drain may dispatch while this one's fetch is in flight
        self._pump(force=True)

    def _on_completed(self, fut, res: _DrainResult) -> None:
        try:
            _, outs = fut.result()
        except Exception as e:  # fetch/decode failed: fail THIS drain's jobs
            log.exception("pipeline fetch failed")
            self._fail_completed(res, e)
            return
        self._commit_completed(res, outs)

    def _fail_completed(self, res: _DrainResult, err: Exception) -> None:
        """Completion-path failure (loop thread): fail the drain's jobs.
        The arena is dropped, not released: nothing proves the device is
        done with it."""
        self._note_inflight(-1)
        self._cols_release(res.cols_owner)
        res.cols_owner = None
        res.arena = None
        if self.slo is not None:
            self.slo.observe_error(max(1, res.n_decisions))
        for job in res.staged:
            self._resolve_error(job, err)
        self._pump(force=True)

    def _commit_completed(self, res: _DrainResult, outs) -> None:
        self._note_inflight(-1)
        self._cols_release(res.cols_owner)
        res.cols_owner = None
        # clean completion: the fetch waited for the drain's event, so the
        # device is done with the arena
        self._arena_ring.release(res.arena)
        res.arena = None
        for job, out in zip(res.staged, outs):
            self._resolve(job, out)
        # one clock for control and observability: the drain's wall is the
        # traced stage boundary started -> fetch_done, so the AIMD, the
        # stage histograms and the spans read the same numbers
        drain_wall = (res.fetch_done or time.monotonic()) - res.started
        t_he = res.pack_done - res.started if res.pack_done else 0.0
        t_disp = (res.dispatch_done - res.pack_done
                  if res.dispatch_done and res.pack_done else 0.0)
        t_fetch = (res.fetch_done - res.fetch_start
                   if res.fetch_done and res.fetch_start else 0.0)
        sb = self.stage_busy
        sb["host_encode"] += t_he
        sb["device_dispatch"] += t_disp
        sb["fetch_decode"] += t_fetch
        if self.qos is not None and res.n_decisions:
            self.qos.congestion.observe_drain(drain_wall,
                                              depth=max(1, res.k_used))
            self.qos.congestion.observe_stages(t_he, t_disp, t_fetch,
                                               pipelined=self.depth > 1)
        if self.analytics is not None and res.stats_host is not None:
            try:
                self.analytics.ingest(res.stats_host, res.an_decay)
            except Exception:
                log.exception("analytics ingest failed")
        if self.slo is not None:
            self.slo.observe_drain(drain_wall, res.n_decisions)
        if self.metrics is not None:
            self._observe_drain(res, drain_wall)
        if res.arm and res.dispatch_done and res.fetch_done:
            staged = res.staged

            def trace_ids(jobs=staged):
                return [c.trace_id for c in _job_contexts(jobs)][:4]

            self.devclock.observe(res.arm, res.fetch_done - res.dispatch_done,
                                  trace_ids=trace_ids,
                                  windows=max(1, res.k_used))
        tr = self.tracer
        if tr is not None and tr.enabled:
            for c in set(_job_contexts(res.staged)):
                if c.enqueued_at:
                    tr.record_span(c, "admission_wait", c.enqueued_at,
                                   res.started)
                if res.pack_done:
                    tr.record_span(c, "window_fill", res.started,
                                   res.pack_done)
                if res.dispatch_done and res.pack_done:
                    tr.record_span(c, "device_dispatch", res.pack_done,
                                   res.dispatch_done)
                if res.fetch_done and res.fetch_start:
                    tr.record_span(c, "drain_commit",
                                   res.wait_start or res.fetch_start,
                                   res.fetch_done)
                if res.chain_fetch_done > res.chain_fetch_start:
                    tr.record_span(c, "chain_fetch", res.chain_fetch_start,
                                   res.chain_fetch_done)
        self._pump(force=True)

    def _observe_drain(self, res: _DrainResult, drain_wall: float) -> None:
        """A committed drain's window, occupancy, depth and overlap
        metrics and its stage histograms (JAX pipeline.py:1451-1493)."""
        m = self.metrics
        wall = self.active_wall
        if self._active_since:
            wall += time.monotonic() - self._active_since
        if wall > 0:
            m.pipeline_overlap_ratio.set(sum(self.stage_busy.values())
                                         / wall)
        m.window_count.inc()
        m.window_occupancy.observe(res.n_decisions)
        m.window_duration.observe(drain_wall)
        m.agg_decisions.inc(res.n_decisions)
        m.agg_lanes.inc(res.n_lanes)
        m.drain_depth.observe(res.k_used)
        if res.words is not None and not self.engine.per_op:
            m.fused_drains.inc()
        if res.oldest_enq:
            m.observe_stage("admission_wait", res.started - res.oldest_enq)
        if res.pack_done:
            m.observe_stage("window_fill", res.pack_done - res.started)
        if res.dispatch_done and res.pack_done:
            m.observe_stage("device_dispatch",
                            res.dispatch_done - res.pack_done)
        if res.fetch_done and res.fetch_start:
            m.observe_stage("drain_commit", res.fetch_done
                            - (res.wait_start or res.fetch_start))

    def _spawn_forwards(self, jobs: List[RpcJob], ring_peers) -> None:
        """Forward a drain's remote items to their ring owners as spliced
        bytes (JAX pipeline.py:1299-1373): per owner, every mixed RPC's
        RateLimitReq frames concatenate into one GetPeerRateLimitsReq (the
        same field-1 framing), in chunks of the 1000-item cap, sent with
        the owner's PeerClient.get_peer_rate_limits_raw (the reference's
        per-peer batch relay, peers.go:143-207).  Each job's forward_task
        resolves to {item index: framed RateLimitResp} as soon as its own
        items are answered; a failed chunk answers its items with an
        in-band error, as the per-item path does."""
        by_owner: dict = {}
        pending: dict = {}
        results: dict = {}
        n_fwd = 0
        for job in jobs:
            job.forward_task = self._loop.create_future()
            pending[id(job)] = len(job.remote)
            results[id(job)] = {}
            n_fwd += len(job.remote)
            for i, owner, frame in job.remote:
                by_owner.setdefault(owner, []).append((job, i, frame))
        self.forwarded += n_fwd
        if self.metrics is not None:
            self.metrics.cluster_forwarded.inc(n_fwd)

        def deliver(job, i, frame):
            jid = id(job)
            results[jid][i] = frame
            pending[jid] -= 1
            if pending[jid] == 0 and not job.forward_task.done():
                job.forward_task.set_result(results[jid])

        async def one_chunk(owner_idx, items):
            # everything inside the try: forward_task has no exception
            # path (errors are per item), so an escape here would leave
            # the jobs' futures unresolved
            peer = None
            try:
                peer = ring_peers[owner_idx]
                resp = await peer.get_peer_rate_limits_raw(
                    b"".join(f for _, _, f in items))
                frames = _walk_frames(resp)
                if len(frames) != len(items):
                    raise RuntimeError(
                        "number of rate limits in peer response does not "
                        "match request")
                for (job, i, _), fr in zip(items, frames):
                    deliver(job, i, _append_owner(fr, peer.host))
            except BaseException as e:  # noqa: BLE001 - even a cancel
                # must resolve the chunk's items first
                host = getattr(peer, "host", f"ring#{owner_idx}")
                fr = _error_frame(f"while fetching rate limit from peer "
                                  f"{host} - '{e}'")
                for job, i, _ in items:
                    deliver(job, i, fr)
                if not isinstance(e, Exception):
                    raise

        for owner_idx, items in by_owner.items():
            for base in range(0, len(items), MAX_BATCH_SIZE):
                self._spawn(
                    one_chunk(owner_idx, items[base:base + MAX_BATCH_SIZE]))

    async def _assemble_mixed(self, job: RpcJob, local_parts) -> None:
        """Splice a mixed RPC's local framed segments with its forwarded
        framed responses, positionally, into its GetRateLimitsResp bytes
        (JAX pipeline.py:1541)."""
        try:
            seg, item_off, item_len = local_parts
            fwd = await job.forward_task
            parts = []
            for i in range(job.n):
                if item_len[i]:
                    o = int(item_off[i])
                    parts.append(seg[o:o + int(item_len[i])])
                else:
                    parts.append(fwd[i])
            if not job.fut.done():
                job.fut.set_result(b"".join(parts))
        except BaseException as e:  # noqa: BLE001 - resolve, then re-raise
            # what is not an Exception
            if not job.fut.done():
                job.fut.set_exception(
                    e if isinstance(e, Exception)
                    else RuntimeError(f"pipeline shutdown ({type(e).__name__})"))
            if not isinstance(e, Exception):
                raise

    def _resolve(self, job, out) -> None:
        if isinstance(job, RpcJob) and job.forward_task is not None:
            self._spawn(self._assemble_mixed(job, out))
            return
        if job.futs is not None:
            for f, r in zip(job.futs, out):
                if not f.done():
                    f.set_result(r)
        elif not job.fut.done():
            job.fut.set_result(out)

    def _resolve_error(self, job, err: Exception) -> None:
        futs = [job.fut] if job.futs is None else job.futs
        for f in futs:
            if f is not None and not f.done():
                f.set_exception(
                    err if isinstance(err, Exception) else RuntimeError(err))

    # ------------------------------------------------------------ engine side

    def _drain_sync(self, jobs: List[object], now: Optional[int] = None,
                    cols: Optional[RequestColumns] = None) -> _DrainResult:
        """The engine thread's drain, inside the armed capture when
        POST /v1/admin/profile (or the periodic controller) asked for one;
        disarmed, one int read."""
        prof = self.profile
        if prof is not None and prof.armed:
            prof.before_drain()
            try:
                return self._drain_sync_inner(jobs, now, cols)
            finally:
                prof.after_drain()
        return self._drain_sync_inner(jobs, now, cols)

    def _drain_sync_inner(self, jobs: List[object],
                          now: Optional[int] = None,
                          cols: Optional[RequestColumns] = None
                          ) -> _DrainResult:
        """Pack every job into one stacked compact dispatch (engine
        thread).

        The stack is packed into an arena of the ring, launched, and its
        outputs' copies to the arena's host buffers queued behind it with
        an event; nothing here waits for the device (the arena was free,
        the copies are non-blocking from and to pinned memory, the
        launches are asynchronous).  The fetch then runs on a fetch
        thread, submitted from here unless the drain joins a chain."""
        eng = self.engine
        native = eng.native
        S = eng.num_shards
        B = eng.batch_per_shard
        K = self.k_max
        res = _DrainResult()
        res.started = time.monotonic()
        if now is None:
            now = self.now_fn()
        res.now = now
        res.cols_owner = cols
        list_ok = eng._compact_enabled
        rpc_ok = self.rpc_enabled and list_ok
        res.ring_peers = self._ring_peers
        # the previous drain's leftovers first: they were taken before
        # anything this drain was given
        if self._carry:
            res.carried = True
            jobs = self._carry + jobs
            self._carry = []

        arena = self._arena_ring.acquire(K, S, B)
        res.arena = arena
        arena.dirty = True
        fills = arena.fills
        native.drain_begin()
        stack_empty = True
        for idx, job in enumerate(jobs):
            if isinstance(job, RpcJob):
                n = -1
                if rpc_ok:
                    scr = arena.acquire_scratch()
                    job.row, job.lane, job.pos = scr.row, scr.lane, scr.pos
                    job.limit = scr.limit
                    n = native.parse_stack_fast(
                        job.data, now, B, K, MAX_BATCH_SIZE, arena, scr,
                        use_ring=not job.peer_mode)
                if n >= 0:
                    job.n = n
                    res.staged.append(job)
                    self.rpc_staged += 1
                    remote = np.flatnonzero(scr.row[:n] < -1)
                    if len(remote):
                        # the forwards run on the loop after this drain's
                        # arena (and its scratch) may be reused: copy each
                        # remote item's frame out now
                        data, off, mlen = job.data, scr.off, scr.mlen
                        job.remote = [
                            (int(i), -2 - int(scr.row[i]),
                             b"\x0a" + _varint(int(mlen[i]))
                             + data[int(off[i]):int(off[i]) + int(mlen[i])])
                            for i in remote.tolist()]
                    if len(remote) < n:
                        stack_empty = False
                elif n == -6 and not stack_empty:
                    self.rpc_leftover += 1
                    self._leave_over(res, jobs[idx:])
                    break
                else:
                    # refused before staging anything (the parser's pass
                    # 1 has no side effects): the caller's protobuf path
                    self.rpc_refused += 1
                    res.fallback.append((job, None))
                continue
            rc = -1
            if list_ok and job.n <= MAX_BATCH_SIZE:
                jcols = job.columns()
                scr = arena.acquire_scratch()
                job.row = scr.row[:job.n]
                job.lane = scr.lane[:job.n]
                job.pos = scr.pos[:job.n]
                rc = native.pack_stack_fast(*jcols, now, B, K, arena, scr)
            if rc >= 0:
                res.staged.append(job)
                stack_empty = False
            elif stack_empty:
                # a job no stack takes (an unsound engine, more items than
                # a scratch block, a request the router refuses, more lanes
                # than K windows): the full path, here, in its turn.  No
                # lane is staged, so the open drain has nothing to lose;
                # it is opened again for the jobs after it.
                res.fallback.append(
                    (job, self._legacy_process(job, now)))
                native.drain_begin()
            else:
                self._leave_over(res, jobs[idx:])
                break

        res.pack_done = time.monotonic()
        enqs = [e for e in (j.enq for j in res.staged) if e]
        res.oldest_enq = min(enqs) if enqs else 0.0
        if not res.staged:
            return res
        k_used = res.k_used = int(fills.any(axis=1).sum())
        if k_used:
            res.arm = (ARM_ANALYTICS if self.analytics is not None
                       else ARM_DRAIN)
            kb = next(b for b in self._k_buckets if b >= k_used)
            packed = arena.packed_t[:kb]
            nows = arena.nows_t[:kb]
            nows.fill_(now)
            try:
                # the fault seam: an injected dispatch failure aborts the
                # router's staged allocations (no partial commit) and fails
                # exactly this drain's jobs; the drains in flight beside it
                # commit through the ordered completion queue untouched
                if FAULTS.enabled:
                    FAULTS.on_sync(SEAM_ENGINE_DISPATCH, "pipeline")
                if self.analytics is not None:
                    an_args = self._analytics_stage(res, arena, kb, now)
                    out = eng.pipeline_dispatch_global(
                        packed, nows, *self._empty_control,
                        n_windows=k_used, analytics_args=an_args)
                    res.stats = arena.host("stats", tuple(out[4].shape),
                                           torch.int64)
                    res.an_decay = an_args[1]
                else:
                    out = eng.pipeline_dispatch(packed, nows,
                                                n_windows=k_used)
                native.commit()
            except Exception as e:
                native.abort()
                res.error = e
                return res
            res.words, res.limits, mism = out[:3]
            pairs = [(res.words, arena.words_t[:kb]),
                     (mism, arena.mism_t[:kb])]
            if res.stats is not None:
                pairs.append((out[4], res.stats))
            res.event = eng.fetch_async(pairs)
            self.drains += 1
            self.windows_staged += k_used
        else:
            native.commit()  # staged jobs with no item: nothing to launch
        res.dispatch_done = time.monotonic()
        # forwarded items are the owners' decisions (their drains count
        # them), not this node's
        res.n_decisions = sum(
            j.n - len(getattr(j, "remote", ())) for j in res.staged)
        # counted on the engine thread, like the legacy lane's process()
        eng.decisions_processed += res.n_decisions
        self.decisions_staged += res.n_decisions
        res.n_lanes = int(fills.sum())
        self.lanes_staged += res.n_lanes
        # a chain member submits no fetch: the loop chains it (the stride
        # target is an int the loop refreshes every pump; a stale read
        # moves only where the fetch is submitted)
        if self._stride_target > 1:
            res.deferred = True
            return res
        res.cfut = self._fetch_executor.submit(self._complete_sync_one, res)
        return res

    def _leave_over(self, res: _DrainResult, rest: List[object]) -> None:
        """The jobs a full stack cannot take wait for the next drain, in
        order, ahead of whatever that drain is given (engine thread).  A
        singles chunk views this drain's columns, which go back to the pool
        at its completion, so it keeps copies."""
        res.leftover = rest
        for job in rest:
            cols = getattr(job, "_cols", None)
            if cols is not None:
                job._cols = cols[:2] + tuple(np.array(c) for c in cols[2:])
        self._carry = list(rest)

    def _legacy_process(self, job: ListJob, now: int):
        """engine.process over a job's requests (engine thread): their
        responses, or the exception that failed them."""
        try:
            return self.engine.process(job.reqs, now)
        except Exception as e:
            return e

    def _analytics_stage(self, res: _DrainResult, arena, kd: int, now: int):
        """The drain's tenant lanes i32[kd, S, B] (in the arena's buffer)
        and decay flag, staged before the dispatch: each staged ListJob
        lane's tenant id (qos/fairness.tenant_of of its request), each
        slot it touches labelled with its key for the top-K.  RpcJob and
        ColsJob lanes stay tenant 0 ("other") and label nothing, as in the
        JAX pipeline: neither lane builds a request on the host.  Any failure
        degrades to zero tenants and no decay: analytics never fails a
        drain."""
        eng = self.engine
        S = eng.num_shards
        t = arena.host("tenants", (arena.K, S, eng.batch_per_shard),
                       torch.int32)[:kd]
        t.zero_()
        tenants = t.numpy()
        packed = arena.packed
        decay = 0
        try:
            an = self.analytics
            for job in res.staged:
                if isinstance(job, (RpcJob, ColsJob)):
                    continue
                rows = job.row
                for i in range(job.n):
                    row = int(rows[i])
                    if row < 0:
                        continue
                    k, s = divmod(row, S)
                    if k >= kd:
                        continue
                    lane = int(job.lane[i])
                    r = job.reqs[i]
                    tenants[k, s, lane] = an.tenant_id(tenant_of(r))
                    slot = int(packed[k, s, lane, 0] & _SLOT_MASK) - 1
                    if slot >= 0:
                        an.label_slot(s, slot, r.hash_key())
            decay = an.decay_flag(now)
        except Exception:
            log.exception("analytics staging failed (drain unaffected)")
            t.zero_()
            decay = 0
        return t, decay

    # ------------------------------------------------------------ fetch side

    def _complete_sync_one(self, res: _DrainResult):
        """Fetch thread, one drain: wait for its event, then decode."""
        res.wait_start = time.monotonic()
        if res.event is not None:
            res.event.synchronize()
        return self._complete_sync(res)

    def _complete_sync(self, res: _DrainResult):
        """Decode a drain whose event has passed (fetch thread): the words
        and flags from the arena's host buffers; the stored-limit plane
        crosses only when a flag fired, as in the JAX package."""
        res.fetch_start = time.monotonic()
        B = self.engine.batch_per_shard
        if res.words is None:  # staged jobs with no item: nothing launched
            wflat = np.empty((0, B), np.int64)
            clflat = None
        else:
            kd = res.words.shape[0]
            wflat = res.arena.words_t[:kd].numpy().reshape(-1, B)
            clflat = None
            if res.arena.mism_t[:kd].numpy().any():
                clflat = res.limits.cpu().numpy().reshape(-1, B)
        if res.stats is not None:
            res.stats_host = res.stats.numpy().copy()
        outs = [job.finish(self, wflat, clflat, res.now)
                if isinstance(job, (RpcJob, ColsJob))
                else job.finish(wflat, clflat, res.now)
                for job in res.staged]
        res.fetch_done = time.monotonic()
        return res, outs

    def busy(self) -> bool:
        """Is any job queued, left over or in flight?"""
        return bool(self._in_flight or self._singles or self._jobs
                    or self._carried)

    def close(self) -> None:
        if not self.enabled:
            return
        self._closed = True
        if self._coalesce_handle is not None:
            self._coalesce_handle.cancel()
            self._coalesce_handle = None
        # fail still-queued jobs: _pump returns early once closed
        err = RuntimeError("pipeline closed")
        jobs, self._jobs = self._jobs, []
        singles, self._singles = self._singles, []
        for job in jobs + self._carried:
            self._resolve_error(job, err)
        for entry in singles:
            if not entry[1].done():
                entry[1].set_exception(err)
        # chained drains still pending fetch complete now: shutdown
        # (wait=False) still runs work already queued
        self._chain_flush()
        self._fetch_executor.shutdown(wait=False)
