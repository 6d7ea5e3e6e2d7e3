"""Shared-memory rings for the multi-process front door.

A copy of `gubernator_tpu/core/shm_ring.py`: the same segment layout,
record kinds, status block and shed-reason codes, so a record written by
either package's worker reads the same in either package's hub
(tests/test_torch_shm_ring.py holds the two byte for byte).  It imports
numpy and the standard library only: the front door's worker processes
import it and must never load torch.

Each frontdoor worker process owns ONE shared-memory segment holding a
pair of SPSC index rings plus a pool of preallocated columnar slabs:

  header     | submission ring | completion ring | slab pool
  int64[64]  | int64[slots]    | int64[4*slots]  | slots * slab_bytes

The worker is the single producer of the submission ring and the single
consumer of the completion ring; the engine hub is the mirror image.  A
record's life cycle:

  worker: alloc() a free slab  ->  write the record (RAW bytes, or the
  C-parsed request COLUMNS via frontdoor_parse_req writing straight into
  the slab)  ->  submit(slot): publish the slot index
  engine: pop() the index, read the record (columns are zero-copy numpy
  views into the slab)  ->  serve it  ->  complete(slot, ...): write the
  response back INTO the same slab + publish a completion entry: either
  serialized bytes, or (complete_cols) packed DECISION columns that the
  WORKER encodes to protobuf in its own process
  worker: poll_completions_raw() reads the response (encoding columnar
  completions first), then frees the slab

Slot indices travel through the rings; slabs return to the worker's free
list only via a completion, so the engine may keep a slab's column views
alive across drains (a leftover ColsJob re-staged by a later drain still
reads valid memory) and a half-written record is never observed: the
producer publishes its ring tail only AFTER the slab payload and the ring
entry are fully written (aligned int64 stores; x86-TSO/acquire-release
ordering is assumed, as everywhere numpy shares buffers across processes).

No locks, no syscalls on the hot path, nothing pickled: the only
cross-process traffic is the slab bytes themselves.
"""

from __future__ import annotations

import time
from multiprocessing import shared_memory
from typing import List, Optional, Tuple

import numpy as np

# record kinds (slab header [0]): the frontdoor workers front EVERY
# public service, so each PeersV1 RPC gets a RAW kind of its own
KIND_RAW = 0          # serialized GetRateLimitsReq bytes
KIND_COLS = 1         # C-parsed GetRateLimitsReq columns
KIND_PEER_RL = 2      # serialized GetPeerRateLimitsReq (authoritative)
KIND_TRANSFER = 3     # TransferBuckets payload
KIND_REGISTER = 4     # serialized RegisterGlobalsReq
KIND_APPLY_GREG = 5   # serialized ApplyGlobalRegistrationReq
KIND_UPDATE_GLOBALS = 6  # serialized UpdatePeerGlobalsReq
KIND_BATCH_COLS = 7   # several coalesced RPCs' columns in ONE slab: the
#                       per-RPC item counts live in the counts region and
#                       the columns are the concatenation, so the engine
#                       stages the whole batch as one pipeline job

# completion status: 0 = OK (payload is response bytes); > 0 = the gRPC
# status code the worker must abort with (payload is the utf-8 message)
STATUS_OK = 0

# Completion entries whose LENGTH field is negative carry decision
# COLUMNS in the slab instead of serialized response bytes: n = -length
# items at resp_views(slot), and the WORKER encodes the protobuf (native
# frontdoor_encode_resp or the pb fallback) — the engine never serializes
# for columnar records.  A flags column value of 0 is a plain decision;
# nonzero indexes SHED_REASON_CODES (mirrored in host_router.cc
# SHED_REASONS) and the worker adds qos/admission.py's shed metadata.
SHED_REASON_CODES = {
    "queue_full": 1,
    "deadline": 2,
    "breaker_open": 3,
    "draining": 4,
    "ring_full": 5,
}
SHED_CODE_REASONS = {v: k for k, v in SHED_REASON_CODES.items()}

_HDR_I64 = 64          # header int64s (publish counters, cacheline-spread)
_SUB_TAIL = 0          # worker-written
_SUB_HEAD = 8          # engine-written
_COMP_TAIL = 16        # engine-written
_COMP_HEAD = 24        # worker-written
_REC_HDR = 64          # per-slab record header bytes
_COLS_BYTES_PER_ITEM = 40  # key_ends+hits+limits+durations (8*4) + algo+name_len (4*2)
MAX_ITEMS = 1000       # MAX_BATCH_SIZE: the reference's per-RPC cap
MAX_BATCH_RPCS = 64    # coalesced RPCs per KIND_BATCH_COLS record (the
#                        counts region is a fixed int64[MAX_BATCH_RPCS])


def _align(n: int, a: int = 64) -> int:
    return (n + a - 1) // a * a


class ShmRecord:
    """One popped submission, engine side.  COLS records expose zero-copy
    numpy views into the slab (valid until complete(slot, ...)); RAW
    records carry a bytes copy of the payload."""

    __slots__ = ("slot", "kind", "req_id", "deadline", "n", "cols",
                 "name_lens", "payload", "counts", "trace")

    def __init__(self, slot: int, kind: int, req_id: int, deadline: float):
        self.slot = slot
        self.kind = kind
        self.req_id = req_id
        self.deadline = deadline
        self.n = 0
        self.cols = None
        self.name_lens = None
        self.payload = b""
        self.counts = None  # KIND_BATCH_COLS: per-RPC item counts
        self.trace = None   # propagated traceparent (hi64, lo64, span) or None


try:  # pragma: no cover - stdlib-version dependent
    from multiprocessing import resource_tracker
except Exception:  # pragma: no cover
    resource_tracker = None


def _quiet_close(shm: shared_memory.SharedMemory) -> None:
    """close() that tolerates still-exported views: popped records hand
    out zero-copy numpy slices of the mapping, and a few may outlive the
    channel (a leftover ColsJob, a late completion).  Transfer ownership
    of the mapping to those views — it unmaps when the last one dies —
    and leave nothing for SharedMemory.__del__ to trip over."""
    try:
        shm.close()
    except BufferError:
        shm._buf = None
        shm._mmap = None
    except Exception:
        pass


def _attach_untracked(name: str) -> shared_memory.SharedMemory:
    """Attach WITHOUT registering with the resource tracker: on 3.10
    attach registers too (no `track=` parameter yet), and the tracker
    would unlink the engine-owned segment when the worker exits.
    Suppressing the register beats register-then-unregister: the shared
    tracker's cache is a SET, so two workers' register/unregister pairs
    against the same segment (the status block) can interleave as
    reg,reg,unreg,unreg — the registers collapse and the second
    unregister KeyErrors in the tracker process."""
    if resource_tracker is None:  # pragma: no cover
        return shared_memory.SharedMemory(name=name)
    orig = resource_tracker.register
    resource_tracker.register = lambda *a, **k: None
    try:
        return shared_memory.SharedMemory(name=name)
    finally:
        resource_tracker.register = orig


class WorkerChannel:
    """One worker's submission/completion ring pair + slab pool.

    The ENGINE creates (and eventually unlinks) the segment; the worker
    attaches by name.  Exactly one thread on each side may touch each
    ring: worker event loop = submission producer + completion consumer,
    engine = submission consumer (hub consumer thread) + completion
    producer (whichever engine thread finished the record — the hub
    serializes completions through one writer)."""

    def __init__(self, shm: shared_memory.SharedMemory, slots: int,
                 slab_bytes: int, owner: bool):
        self._shm = shm
        self._owner = owner
        self.slots = slots
        self.slab_bytes = slab_bytes
        buf = shm.buf
        self._hdr = np.frombuffer(buf, np.int64, _HDR_I64, 0)
        sub_off = _HDR_I64 * 8
        self._sub = np.frombuffer(buf, np.int64, slots, sub_off)
        comp_off = _align(sub_off + slots * 8)
        self._comp = np.frombuffer(buf, np.int64, slots * 4, comp_off)
        self._pool_off = _align(comp_off + slots * 32)
        self._slabs = [
            np.frombuffer(buf, np.uint8, slab_bytes,
                          self._pool_off + i * slab_bytes)
            for i in range(slots)
        ]
        # fixed columnar layout inside every slab (COLS records): the
        # batch counts region (per-RPC item counts of a KIND_BATCH_COLS
        # record; response byte lengths of its bytes-form completion)
        # sits between the record header and the columns, then column
        # capacity, and the key region takes the rest.  The RESPONSE
        # columns of a columnar completion reuse the request columns'
        # offsets (status/limit/remaining/reset over ke/hi/li/du, flags
        # over algos) — by completion time the request columns are dead.
        self._cnt_off = _REC_HDR
        # trace region: uint64[4] = [trace_id_hi, trace_id_lo, span_id,
        # flags (bit0 = valid)] — the worker-propagated W3C traceparent of
        # a COLS/BATCH record, so the engine can root its drain spans
        # under the caller's trace.  Sits
        # between the counts region and the columns; workers write it (or
        # clear it) before every commit, since slabs are reused.
        self._tr_off = _REC_HDR + 8 * MAX_BATCH_RPCS
        cols0 = self._tr_off + 32
        self.cap_items = min(
            MAX_ITEMS,
            max(0, (slab_bytes - cols0) // (_COLS_BYTES_PER_ITEM + 8)))
        c = self.cap_items
        self._ke_off = cols0
        self._hi_off = cols0 + 8 * c
        self._li_off = cols0 + 16 * c
        self._du_off = cols0 + 24 * c
        self._al_off = cols0 + 32 * c
        self._nl_off = cols0 + 36 * c
        self._key_off = cols0 + _COLS_BYTES_PER_ITEM * c
        self.key_cap = slab_bytes - self._key_off
        # worker-side free list (the worker is the only allocator; slots
        # come back via completions)
        self._free: List[int] = list(range(slots))

    # ------------------------------------------------------------ lifecycle

    @staticmethod
    def segment_size(slots: int, slab_bytes: int) -> int:
        sub_off = _HDR_I64 * 8
        comp_off = _align(sub_off + slots * 8)
        pool_off = _align(comp_off + slots * 32)
        return pool_off + slots * slab_bytes

    @classmethod
    def create(cls, name: str, slots: int,
               slab_bytes: int) -> "WorkerChannel":
        slab_bytes = _align(slab_bytes)
        size = cls.segment_size(slots, slab_bytes)
        try:  # a crashed previous run may have leaked the name
            stale = shared_memory.SharedMemory(name=name)
            stale.close()
            stale.unlink()
        except FileNotFoundError:
            pass
        shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        ch = cls(shm, slots, slab_bytes, owner=True)
        ch.reset()
        return ch

    @classmethod
    def attach(cls, name: str, slots: int,
               slab_bytes: int) -> "WorkerChannel":
        shm = _attach_untracked(name)
        return cls(shm, slots, _align(slab_bytes), owner=False)

    def reset(self) -> None:
        """Engine-side, with NO worker attached (before a spawn/respawn):
        forget every in-flight record of the previous epoch."""
        self._hdr[:] = 0
        self._free = list(range(self.slots))

    def close(self) -> None:
        # drop our own numpy views before closing the mmap; popped
        # records may still hold theirs — _quiet_close handles those
        self._hdr = self._sub = self._comp = None
        self._slabs = []
        _quiet_close(self._shm)
        if self._owner:
            try:
                self._shm.unlink()
            except Exception:
                pass

    # ------------------------------------------------------- worker producer

    def free_slots(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        """A free slab index, or None when every slab is in flight (the
        ring-full condition: the caller sheds in-band, shed_reason
        ring_full)."""
        if not self._free:
            return None
        return self._free.pop()

    def unalloc(self, slot: int) -> None:
        """Return a slot that was alloc()ed but never submitted."""
        self._free.append(slot)

    def slab(self, slot: int) -> np.ndarray:
        return self._slabs[slot]

    def cols_views(self, slot: int):
        """The slab's fixed-layout column buffers for frontdoor_parse_req
        to write into directly (key_bytes, key_ends, hits, limits,
        durations, algos, name_lens)."""
        buf = self._shm.buf
        base = self._pool_off + slot * self.slab_bytes
        c = self.cap_items
        return (
            np.frombuffer(buf, np.uint8, self.key_cap, base + self._key_off),
            np.frombuffer(buf, np.int64, c, base + self._ke_off),
            np.frombuffer(buf, np.int64, c, base + self._hi_off),
            np.frombuffer(buf, np.int64, c, base + self._li_off),
            np.frombuffer(buf, np.int64, c, base + self._du_off),
            np.frombuffer(buf, np.int32, c, base + self._al_off),
            np.frombuffer(buf, np.int32, c, base + self._nl_off),
        )

    def counts_view(self, slot: int) -> np.ndarray:
        """The slab's per-RPC counts region (KIND_BATCH_COLS item counts
        on the way in; bytes-form completion lengths on the way back)."""
        buf = self._shm.buf
        base = self._pool_off + slot * self.slab_bytes
        return np.frombuffer(buf, np.int64, MAX_BATCH_RPCS,
                             base + self._cnt_off)

    def resp_views(self, slot: int):
        """The slab's DECISION columns for a columnar completion:
        (status, limit, remaining, reset int64[c], flags int32[c]).
        Written by the engine's complete_cols, read (and encoded) by the
        worker before the slot is freed; laid over the request columns,
        which are consumed by then."""
        buf = self._shm.buf
        base = self._pool_off + slot * self.slab_bytes
        c = self.cap_items
        return (
            np.frombuffer(buf, np.int64, c, base + self._ke_off),
            np.frombuffer(buf, np.int64, c, base + self._hi_off),
            np.frombuffer(buf, np.int64, c, base + self._li_off),
            np.frombuffer(buf, np.int64, c, base + self._du_off),
            np.frombuffer(buf, np.int32, c, base + self._al_off),
        )

    def _trace_view(self, slot: int) -> np.ndarray:
        buf = self._shm.buf
        base = self._pool_off + slot * self.slab_bytes
        return np.frombuffer(buf, np.uint64, 4, base + self._tr_off)

    def set_trace(self, slot: int, hi: int, lo: int, span: int) -> None:
        """Stamp the record's propagated traceparent (worker side, before
        commit): 128-bit trace id as two u64 halves + the caller's span id."""
        tv = self._trace_view(slot)
        tv[0] = np.uint64(hi)
        tv[1] = np.uint64(lo)
        tv[2] = np.uint64(span)
        tv[3] = np.uint64(1)

    def clear_trace(self, slot: int) -> None:
        """Mark the record as carrying no trace (slabs are reused, so a
        commit without a traceparent must erase the previous tenant's)."""
        self._trace_view(slot)[3] = np.uint64(0)

    def _slab_hdr(self, slot: int) -> np.ndarray:
        buf = self._shm.buf
        return np.frombuffer(buf, np.int64, 8,
                             self._pool_off + slot * self.slab_bytes)

    def write_raw(self, slot: int, kind: int, req_id: int, payload: bytes,
                  deadline: float = 0.0) -> bool:
        """A RAW record: the original request bytes, shipped verbatim.
        False when the payload cannot fit the slab."""
        if len(payload) > self.slab_bytes - _REC_HDR:
            return False
        hdr = self._slab_hdr(slot)
        hdr[0] = kind
        hdr[1] = req_id
        hdr[2] = len(payload)
        hdr[3] = 0
        hdr[4] = 0
        hdr[5] = np.float64(deadline).view(np.int64)
        self._slabs[slot][_REC_HDR:_REC_HDR + len(payload)] = \
            np.frombuffer(payload, np.uint8)
        return True

    def commit_cols(self, slot: int, req_id: int, n: int, key_len: int,
                    deadline: float = 0.0) -> None:
        """Header for a COLS record whose columns frontdoor_parse_req
        already wrote into cols_views(slot)."""
        hdr = self._slab_hdr(slot)
        hdr[0] = KIND_COLS
        hdr[1] = req_id
        hdr[2] = n
        hdr[3] = key_len
        hdr[4] = 0
        hdr[5] = np.float64(deadline).view(np.int64)

    def commit_batch(self, slot: int, req_id: int, counts: List[int],
                     key_len: int, deadline: float = 0.0) -> None:
        """Header for a KIND_BATCH_COLS record: len(counts) coalesced
        RPCs whose concatenated columns frontdoor_parse_req wrote into
        cols_views(slot) (key_ends rebased by the caller); counts[j] is
        RPC j's item count."""
        m = len(counts)
        self.counts_view(slot)[:m] = counts
        hdr = self._slab_hdr(slot)
        hdr[0] = KIND_BATCH_COLS
        hdr[1] = req_id
        hdr[2] = int(sum(counts))
        hdr[3] = key_len
        hdr[4] = m
        hdr[5] = np.float64(deadline).view(np.int64)

    def submit(self, slot: int) -> None:
        """Publish a written record (cannot overflow: the ring holds as
        many entries as there are slabs)."""
        tail = int(self._hdr[_SUB_TAIL])
        self._sub[tail % self.slots] = slot
        self._hdr[_SUB_TAIL] = tail + 1  # publish AFTER payload + entry

    def poll_completions(self) -> List[Tuple[int, int, int, bytes]]:
        """Drain ready completions: [(req_id, status, code_payload...)].
        Returns (req_id, status, payload) tuples; the slab is freed here,
        so callers must take their bytes copy (we do)."""
        out = []
        head = int(self._hdr[_COMP_HEAD])
        tail = int(self._hdr[_COMP_TAIL])
        while head < tail:
            e = (head % self.slots) * 4
            slot = int(self._comp[e])
            req_id = int(self._comp[e + 1])
            status = int(self._comp[e + 2])
            length = int(self._comp[e + 3])
            payload = bytes(self._slabs[slot][:length])
            self._free.append(slot)
            head += 1
            out.append((req_id, status, payload))
        if out:
            self._hdr[_COMP_HEAD] = head
        return out

    def poll_completions_raw(self) -> List[Tuple[int, int, int, int]]:
        """Drain ready completion ENTRIES without freeing the slabs:
        [(slot, req_id, status, length)].  length < 0 marks a columnar
        completion of n = -length decisions at resp_views(slot); the
        caller encodes (worker-side response encode) while it still owns
        the slab, then free_slot()s it."""
        out = []
        head = int(self._hdr[_COMP_HEAD])
        tail = int(self._hdr[_COMP_TAIL])
        while head < tail:
            e = (head % self.slots) * 4
            out.append((int(self._comp[e]), int(self._comp[e + 1]),
                        int(self._comp[e + 2]), int(self._comp[e + 3])))
            head += 1
        if out:
            self._hdr[_COMP_HEAD] = head
        return out

    def free_slot(self, slot: int) -> None:
        """Return a completed slab to the free list (worker side), after
        the response bytes/columns have been consumed."""
        self._free.append(slot)

    # ------------------------------------------------------- engine consumer

    def sub_depth(self) -> int:
        """Published-but-unconsumed submissions (ring depth gauge)."""
        return int(self._hdr[_SUB_TAIL]) - int(self._hdr[_SUB_HEAD])

    def inflight(self) -> int:
        """Records the engine consumed but has not completed yet."""
        return int(self._hdr[_SUB_HEAD]) - int(self._hdr[_COMP_TAIL])

    def pop(self, max_n: int = 64) -> List["ShmRecord"]:
        """Consume up to max_n published records (engine consumer thread).
        The slot stays owned by the engine until complete(slot, ...)."""
        out = []
        head = int(self._hdr[_SUB_HEAD])
        tail = int(self._hdr[_SUB_TAIL])
        while head < tail and len(out) < max_n:
            slot = int(self._sub[head % self.slots])
            hdr = self._slab_hdr(slot)
            kind = int(hdr[0])
            rec = ShmRecord(
                slot=slot, kind=kind, req_id=int(hdr[1]),
                deadline=float(np.int64(hdr[5]).view(np.float64)))
            if kind in (KIND_COLS, KIND_BATCH_COLS):
                n = int(hdr[2])
                key_len = int(hdr[3])
                kb, ke, hi, li, du, al, nl = self.cols_views(slot)
                rec.cols = (kb[:key_len], ke[:n], hi[:n], li[:n], du[:n],
                            al[:n])
                rec.name_lens = nl[:n]
                rec.n = n
                if kind == KIND_BATCH_COLS:
                    m = int(hdr[4])
                    rec.counts = [int(x) for x in self.counts_view(slot)[:m]]
                tv = self._trace_view(slot)
                if int(tv[3]) & 1:
                    rec.trace = (int(tv[0]), int(tv[1]), int(tv[2]))
            else:
                rec.payload = bytes(self._slabs[slot][
                    _REC_HDR:_REC_HDR + int(hdr[2])])
            head += 1
            out.append(rec)
        if out:
            self._hdr[_SUB_HEAD] = head
        return out

    def complete(self, slot: int, req_id: int, status: int,
                 payload: bytes) -> None:
        """Write the response over the record's slab and publish the
        completion (engine side).  Oversized OK payloads degrade to an
        in-band RESOURCE_EXHAUSTED so the worker always gets an answer."""
        if len(payload) > self.slab_bytes:
            status, payload = 8, b"response exceeds shm slab"  # RESOURCE_EXHAUSTED
        self._slabs[slot][:len(payload)] = np.frombuffer(payload, np.uint8)
        tail = int(self._hdr[_COMP_TAIL])
        e = (tail % self.slots) * 4
        self._comp[e] = slot
        self._comp[e + 1] = req_id
        self._comp[e + 2] = status
        self._comp[e + 3] = len(payload)
        self._hdr[_COMP_TAIL] = tail + 1  # publish last

    def complete_cols(self, slot: int, req_id: int, status, limit,
                      remaining, reset, flags=None) -> None:
        """Columnar completion: write the DECISION columns into the slab
        and publish length = -n — the worker encodes the protobuf in its
        own process (native frontdoor_encode_resp or the pb fallback).
        For KIND_BATCH_COLS records the request's counts region still
        holds the per-RPC split.  flags is None (all plain) or an int32
        column of SHED_REASON_CODES values."""
        n = len(status)
        st, li, re, rs, fl = self.resp_views(slot)
        st[:n] = status
        li[:n] = limit
        re[:n] = remaining
        rs[:n] = reset
        fl[:n] = 0 if flags is None else flags
        tail = int(self._hdr[_COMP_TAIL])
        e = (tail % self.slots) * 4
        self._comp[e] = slot
        self._comp[e + 1] = req_id
        self._comp[e + 2] = STATUS_OK
        self._comp[e + 3] = -n
        self._hdr[_COMP_TAIL] = tail + 1  # publish last

    def complete_batch_bytes(self, slot: int, req_id: int,
                             parts: List[bytes]) -> None:
        """Bytes-form completion of a KIND_BATCH_COLS record (the rare
        fallback when a sub-response cannot be expressed as columns):
        per-RPC serialized responses concatenated after the counts
        region, with the split lengths written over it.  Oversized
        payloads degrade like complete()."""
        total = sum(len(p) for p in parts)
        if total > self.slab_bytes - self._ke_off:
            self.complete(slot, req_id, 8, b"response exceeds shm slab")
            return
        cnt = self.counts_view(slot)
        off = self._ke_off
        slab = self._slabs[slot]
        for j, p in enumerate(parts):
            cnt[j] = len(p)
            slab[off:off + len(p)] = np.frombuffer(p, np.uint8)
            off += len(p)
        tail = int(self._hdr[_COMP_TAIL])
        e = (tail % self.slots) * 4
        self._comp[e] = slot
        self._comp[e + 1] = req_id
        self._comp[e + 2] = STATUS_OK
        self._comp[e + 3] = total
        self._hdr[_COMP_TAIL] = tail + 1  # publish last

    def batch_payload(self, slot: int, m: int, total: int):
        """Worker-side read of a bytes-form batch completion: the per-RPC
        lengths and a view of the concatenated payload."""
        lengths = [int(x) for x in self.counts_view(slot)[:m]]
        return lengths, self._slabs[slot][self._ke_off:self._ke_off + total]


# ---------------------------------------------------------------- status block

FLAG_DRAINING = 1 << 0    # engine entering shutdown: workers shed in-band
FLAG_SATURATED = 1 << 1   # engine admission saturated: workers shed in-band
FLAG_COLS_OK = 1 << 2     # engine accepts KIND_COLS (standalone + compact)

_MSG_CAP = 256
_W_ROW0 = 16              # per-worker rows start at this int64 index
_W_STRIDE = 13
# per-worker row fields; single writer per FIELD: the engine owns pid /
# epoch / restarts, the worker owns port / rpcs / sheds / healthchecks /
# stalls / encodes / enc_fallbacks / batch_rpcs / batch_flushes /
# trace_drops
W_PID = 0
W_PORT = 1
W_EPOCH = 2
W_RESTARTS = 3
W_RPCS = 4
W_SHEDS = 5
W_HEALTHCHECKS = 6
W_STALLS = 7
W_ENCODES = 8        # responses the worker encoded from decision columns
W_ENC_FALLBACK = 9   # completions that arrived as engine-encoded bytes
W_BATCH_RPCS = 10    # RPCs that rode a coalesced KIND_BATCH_COLS record
W_BATCH_FLUSHES = 11  # multi-RPC batch publishes (single ring entries)
W_TRACE_DROPS = 12   # traceparents the shm lane could NOT propagate (RAW
#                      fallback records, non-first members of a coalesced
#                      batch — one record carries one trace region)


class FrontdoorStatus:
    """A tiny engine-owned shm block that lets the workers answer
    HealthCheck locally (health never queues behind a saturated engine
    loop) and pick up the shared
    draining/saturation shed signals without a round-trip.  Every int64
    field has exactly one writer, so plain aligned stores suffice."""

    def __init__(self, shm: shared_memory.SharedMemory, workers: int,
                 owner: bool):
        self._shm = shm
        self._owner = owner
        self.workers = workers
        self._i = np.frombuffer(shm.buf, np.int64,
                                _W_ROW0 + workers * _W_STRIDE, 0)
        self._msg = np.frombuffer(
            shm.buf, np.uint8, _MSG_CAP,
            (_W_ROW0 + workers * _W_STRIDE) * 8)

    @staticmethod
    def segment_size(workers: int) -> int:
        return (_W_ROW0 + workers * _W_STRIDE) * 8 + _MSG_CAP

    @classmethod
    def create(cls, name: str, workers: int) -> "FrontdoorStatus":
        try:
            stale = shared_memory.SharedMemory(name=name)
            stale.close()
            stale.unlink()
        except FileNotFoundError:
            pass
        shm = shared_memory.SharedMemory(
            name=name, create=True, size=cls.segment_size(workers))
        st = cls(shm, workers, owner=True)
        st._i[:] = 0
        st._msg[:] = 0
        return st

    @classmethod
    def attach(cls, name: str, workers: int) -> "FrontdoorStatus":
        shm = _attach_untracked(name)
        return cls(shm, workers, owner=False)

    def close(self) -> None:
        self._i = self._msg = None
        _quiet_close(self._shm)
        if self._owner:
            try:
                self._shm.unlink()
            except Exception:
                pass

    # engine-written fields: [0] flags, [1] health status, [2] peer count,
    # [3] heartbeat (monotonic seconds bits), [4] health message length
    def set_flag(self, flag: int, on: bool) -> None:
        f = int(self._i[0])
        self._i[0] = (f | flag) if on else (f & ~flag)

    def flag(self, flag: int) -> bool:
        return bool(int(self._i[0]) & flag)

    def set_health(self, status: int, message: str, peer_count: int) -> None:
        raw = message.encode()[:_MSG_CAP]
        self._msg[:len(raw)] = np.frombuffer(raw, np.uint8)
        self._i[1] = status
        self._i[2] = peer_count
        self._i[4] = len(raw)

    def health(self) -> Tuple[int, str, int]:
        ln = int(self._i[4])
        return (int(self._i[1]),
                bytes(self._msg[:ln]).decode("utf-8", "replace"),
                int(self._i[2]))

    def beat(self) -> None:
        self._i[3] = np.float64(time.monotonic()).view(np.int64)

    def heartbeat_age(self) -> float:
        return time.monotonic() - float(np.int64(self._i[3]).view(np.float64))

    # per-worker row accessors
    def set_w(self, worker: int, field: int, value: int) -> None:
        self._i[_W_ROW0 + worker * _W_STRIDE + field] = value

    def get_w(self, worker: int, field: int) -> int:
        return int(self._i[_W_ROW0 + worker * _W_STRIDE + field])

    def bump_w(self, worker: int, field: int, n: int = 1) -> None:
        self._i[_W_ROW0 + worker * _W_STRIDE + field] += n
