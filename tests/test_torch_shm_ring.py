"""The front door's shared-memory records, parsers and encoders: the port
(gubernator_tpu_torch/core/shm_ring.py, native/, core/pipeline.py
ColsJob) against the JAX package.

  * a record written through one package's WorkerChannel reads the same
    through the other's, for every record kind and completion form, and
    the two packages lay the same records out byte for byte;
  * ColsJob.finish(want_cols) decodes the words as ListJob.finish does,
    synthesized positions and leaky reset-0 included;
  * frontdoor_parse_req (the port's, the JAX library's) and the router's
    fastpath_parse_stack accept and refuse the same wire bytes, with the
    columns protobuf reads;
  * frontdoor_encode_resp equals the protobuf encode;
  * the replay worker (frontdoor_replay.py) counts only the decisions
    answered: no shed item and no failed call.
"""

import asyncio
import itertools
import os

import numpy as np
import pytest

from gubernator_tpu import native as jnative
from gubernator_tpu.core import shm_ring as jring
from gubernator_tpu_torch import native
from gubernator_tpu_torch.api import pb, types
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
    RateLimitResp,
)
from gubernator_tpu_torch.core import shm_ring
from gubernator_tpu_torch.core.pipeline import (
    ColsJob,
    ListJob,
    requests_from_cols,
)
from gubernator_tpu_torch.core.window_buffers import WindowArena
from gubernator_tpu_torch.ops import kernel

pytestmark = pytest.mark.torch_port

SLOTS = 8
SLAB = 1 << 16
_SEQ = itertools.count()


def _name(tag):
    return f"gts{os.getpid()}x{next(_SEQ)}{tag}"


@pytest.fixture
def pair():
    """A segment created by the port, attached by the JAX package."""
    name = _name("p")
    owner = shm_ring.WorkerChannel.create(name, SLOTS, SLAB)
    other = jring.WorkerChannel.attach(name, SLOTS, SLAB)
    yield owner, other
    other.close()
    owner.close()


def test_module_constants_equal_the_jax_module():
    names = [n for n in dir(jring) if n.isupper()
             and isinstance(getattr(jring, n), (int, dict))]
    assert len(names) > 25
    for n in names:
        assert getattr(shm_ring, n) == getattr(jring, n), n
    assert (shm_ring.WorkerChannel.segment_size(64, SLAB)
            == jring.WorkerChannel.segment_size(64, SLAB))
    assert (shm_ring.FrontdoorStatus.segment_size(3)
            == jring.FrontdoorStatus.segment_size(3))


RAW_KINDS = (shm_ring.KIND_RAW, shm_ring.KIND_PEER_RL, shm_ring.KIND_TRANSFER,
             shm_ring.KIND_REGISTER, shm_ring.KIND_APPLY_GREG,
             shm_ring.KIND_UPDATE_GLOBALS)


def _write_cols(ch, slot, rng, n, batch):
    kb, ke, hi, li, du, al, nl = ch.cols_views(slot)
    keys = rng.integers(97, 123, 7 * n).astype(np.uint8)
    kb[:len(keys)] = keys
    ke[:n] = np.arange(1, n + 1) * 7
    hi[:n] = rng.integers(0, 9, n)
    li[:n] = rng.integers(0, 1 << 40, n)
    du[:n] = rng.integers(0, 1 << 30, n)
    al[:n] = rng.integers(0, 2, n)
    nl[:n] = 3
    if batch:
        ch.commit_batch(slot, 40 + slot, [n - 2, 2], 7 * n, deadline=12.5)
        ch.set_trace(slot, 1 << 63, 5, 77)
    else:
        ch.commit_cols(slot, 40 + slot, n, 7 * n, deadline=3.25)
        ch.clear_trace(slot)


def _records(write, read, rng):
    """Every kind written through `write`, popped through `read`."""
    for slot, kind in enumerate(RAW_KINDS):
        payload = bytes(rng.integers(0, 256, 100 + slot).astype(np.uint8))
        s = write.alloc()
        assert write.write_raw(s, kind, 7 + slot, payload, deadline=1.5)
        write.submit(s)
    for batch in (False, True):
        s = write.alloc()
        _write_cols(write, s, rng, 9, batch)
        write.submit(s)
    assert read.sub_depth() == len(RAW_KINDS) + 2
    return read.pop()


def _summary(rec):
    out = [rec.slot, rec.kind, rec.req_id, rec.deadline, rec.n,
           bytes(rec.payload), rec.counts, rec.trace]
    if rec.cols is not None:
        out += [bytes(c) for c in rec.cols] + [bytes(rec.name_lens)]
    return out


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_every_record_kind_reads_the_same_across_packages(pair, direction):
    port, jax_ = pair
    write, read = (port, jax_) if direction == "port_to_jax" else (jax_, port)
    rng = np.random.default_rng(3)
    got = _records(write, read, rng)
    assert [r.kind for r in got] == list(RAW_KINDS) + [
        shm_ring.KIND_COLS, shm_ring.KIND_BATCH_COLS]
    # the same records, written and read by the writer's own package
    own = type(write).create(_name("o"), SLOTS, SLAB)
    try:
        same = _records(own, own, np.random.default_rng(3))
        assert [_summary(a) for a in got] == [_summary(b) for b in same]
    finally:
        own.close()
    assert got[-1].counts == [7, 2] and got[-1].trace == (1 << 63, 5, 77)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_completions_read_the_same_across_packages(pair, direction):
    """complete, complete_cols and complete_batch_bytes written by one
    package's engine side, consumed by the other's worker side."""
    port, jax_ = pair
    eng, wrk = (port, jax_) if direction == "port_to_jax" else (jax_, port)
    slots = [wrk.alloc() for _ in range(4)]
    eng.complete(slots[0], 1, 0, b"\x0a\x02\x08\x01")
    eng.complete(slots[1], 2, 8, b"too big")
    st = np.array([0, 1, 1], np.int64)
    li = np.array([5, 6, 7], np.int64)
    re_ = np.array([4, 0, 0], np.int64)
    rs = np.array([10, 11, 0], np.int64)
    fl = np.array([0, 0, 5], np.int32)
    eng.complete_cols(slots[2], 3, st, li, re_, rs, fl)
    wrk.counts_view(slots[3])[:2] = [1, 2]
    eng.complete_batch_bytes(slots[3], 4, [b"ab", b"cde"])
    comps = wrk.poll_completions_raw()
    assert [(c[1], c[2], c[3]) for c in comps] == [
        (1, 0, 4), (2, 8, 7), (3, 0, -3), (4, 0, 5)]
    assert bytes(wrk.slab(slots[0])[:4]) == b"\x0a\x02\x08\x01"
    cols = wrk.resp_views(slots[2])
    for got, want in zip(cols, (st, li, re_, rs, fl)):
        assert list(got[:3]) == list(want)
    lengths, view = wrk.batch_payload(slots[3], 2, 5)
    assert lengths == [2, 3] and bytes(view) == b"abcde"


def test_the_two_packages_lay_records_out_byte_for_byte():
    """The same records and completions, written by each package into a
    segment of its own: the segments are equal byte for byte."""
    segs = []
    for mod in (shm_ring, jring):
        ch = mod.WorkerChannel.create(_name("b"), SLOTS, SLAB)
        rng = np.random.default_rng(11)
        recs = _records(ch, ch, rng)
        for rec in recs[:2]:
            ch.complete(rec.slot, rec.req_id, 0, b"resp")
        n = 3
        ch.complete_cols(recs[-1].slot, recs[-1].req_id,
                         *(np.arange(n, dtype=np.int64) + k
                           for k in range(4)), np.zeros(n, np.int32))
        segs.append(bytes(ch._shm.buf))
        ch.close()
    assert segs[0] == segs[1]


def test_status_block_reads_the_same_across_packages():
    name = _name("s")
    st = shm_ring.FrontdoorStatus.create(name, 3)
    jst = jring.FrontdoorStatus.attach(name, 3)
    try:
        st.set_flag(shm_ring.FLAG_COLS_OK, True)
        st.set_health(1, "draining: node is departing", 4)
        st.beat()
        jst.bump_w(2, shm_ring.W_ENCODES, 5)
        jst.set_w(1, shm_ring.W_PORT, 4242)
        assert jst.flag(jring.FLAG_COLS_OK)
        assert not jst.flag(jring.FLAG_DRAINING)
        assert jst.health() == (1, "draining: node is departing", 4)
        assert jst.heartbeat_age() < 5.0
        assert st.get_w(2, shm_ring.W_ENCODES) == 5
        assert st.get_w(1, shm_ring.W_PORT) == 4242
    finally:
        jst.close()
        st.close()


def test_close_unlinks_the_segment_and_tolerates_live_views():
    name = _name("c")
    ch = shm_ring.WorkerChannel.create(name, SLOTS, SLAB)
    s = ch.alloc()
    ch.cols_views(s)[1][:1] = 7
    ch.commit_cols(s, 1, 1, 7)
    ch.submit(s)
    rec = ch.pop()[0]  # keeps zero-copy views into the mapping
    ch.close()
    assert int(rec.cols[1][0]) == 7
    assert not os.path.exists(f"/dev/shm/{name}")


# ----------------------------------------------------- ColsJob.finish


def _words(rng, rows, B, n):
    """Random response words and per-item (row, lane, pos): pos -1 for a
    plain item, else a synthesized position (bits 0-29) with the leaky
    bit (30) set on some."""
    w = rng.integers(0, 1 << 62, (rows, B), dtype=np.int64)
    # a share of words with enc == 0 (reset 0)
    w[rng.random((rows, B)) < 0.2] &= 0xFFFFFFFF
    row = rng.integers(0, rows, n).astype(np.int32)
    lane = rng.integers(0, B, n).astype(np.int32)
    pos = np.where(rng.random(n) < 0.5, -1,
                   rng.integers(0, 40, n)
                   | (rng.integers(0, 2, n) << 30)).astype(np.int32)
    return w, row, lane, pos


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mismatch", [False, True])
def test_cols_job_decision_columns_equal_list_job_decode(seed, mismatch):
    rng = np.random.default_rng(seed)
    n, B = 200, 64
    w, row, lane, pos = _words(rng, 6, B, n)
    limits = rng.integers(0, 1 << 40, n).astype(np.int64)
    clflat = (rng.integers(0, 1 << 40, (6, B)).astype(np.int64)
              if mismatch else None)
    now = 1_700_000_000_123
    cols = (np.zeros(0, np.uint8), np.zeros(n, np.int64),
            np.ones(n, np.int64), limits, np.ones(n, np.int64),
            np.zeros(n, np.int32))
    cj = ColsJob(cols, np.zeros(n, np.int32), n, None, want_cols=True)
    lj = ListJob([RateLimitReq(name="a", unique_key="b")] * n)
    lj._cols = cols
    for job in (cj, lj):
        job.row, job.lane, job.pos = row, lane, pos
    st, li, re_, rs = cj.finish(None, w, clflat, now)
    want = lj.finish(w, clflat, now)
    assert [(int(a), int(b), int(c), int(d))
            for a, b, c, d in zip(st, li, re_, rs)] == [
        (int(r.status), r.limit, r.remaining, r.reset_time) for r in want]
    assert all(c.dtype == np.int64 for c in (st, li, re_, rs))
    # the limit column is a copy: the slab it came from is overwritten by
    # the completion
    li[:] = -1
    assert (limits >= 0).all()
    # the synthesized leaky case: under its run, reset 0
    leaky = (pos >= 0) & ((pos >> 30) & 1 == 1) & (
        (pos & 0x3FFFFFFF) < (w[row, lane] & 0x7FFFFFFF))
    if leaky.any():
        assert (rs[leaky] == 0).all()


def _cols_of(reqs):
    """frontdoor_parse_req's columns of a request list, as a record."""
    c = _cols_buffers(1000)
    n = native.frontdoor_parse_req(_encode(reqs), *c, 1000)
    assert n == len(reqs)
    kb, ke, hi, li, du, al, nl = c
    return (kb[:int(ke[n - 1])], ke[:n], hi[:n], li[:n], du[:n],
            al[:n]), nl[:n], n


def _instance(B=64, S=2):
    from gubernator_tpu_torch.config import EngineConfig
    from gubernator_tpu_torch.core.service import Instance
    inst = Instance(engine_config=EngineConfig(
        capacity_per_shard=1024, batch_per_shard=B, num_shards=S),
        device="cpu")
    inst.batcher.now_fn = lambda: 1_800_000_000_000
    inst.batcher.pipeline.now_fn = lambda: 1_800_000_000_000
    return inst


@pytest.mark.parametrize("want_cols", [True, False])
def test_cols_lane_answers_as_the_list_lane(want_cols):
    """submit_cols (the column lane) against submit_many (a ListJob) on a
    twin Instance, over rounds of one batch with hot keys, every compact
    algorithm: the decision columns equal the list lane's responses, and
    the bytes form equals the C encode of the same decisions."""
    rng = np.random.default_rng(9)
    reqs = [RateLimitReq(name="c", unique_key=f"k{int(i)}", limit=5,
                         hits=int(rng.integers(0, 3)), duration=60_000,
                         algorithm=int(i) % 4)
            for i in rng.integers(0, 40, 300)]
    cols, nl, n = _cols_of(reqs)
    a, b = _instance(), _instance()

    async def body():
        out = []
        for _ in range(3):
            got = await a.batcher.submit_cols(cols, nl, n,
                                              want_cols=want_cols)
            want = await b.batcher.pipeline.submit_many(reqs)
            out.append((got, want))
        return out

    try:
        rounds = asyncio.run(body())
    finally:
        a.close()
        b.close()
    for got, want in rounds:
        rows = [(int(r.status), r.limit, r.remaining, r.reset_time)
                for r in want]
        if want_cols:
            assert [tuple(int(c[i]) for c in got)
                    for i in range(n)] == rows
        else:
            assert got == pb.GetRateLimitsResp(responses=[
                pb.resp_to_pb(r) for r in want]).SerializeToString()


def test_cols_job_no_stack_takes_runs_through_engine_process():
    """A column record larger than an empty stack holds (S = 1, B = 16,
    K = 8: 128 lanes, 300 distinct keys) runs through engine.process in
    its turn and resolves to the response list, equal to a twin's
    engine.process; a closed lane or ring peers give None."""
    reqs = [RateLimitReq(name="big", unique_key=f"u{i}", limit=9, hits=1,
                         duration=60_000) for i in range(300)]
    cols, nl, n = _cols_of(reqs)
    a, b = _instance(B=16, S=1), _instance(B=16, S=1)

    async def body():
        got = await a.batcher.submit_cols(cols, nl, n, want_cols=True)
        want = b.engine.process(reqs, 1_800_000_000_000)
        a.batcher.pipeline.rpc_enabled = False
        closed = await a.batcher.submit_cols(cols, nl, n)
        a.batcher.pipeline.rpc_enabled = True
        a.batcher.pipeline._ring_peers = ("peer",)
        ringed = await a.batcher.submit_cols(cols, nl, n)
        a.batcher.pipeline._ring_peers = ()
        return got, want, closed, ringed

    try:
        got, want, closed, ringed = asyncio.run(body())
    finally:
        a.close()
        b.close()
    assert isinstance(got, list) and got == want
    assert closed is None and ringed is None


def test_requests_from_cols_rebuild_the_parsed_requests():
    reqs = [RateLimitReq(name=f"n_{i}", unique_key=f"u_{i}é", hits=i,
                         limit=100 + i, duration=1000 * i, algorithm=i % 2)
            for i in range(1, 30)]
    data = _encode(reqs)
    c = _cols_buffers(64)
    n = native.frontdoor_parse_req(data, *c, 64)
    assert n == len(reqs)
    kb, ke, hi, li, du, al, nl = c
    cols = (kb[:int(ke[n - 1])], ke[:n], hi[:n], li[:n], du[:n], al[:n])
    assert requests_from_cols(cols, nl[:n], n) == reqs


# ------------------------------------------------------------ parsers


def _encode(reqs):
    return pb.GetRateLimitsReq(
        requests=[pb.req_to_pb(r) for r in reqs]).SerializeToString()


def _cols_buffers(cap, key_cap=1 << 16):
    return (np.zeros(key_cap, np.uint8), np.zeros(cap, np.int64),
            np.zeros(cap, np.int64), np.zeros(cap, np.int64),
            np.zeros(cap, np.int64), np.zeros(cap, np.int32),
            np.zeros(cap, np.int32))


def _random_req(rng, bad=False):
    """A request the lane takes (any of the four compact algorithms), or
    with `bad` one it refuses."""
    r = RateLimitReq(
        name=rng.choice(["a", "tenant", "n" * 40, "é"]),
        unique_key=f"k{int(rng.integers(0, 1 << 20))}",
        hits=int(rng.choice([0, 1, 1, 2, 7])),
        limit=int(rng.integers(0, 5000)),
        duration=int(rng.choice([1000, 60_000, 3_600_000])),
        algorithm=int(rng.integers(0, 4)))
    if bad:
        k = int(rng.integers(0, 8))
        if k == 0:
            r.behavior = Behavior.GLOBAL
        elif k == 1:
            r.algorithm = Algorithm.CONCURRENCY
        elif k == 2:
            r.limit = kernel.COMPACT_MAX_LIMIT
        elif k == 3:
            r.hits = -1
        elif k == 4:
            r.name = ""
        elif k == 5:
            r.duration = kernel.COMPACT_MAX_DURATION
        elif k == 6:
            r.behavior = Behavior.NO_BATCHING
        else:
            r.unique_key = ""
    return r


def _mutate(rng, data):
    roll = rng.random()
    if roll < 0.1 and data:
        return data[:int(rng.integers(0, len(data)))]
    if roll < 0.2 and data:
        b = bytearray(data)
        b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        return bytes(b)
    if roll < 0.25:
        return data + b"\x48\x01"  # an unknown varint field
    return data


@pytest.fixture(scope="module")
def router_stack():
    """A port router and an arena for fastpath_parse_stack (every item
    local; each parse aborted so nothing stays staged)."""
    if not (native.available() and jnative.available()):
        pytest.skip("the native router library does not build here")
    r = native.NativeRouter(2, 1 << 14)
    arena = WindowArena(8, 2, 1024)
    return r, arena


def _fastpath(router_stack, data):
    r, arena = router_stack
    arena.recycle()
    arena.fills[:] = 0
    arena.kcur[:] = 0
    r.drain_begin()
    scr = arena.acquire_scratch()
    n = r.parse_stack_fast(data, 1_000, 1024, 8, 1000, arena, scr,
                           use_ring=False)
    r.abort()
    return n


@pytest.mark.parametrize("seed", range(6))
def test_parser_parity_fuzz(router_stack, seed):
    """frontdoor_parse_req of the port, of the JAX library and the
    router's fastpath_parse_stack over random wire bytes: the same
    verdicts, the same counts, and accepted columns equal to what
    protobuf reads."""
    rng = np.random.default_rng(100 + seed)
    accepted = refused = 0
    for case in range(60):
        reqs = [_random_req(rng) for _ in range(int(rng.integers(0, 40)))]
        if rng.random() < 0.3:
            reqs.insert(int(rng.integers(0, len(reqs) + 1)),
                        _random_req(rng, bad=True))
        if case % 20 == 19:
            reqs = [_random_req(rng) for _ in range(1001)]
        data = _mutate(rng, _encode(reqs))
        pc, jc = _cols_buffers(1000), _cols_buffers(1000)
        n_p = native.frontdoor_parse_req(data, *pc, 1000)
        n_j = jnative.frontdoor_parse_req(data, *jc, 1000)
        n_f = _fastpath(router_stack, data)
        assert n_p == n_j, case
        assert (n_p >= 0) == (n_f >= 0), (case, n_p, n_f)
        if n_p < 0:
            refused += 1
            continue
        accepted += 1
        assert n_f == n_p
        kend = int(pc[1][n_p - 1]) if n_p else 0
        assert bytes(pc[0][:kend]) == bytes(jc[0][:kend])
        for a, b in zip(pc[1:], jc[1:]):
            assert list(a[:n_p]) == list(b[:n_p])
        try:
            msg = pb.GetRateLimitsReq.FromString(data)
        except Exception:
            # bytes protobuf refuses that the C parsers take (a mutated
            # string that is not UTF-8): both lanes answer them alike
            continue
        got = requests_from_cols(
            (pc[0][:kend],) + tuple(c[:n_p] for c in pc[1:6]), pc[6],
            n_p)
        assert got == [pb.req_from_pb(m) for m in msg.requests]
    assert accepted > 20 and refused > 10


def test_parser_refuses_what_needs_the_full_path():
    base = dict(name="a", unique_key="k", hits=1, limit=10, duration=1000)
    for algo in (Algorithm.TOKEN_BUCKET, Algorithm.LEAKY_BUCKET,
                 Algorithm.GCRA, Algorithm.SLIDING_WINDOW):
        data = _encode([RateLimitReq(**base, algorithm=algo)])
        assert native.frontdoor_parse_req(data, *_cols_buffers(8), 8) == 1
    cases = [dict(behavior=Behavior.GLOBAL),
             dict(behavior=Behavior.NO_BATCHING),
             dict(algorithm=Algorithm.CONCURRENCY),
             dict(name=""), dict(unique_key=""), dict(hits=-1),
             dict(limit=kernel.COMPACT_MAX_LIMIT),
             dict(duration=kernel.COMPACT_MAX_DURATION)]
    for kw in cases:
        data = _encode([RateLimitReq(**{**base, **kw})])
        assert native.frontdoor_parse_req(data, *_cols_buffers(8), 8) < 0, kw
        assert jnative.frontdoor_parse_req(data, *_cols_buffers(8), 8) < 0
    assert native.frontdoor_parse_req(
        _encode([RateLimitReq(**base)] * 9), *_cols_buffers(8), 8) == -3
    assert native.frontdoor_parse_req(
        _encode([RateLimitReq(**base)]), *_cols_buffers(8, key_cap=2),
        8) == -4


# ------------------------------------------------------------ encoders


def test_native_response_encoder_parity():
    """frontdoor_encode_resp vs protobuf over random decision columns
    (JAX tests/test_frontdoor.py test_native_response_encoder_parity):
    plain rows byte for byte; shed rows, whose 2-entry metadata map
    protobuf serializes in no defined order, parse-exactly."""
    from gubernator_tpu_torch.core.shm_ring import SHED_CODE_REASONS

    rng = np.random.default_rng(7)
    n = 64
    st = rng.integers(0, 2, n).astype(np.int64)
    li = rng.integers(0, 2**40, n).astype(np.int64)
    re_ = rng.integers(0, 2**40, n).astype(np.int64)
    rs = rng.integers(0, 2**52, n).astype(np.int64)
    fl = np.zeros(n, dtype=np.int32)
    shed_rows = np.arange(0, n, 7)
    fl[shed_rows] = rng.integers(1, 6, len(shed_rows)).astype(np.int32)
    out = np.empty(n * 96 + 64, dtype=np.uint8)
    ln = native.frontdoor_encode_resp(st, li, re_, rs, fl, n, out)
    assert ln > 0

    def model(j, flags):
        md = {}
        if flags[j]:
            md = {"shed": "true",
                  "shed_reason": SHED_CODE_REASONS[int(flags[j])]}
        return types.RateLimitResp(
            status=int(st[j]), limit=int(li[j]), remaining=int(re_[j]),
            reset_time=int(rs[j]), metadata=md)

    got = pb.GetRateLimitsResp.FromString(bytes(out[:ln]))
    want = pb.GetRateLimitsResp(
        responses=[pb.resp_to_pb(model(j, fl)) for j in range(n)])
    assert len(got.responses) == n
    for j, (g, w) in enumerate(zip(got.responses, want.responses)):
        assert (g.status, g.limit, g.remaining, g.reset_time) == (
            w.status, w.limit, w.remaining, w.reset_time), j
        assert dict(g.metadata) == dict(w.metadata), j
    fl0 = np.zeros(n, dtype=np.int32)
    ln0 = native.frontdoor_encode_resp(st, li, re_, rs, fl0, n, out)
    plain = pb.GetRateLimitsResp(
        responses=[pb.resp_to_pb(model(j, fl0))
                   for j in range(n)]).SerializeToString()
    assert bytes(out[:ln0]) == plain
    # the JAX library encodes the same bytes
    jout = np.empty_like(out)
    assert jnative.frontdoor_encode_resp(st, li, re_, rs, fl0, n,
                                         jout) == ln0
    assert bytes(jout[:ln0]) == plain
    # too small a buffer and an unknown shed code fall back
    assert native.frontdoor_encode_resp(st, li, re_, rs, fl0, n,
                                        out[:8]) == -1
    bad = fl.copy()
    bad[0] = 9
    assert native.frontdoor_encode_resp(st, li, re_, rs, bad, n, out) == -2


def test_worker_encode_falls_back_to_protobuf_byte_for_byte(monkeypatch):
    """_Worker.encode_cols without the native library (its fallback)
    and with it: the same bytes for plain rows."""
    from gubernator_tpu_torch.frontdoor import _Worker

    w = _Worker.__new__(_Worker)
    w.native, w._ebuf = native, None
    w.parse_s = w.encode_s = 0.0
    rng = np.random.default_rng(5)
    n = 20
    cols = [rng.integers(0, 2**40, n).astype(np.int64) for _ in range(4)]
    cols[0] = rng.integers(0, 2, n).astype(np.int64)
    fl = np.zeros(n, np.int32)
    w.native_ok = True
    fast = w.encode_cols(*cols, fl, 3, 12)
    w.native_ok = False
    slow = w.encode_cols(*cols, fl, 3, 12)
    assert fast == slow
    assert len(pb.GetRateLimitsResp.FromString(fast).responses) == 12


def test_columnify_resps_takes_plain_and_shed_rows_only():
    from gubernator_tpu_torch.frontdoor import columnify_resps
    from gubernator_tpu_torch.qos.admission import shed_response

    plain = RateLimitResp(status=1, limit=5, remaining=0, reset_time=9)
    shed = shed_response(RateLimitReq(name="a", unique_key="b", limit=3),
                         "ring_full")
    st, li, re_, rs, fl = columnify_resps([plain, shed])
    assert list(st) == [1, 1] and list(li) == [5, 3]
    assert list(fl) == [0, shm_ring.SHED_REASON_CODES["ring_full"]]
    assert columnify_resps([RateLimitResp(error="boom")]) is None
    assert columnify_resps([RateLimitResp(metadata={"owner": "x"})]) is None


def test_replay_context_abort_carries_integer_codes():
    from gubernator_tpu_torch.frontdoor import FrontdoorAbort, _EngineContext
    from gubernator_tpu_torch.frontdoor_replay import _shed_reason

    ctx = _EngineContext()
    assert ctx.integer_codes and ctx.time_remaining() is None
    with pytest.raises(FrontdoorAbort) as e:
        asyncio.run(ctx.abort(11, "too many"))
    assert e.value.code == 11 and e.value.message == "too many"
    st = np.array([1], np.int64)
    out = np.empty(256, np.uint8)
    m = native.frontdoor_encode_resp(st, st, st * 0, st * 0,
                                     np.array([4], np.int32), 1, out)
    assert _shed_reason(bytes(out[:m])) == "draining"


def _encode_resp(n, shed):
    """An n-item response whose first `shed` items were shed ring_full."""
    st = np.zeros(n, np.int64)
    fl = np.array([shm_ring.SHED_REASON_CODES["ring_full"]] * shed
                  + [0] * (n - shed), np.int32)
    out = np.empty(64 * n + 64, np.uint8)
    m = native.frontdoor_encode_resp(st, st + 5, st + 4, st, fl, n, out)
    return bytes(out[:m])


@pytest.mark.parametrize("shed", [0, 1, 4])
def test_replay_counts_each_shed_item(shed):
    from gubernator_tpu_torch.frontdoor_replay import (
        _shed_items,
        _shed_reason,
    )
    resp = _encode_resp(4, shed)
    assert _shed_items(resp) == shed
    assert _shed_reason(resp) == ("ring_full" if shed else None)
    assert len(pb.GetRateLimitsResp.FromString(resp).responses) == 4


class _FakeV1:
    """A worker servicer answering three RPCs: b"ok" whole, b"shed" with 2
    of its 4 items shed, and b"fail" with an abort."""

    def __init__(self):
        self.table = {b"ok": _encode_resp(4, 0), b"shed": _encode_resp(4, 2)}

    async def GetRateLimits(self, data, ctx):
        await asyncio.sleep(0)
        if data == b"fail":
            await ctx.abort(14, "worker gone")
        return self.table[data]


@pytest.mark.parametrize("mode", ["saturate", "rate"])
def test_replay_counts_only_answered_decisions(mode):
    """A shed item and an item of a failed call are no decision in the
    saturating and open-loop counts, and an open-loop latency is kept
    only for a call answered with no item shed."""
    from gubernator_tpu_torch.frontdoor_replay import _run

    cmd = dict(mode=mode, rpcs=[b"ok", b"shed", b"fail"], items=[4, 4, 4],
               seconds=0.03)
    cmd.update(callers=3) if mode == "saturate" else cmd.update(rate=4000)
    out = asyncio.run(_run(_FakeV1(), cmd))
    shed = out["sheds"].get("ring_full", 0)
    ok = out["rpcs"] - out["errors"] - shed
    assert ok > 0 and shed > 0 and out["errors"] > 0
    assert out["n"] == 4 * ok + 2 * shed
    if mode == "rate":
        # RPC i is rpcs[i % 3]
        assert (ok, shed, out["errors"]) == tuple(
            len(range(k, out["rpcs"], 3)) for k in range(3))
        assert len(out["lat_ms"]) == ok
