"""The port's gRPC server (server.py, api/grpc_api.py) against the JAX
package's, on loopback.

A port GrpcServer (Instance on the CPU, S = 2, the native router) and a
JAX GrpcServer (its Instance at its default Config, QoS on, over an
engine with the native router on a two-CPU-device mesh) get the same
scripted RPCs in the same order, raw bytes in, and must return the same
response BYTES and the same status codes: the golden wire vectors of
tests/test_golden_interop.py (copied here), all five algorithms, per-item
validation errors, a malformed body (INVALID_ARGUMENT), 1001 items
(OUT_OF_RANGE), RPCs just under and just over the raw lane's 2048-byte
threshold, HealthCheck and GetPeerRateLimits.  Both servers' clocks are
pinned (the pipelines', the batchers' and the engines' wall-clock
fallback).  Also: `Instance.add_to_server` splitting V1 and PeersV1
between two instances on one server (TransferBuckets' ack and its error
codes among its PeersV1 answers), and a fresh interpreter with grpc, protobuf, aiohttp and
prometheus_client blocked serving a large RPC on the bytes lane through
`serve_get_rate_limits`, with the same bytes.
"""

import asyncio
import subprocess
import sys
from pathlib import Path

import grpc
import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)
import jax

import gubernator_tpu_torch.core.engine as pengine
from gubernator_tpu import compat
from gubernator_tpu.config import Config as JConfig
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.core.service import Instance as JInstance
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu.server import GrpcServer as JGrpcServer
from gubernator_tpu_torch.api import pb
from gubernator_tpu_torch.state import migrate
from gubernator_tpu_torch.config import EngineConfig
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.observability.metrics import Metrics
from gubernator_tpu_torch.server import FASTPATH_MIN_BYTES, GrpcServer

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
T0 = 1_700_000_000_000
GEOMETRY = dict(capacity_per_shard=256, batch_per_shard=64,
                global_capacity=16, global_batch_per_shard=8,
                max_global_updates=8)

# golden wire vectors, copied from tests/test_golden_interop.py: proto3
# encodings hand-built from the wire-format spec
GOLDEN_GET_REQ = bytes.fromhex(
    "0a260a09746573745f6e616d65120d6163636f756e743a3132333435"
    "1801206428e0d40330013802")
GOLDEN_GET_REQ_BATCHING = bytes.fromhex(
    "0a240a09746573745f6e616d65120d6163636f756e743a3132333435"
    "1801206428e0d4033001")

V1 = "/pb.gubernator.V1/"
PEERS = "/pb.gubernator.PeersV1/"


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture
def pinned(monkeypatch):
    """JAX shard_map's replication check off, and both engines' wall
    clocks pinned at T0."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    monkeypatch.setattr(jengine, "millisecond_now", lambda: T0)
    monkeypatch.setattr(pengine, "millisecond_now", lambda: T0)
    _clear_jax_executable_caches()
    yield
    _clear_jax_executable_caches()


def _pin(inst):
    b = inst.batcher
    b.now_fn = lambda: T0
    if b.pipeline is not None:
        b.pipeline.now_fn = lambda: T0
    return inst


def _port_instance(metrics=True):
    return _pin(Instance(engine_config=EngineConfig(**GEOMETRY, num_shards=2),
                         device="cpu",
                         metrics=Metrics() if metrics else None))


def _jax_instance():
    mesh = make_mesh(jax.devices("cpu")[2:4])
    eng = jengine.RateLimitEngine(mesh=mesh, use_native="on", **GEOMETRY)
    return _pin(JInstance(JConfig(), engine=eng))


def _mk(items, peers=False):
    msg = pb.GetPeerRateLimitsReq if peers else pb.GetRateLimitsReq
    return msg(requests=[
        pb.RateLimitReq(name=n, unique_key=k, hits=h, limit=lim, duration=d,
                        algorithm=a, behavior=b)
        for (n, k, h, lim, d, a, b) in items]).SerializeToString()


def _sized(nbytes, name="sz"):
    """A token-bucket RPC whose encoding is exactly `nbytes` long (or as
    close below as 16-byte-ish items allow, then padded by the last key)."""
    items, pad = [], 0
    while True:
        cand = items + [(name, f"k{len(items) % 9}", 1, 50, 60_000, 0, 0)]
        if len(_mk(cand)) > nbytes:
            break
        items = cand
    while len(_mk(items)) < nbytes:
        pad += 1
        n, k, h, lim, d, a, b = items[-1]
        items[-1] = (n, "k8" + "x" * pad, h, lim, d, a, b)
    return _mk(items)


def _script():
    """(method, request bytes) in the order both servers get them."""
    rng = np.random.default_rng(7)
    out = [(V1 + "GetRateLimits", GOLDEN_GET_REQ),
           (V1 + "GetRateLimits", GOLDEN_GET_REQ_BATCHING),
           (V1 + "GetRateLimits", GOLDEN_GET_REQ_BATCHING)]
    for algo in range(5):
        small = [("alg", f"a{algo}_{i % 3}", int(rng.integers(0, 3)), 4,
                  60_000, algo, 0) for i in range(6)]
        big = [("alg", f"b{algo}_{i % 11}", int(rng.integers(0, 3)), 9,
                60_000, algo, 0) for i in range(110)]
        out += [(V1 + "GetRateLimits", _mk(small)),
                (V1 + "GetRateLimits", _mk(big))]
    bad = [("v", "", 1, 5, 1000, 0, 0), ("", "k", 1, 5, 1000, 0, 0),
           ("v", "k", 1, 5, 1000, 9, 0), ("v", "g", 1, 5, 1000, 2, 2),
           ("v", "ok", 1, 5, 1000, 0, 0), ("v", "nb", 1, 5, 1000, 1, 1)]
    out += [(V1 + "GetRateLimits", _mk(bad)),
            (V1 + "GetRateLimits", _mk(bad * 25)),
            (V1 + "GetRateLimits", b"\x0a\xff\xff\xff"),
            (V1 + "GetRateLimits", _mk([("o", "k", 1, 5, 1000, 0, 0)] * 1001)),
            (V1 + "GetRateLimits", _sized(FASTPATH_MIN_BYTES - 1)),
            (V1 + "GetRateLimits", _sized(FASTPATH_MIN_BYTES)),
            (V1 + "GetRateLimits", _sized(FASTPATH_MIN_BYTES + 1)),
            (V1 + "HealthCheck", b""),
            # no GLOBAL item on the peer plane: the JAX instance fails
            # it (test_jax_peer_plane_fails_a_global_item_the_port_serves)
            (PEERS + "GetPeerRateLimits", _mk(bad[:3] + bad[4:], peers=True)),
            (PEERS + "GetPeerRateLimits",
             _mk([("p", f"q{i % 13}", 1, 6, 60_000, i % 2, 0)
                  for i in range(120)], peers=True)),
            (PEERS + "GetPeerRateLimits", b"\x0a\xff\xff\xff"),
            (PEERS + "GetPeerRateLimits",
             _mk([("p", "k", 1, 5, 1000, 0, 0)] * 1001, peers=True)),
            # last: a config past the compact ranges latches both engines
            # off the compact lanes
            (V1 + "GetRateLimits", _mk([("big", "x", 2 ** 40, 2 ** 41,
                                         2 ** 36, 0, 0)] * 70))]
    return out


async def _call(channel, method, data):
    """Raw bytes in, (status code name, response bytes or details) out."""
    fn = channel.unary_unary(method)
    try:
        return "OK", await fn(data, timeout=30)
    except grpc.aio.AioRpcError as e:
        return e.code().name, e.details()


async def _serve(inst, server_cls, script):
    srv = server_cls(inst, "127.0.0.1:0")
    await srv.start()
    try:
        async with grpc.aio.insecure_channel(srv.address) as ch:
            return [await _call(ch, m, d) for m, d in script]
    finally:
        await srv.stop(None)


def test_port_server_answers_the_scripted_run_byte_for_byte(pinned):
    script = _script()
    sizes = [len(d) for _, d in script]
    assert FASTPATH_MIN_BYTES - 1 in sizes and FASTPATH_MIN_BYTES + 1 in sizes
    jinst, pinst = _jax_instance(), _port_instance()
    try:
        got_j = asyncio.run(_serve(jinst, JGrpcServer, script))
        got_p = asyncio.run(_serve(pinst, GrpcServer, script))
    finally:
        jinst.close()
        pinst.close()
    for i, ((m, d), j, p) in enumerate(zip(script, got_j, got_p)):
        assert p == j, (i, m, len(d))
    codes = [c for c, _ in got_p]
    assert codes.count("INVALID_ARGUMENT") == 2
    assert codes.count("OUT_OF_RANGE") == 2
    pipe = pinst.batcher.pipeline
    assert all(len(d) >= FASTPATH_MIN_BYTES for d in
               (script[i][1] for i in (4, 6, 8, 10, 12, 14, 16)))
    # the large token/leaky/GCRA/sliding RPCs, the two at and over the
    # threshold and the large peer relay took the bytes lane; the large
    # concurrency RPC, the one with validation errors, the two of 1001
    # items, the out-of-range configs, and the small and the malformed
    # peer relays (the peer plane tries the lane at any size) were refused
    # to the protobuf path
    assert (pipe.rpc_staged, pipe.rpc_refused) == (7, 7)
    text = pinst.metrics.expose().decode()
    assert 'grpc_request_counts_total{method="/pb.gubernator.V1/GetRateLimits",status="failed"} 2.0' in text


def test_add_to_server_splits_services_between_two_instances(pinned):
    """V1 from one instance and PeersV1 from another on ONE caller-owned
    server: each RPC lands on the instance that mounted its service."""
    a, b = _port_instance(metrics=False), _port_instance(metrics=False)
    data = _mk([("split", f"k{i}", 1, 5, 60_000, 0, 0) for i in range(120)])
    assert len(data) >= FASTPATH_MIN_BYTES

    async def body():
        server = grpc.aio.server()
        a.add_to_server(server, v1=True, peers=False)
        b.add_to_server(server, v1=False, peers=True)
        port = server.add_insecure_port("127.0.0.1:0")
        await server.start()
        try:
            async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
                r1 = await _call(ch, V1 + "GetRateLimits", data)
                r2 = await _call(ch, PEERS + "GetPeerRateLimits", data)
                r3 = await _call(ch, V1 + "GetRateLimits", data)
                un = await _call(ch, PEERS + "UpdatePeerGlobals", b"")
                tb = [await _call(ch, PEERS + "TransferBuckets", d)
                      for d in (b"", migrate.encode_rows([], []), row)]
            return r1, r2, r3, un, tb
        finally:
            await server.stop(None)

    row = migrate.encode_rows([dict(key="split_x", limit=5, duration=60_000,
                                    remaining=4, tstamp=T0, expire=T0 + 1,
                                    algo=0)], [])
    try:
        r1, r2, r3, un, tb = asyncio.run(body())
    finally:
        a.close()
        b.close()
    assert r1 == r2 and r1[0] == "OK"  # both fresh: the same first answers
    assert r3 != r1  # the second V1 call hit a's buckets again
    assert a.engine.cache_size == 120 and b.engine.cache_size == 120
    assert a.batcher.pipeline.rpc_staged == 2
    assert b.batcher.pipeline.rpc_staged == 1
    # UpdatePeerGlobals is served (an empty broadcast upserts nothing), and
    # so is TransferBuckets: a malformed payload is INVALID_ARGUMENT, an
    # empty one acks, and regular rows into the native router (no key
    # strings) are FAILED_PRECONDITION
    assert un[0] == "OK"
    assert tb[0][0] == "INVALID_ARGUMENT" and "malformed" in tb[0][1]
    assert tb[1] == ("OK", migrate.encode_ack(0, 0, 0, 0))
    assert tb[2][0] == "FAILED_PRECONDITION" and "native router" in tb[2][1]


_BLOCKED = r"""
import asyncio, sys
before = set(sys.modules)  # what the interpreter's start-up loaded
for m in ("grpc", "google", "google.protobuf", "aiohttp",
          "prometheus_client"):
    sys.modules[m] = None
from gubernator_tpu_torch.config import EngineConfig
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.server import serve_get_rate_limits

class Ctx:
    def time_remaining(self):
        return None
    async def abort(self, code, details):
        raise RuntimeError(details)

big, small = (bytes.fromhex(x) for x in sys.argv[1:3])
inst = Instance(engine_config=EngineConfig(
    capacity_per_shard=256, batch_per_shard=64, global_capacity=16,
    global_batch_per_shard=8, max_global_updates=8, num_shards=2),
    device="cpu")
p = inst.batcher.pipeline
p.now_fn = lambda: %d
p.gate_enabled = False

async def main():
    out = await serve_get_rate_limits(inst, big, Ctx())
    print(out.hex())
    try:
        await serve_get_rate_limits(inst, small, Ctx())
    except ImportError:
        print("protobuf path: ImportError")
    print(p.rpc_staged, p.rpc_refused, inst.metrics)
    bad = [m for m in set(sys.modules) - before if m.split(".")[0] in
           ("grpc", "google", "aiohttp", "prometheus_client", "jax",
            "gubernator_tpu") and sys.modules[m] is not None]
    print(bad)

asyncio.run(main())
inst.close()
""" % T0


def test_bytes_lane_runs_without_grpc_protobuf_aiohttp_or_metrics(pinned):
    """A fresh interpreter in which grpc, protobuf, aiohttp and
    prometheus_client cannot be imported still serves a large RPC through
    serve_get_rate_limits on the bytes lane, with the bytes an in-process
    port server returns; a small RPC needs the protobuf path and raises
    ImportError there."""
    big = _mk([("nolib", f"k{i % 17}", 1, 7, 60_000, i % 2, 0)
               for i in range(120)])
    small = _mk([("nolib", "k", 1, 7, 60_000, 0, 0)])
    assert len(big) >= FASTPATH_MIN_BYTES > len(small)
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED, big.hex(), small.hex()],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    inst = _port_instance(metrics=False)
    try:
        (_, want), = asyncio.run(_serve(inst, GrpcServer,
                                        [(V1 + "GetRateLimits", big)]))
    finally:
        inst.close()
    assert bytes.fromhex(lines[0]) == want
    assert lines[1] == "protobuf path: ImportError"
    assert lines[2] == "1 0 None"
    assert lines[3] == "[]"


def test_jax_peer_plane_fails_a_global_item_the_port_serves(pinned):
    """A fact of the reference, pinned: on a standalone JAX instance a
    GetPeerRateLimits carrying a GLOBAL item fails with UNKNOWN (its
    GlobalManager's queue_update arms a broadcast interval that only a
    started peer ring creates: AttributeError), while the port decides
    the item locally like the rest."""
    data = _mk([("v", "g", 1, 5, 1000, 0, 2)], peers=True)
    script = [(PEERS + "GetPeerRateLimits", data)]
    jinst, pinst = _jax_instance(), _port_instance(metrics=False)
    try:
        (got_j,) = asyncio.run(_serve(jinst, JGrpcServer, script))
        (got_p,) = asyncio.run(_serve(pinst, GrpcServer, script))
    finally:
        jinst.close()
        pinst.close()
    assert got_j[0] == "UNKNOWN" and "arm" in got_j[1]
    assert got_p[0] == "OK"
    (r,) = pb.GetPeerRateLimitsResp.FromString(got_p[1]).rate_limits
    assert (r.status, r.limit, r.remaining, r.error) == (0, 5, 4, "")


@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke.py as a module (it exits at once without a card, so the
    check is patched for the import; only its wire codec is used)."""
    import importlib.util
    from unittest import mock
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_wire", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch("torch.cuda.is_available", return_value=True):
        spec.loader.exec_module(mod)
    return mod


_EDGES = (0, 1, -1, 127, 128, 2 ** 31 - 1, -2 ** 31, 2 ** 32, 2 ** 63 - 1,
          -2 ** 63, 1_700_000_000_000)
_ENUM_EDGES = (0, 1, 2, 4, 9, -1, 2 ** 31 - 1, -2 ** 31)


def _fuzz_int(rng, edges=_EDGES, bits=63):
    if rng.random() < 0.5:
        return int(rng.choice(edges))
    return int(rng.integers(-2 ** bits, 2 ** bits))


def _fuzz_str(rng):
    alphabet = ["", "a", "k", "_", "ü", "ключ", "☃", "x" * 130]
    return "".join(rng.choice(alphabet) for _ in range(rng.integers(0, 4)))


def test_chip_smoke_wire_codec_matches_protobuf(chip_smoke):
    """chip_smoke.py's proto3 encoder byte for byte against
    gubernator_pb2's SerializeToString, and its decoder against
    FromString, on fuzzed requests and responses with negative,
    int64-edge and int32-enum-edge values, empty and non-ASCII strings and
    0-3 metadata entries.  With two or more map entries protobuf's entry
    order is its own (not key order, even deterministic), so there the
    encoding is held to parse back to the same message instead."""
    cs = chip_smoke
    rng = np.random.default_rng(2024)
    for trial in range(60):
        reqs = [dict(name=_fuzz_str(rng), unique_key=_fuzz_str(rng),
                     hits=_fuzz_int(rng), limit=_fuzz_int(rng),
                     duration=_fuzz_int(rng),
                     algorithm=_fuzz_int(rng, _ENUM_EDGES, 31),
                     behavior=_fuzz_int(rng, _ENUM_EDGES, 31))
                for _ in range(rng.integers(0, 6))]
        msg = pb.GetRateLimitsReq(requests=[pb.RateLimitReq(**r)
                                            for r in reqs])
        data = msg.SerializeToString(deterministic=True)
        assert cs.encode_list(reqs, cs.REQ_FIELDS) == data, trial
        assert cs.decode_list(data, cs.REQ_FIELDS) == reqs, trial
        resps = [dict(status=_fuzz_int(rng, _ENUM_EDGES, 31),
                      limit=_fuzz_int(rng), remaining=_fuzz_int(rng),
                      reset_time=_fuzz_int(rng), error=_fuzz_str(rng),
                      metadata={_fuzz_str(rng): _fuzz_str(rng)
                                for _ in range(rng.integers(0, 4))})
                 for _ in range(rng.integers(0, 6))]
        out = pb.GetRateLimitsResp(responses=[pb.RateLimitResp(**r)
                                              for r in resps])
        data = out.SerializeToString(deterministic=True)
        mine = cs.encode_list(resps, cs.RESP_FIELDS)
        if max([len(r["metadata"]) for r in resps], default=0) < 2:
            assert mine == data, trial
        else:
            assert pb.GetRateLimitsResp.FromString(mine) == out, trial
        back = pb.GetRateLimitsResp.FromString(data).responses
        got = cs.decode_list(data, cs.RESP_FIELDS)
        assert got == [dict(status=r.status, limit=r.limit,
                            remaining=r.remaining, reset_time=r.reset_time,
                            error=r.error, metadata=dict(r.metadata))
                       for r in back] == resps, trial


def test_chip_smoke_wire_requests_take_the_lane(chip_smoke):
    """The RPCs phase 9 sends are at least FASTPATH_MIN_BYTES long and
    parse to the requests they were built from."""
    cs = chip_smoke
    rpcs, datas = cs.wire_rpcs(np.random.default_rng(91), 20 * cs.SERVE_RPC)
    assert min(len(d) for d in datas) >= FASTPATH_MIN_BYTES
    for rpc, d in zip(rpcs, datas):
        back = [pb.req_from_pb(m)
                for m in pb.GetRateLimitsReq.FromString(d).requests]
        assert back == rpc
