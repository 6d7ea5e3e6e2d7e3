"""The port's state snapshots (gubernator_tpu_torch/state/snapshot.py and
the engine's export_state / import_state) on the CPU.

The first tests mirror tests/test_snapshot.py on the port: restart
equivalence against the int64 host oracle (tests/pyref.py) in both file
layouts and with both key-routing backends, the layouts restoring bit for
bit, a corrupt file falling back to a cold start, the refusals, rebase_to,
a Python-table snapshot into the native router, the file round trip and
cache_stats.  The rest hold the port against the JAX package on the same
requests at pinned clocks: its `dumps` byte for byte equal to the JAX
`dumps` (both layouts, both backends, GLOBAL keys included), a file of either package restored by the other
and then serving equal responses, the numpy time codec against the JAX
`rebase_encode` / `rebase_decode` on the codec's edges, and an Instance
snapshotted in the middle of a pipelined stream and restored into a fresh
one, which then answers as an uninterrupted twin.
"""

import asyncio
import copy
import logging
import threading
import time
import types
import zipfile

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)
import jax

from gubernator_tpu import compat
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu.state import snapshot as jsnap
from gubernator_tpu_torch import native
from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    RateLimitReq,
)
from gubernator_tpu_torch.config import EngineConfig
from gubernator_tpu_torch.core.engine import RateLimitEngine
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.state import snapshot as snapmod

from .pyref import PyRefCache

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000
# key pool smaller than capacity: the oracle has no eviction
KEYS = [f"s{i}" for i in range(24)]
GEOM = dict(capacity_per_shard=64, batch_per_shard=16, global_capacity=16,
            global_batch_per_shard=8, max_global_updates=8)


def _mk_engine(use_native=False, num_shards=8, **kw):
    return RateLimitEngine(**{**GEOM, **kw}, num_shards=num_shards,
                           device="cpu", use_native=use_native)


def _jreq(r):
    return JReq(name=r.name, unique_key=r.unique_key, hits=r.hits,
                limit=r.limit, duration=r.duration, algorithm=r.algorithm,
                behavior=r.behavior)


def _tuple(r):
    return (int(r.status), int(r.limit), int(r.remaining),
            int(r.reset_time), r.error)


def _workload(rng, rounds, glob=False):
    """(dt, window) pairs mixing algorithms, hit sizes and durations so
    windows close, buckets drain and TTLs lapse (tests/test_snapshot.py's
    law); `glob` adds a GLOBAL item to about one window in three."""
    out = []
    for _ in range(rounds):
        dt = int(rng.choice([3, 40, 700, 30_000]))
        window = [RateLimitReq(
            name="snap", unique_key=str(rng.choice(KEYS)),
            hits=int(rng.integers(0, 5)),
            limit=int(rng.integers(2, 12)),
            duration=int(rng.choice([50, 2_000, 60_000])),
            algorithm=Algorithm.TOKEN_BUCKET if rng.integers(2) else
            Algorithm.LEAKY_BUCKET,
        ) for _ in range(int(rng.integers(1, 10)))]
        if glob and rng.integers(3) == 0:
            window.append(RateLimitReq(
                name="glob", unique_key=f"g{int(rng.integers(3))}",
                hits=int(rng.integers(0, 3)), limit=9, duration=5_000,
                algorithm=int(rng.integers(2)), behavior=Behavior.GLOBAL))
        out.append((dt, window))
    return out


def _drive(eng, oracle, workload, now):
    for dt, window in workload:
        now += dt
        got = eng.process(window, now=now)
        want = [oracle.hit(_jreq(r), now) for r in window]
        for j, (g, w) in enumerate(zip(got, want)):
            assert _tuple(g)[:4] == _tuple(w)[:4], \
                f"item {j} at t+{now - T0}: {window[j]}"
    return now


def _clone_oracle(oracle):
    c = PyRefCache()
    c.entries = copy.deepcopy(oracle.entries)
    return c


def _backends():
    return [False] + (["on"] if native.available() else [])


def _export_planes(eng, now):
    snap = eng.export_state(now=now, layout="int64")
    return snap.planes, snap.gplanes, snap.gcfg


# --------------------------------------- mirrors of tests/test_snapshot.py


@pytest.mark.parametrize("layout", ["int64", "compact32"])
@pytest.mark.parametrize("use_native", _backends())
def test_restart_equivalence(layout, use_native):
    """Traffic, snapshot, kill, restore, more traffic, resuming inside
    live windows (+25 ms) and past most windows and TTLs (+70 s): the
    oracle never restarts, so any drift in the codec or the restore shows
    as a decision that differs."""
    rng = np.random.default_rng(7)
    oracle = PyRefCache()
    eng = _mk_engine(use_native)
    now = _drive(eng, oracle, _workload(rng, 8), T0)
    blob = snapmod.dumps(eng.export_state(now=now, layout=layout))
    del eng
    for resume_dt in (25, 70_000):
        eng = _mk_engine(use_native)
        eng.import_state(snapmod.loads(blob))
        _drive(eng, _clone_oracle(oracle), _workload(rng, 6),
               now + resume_dt)


@pytest.mark.parametrize("use_native", _backends())
def test_layouts_restore_bit_identically(use_native):
    rng = np.random.default_rng(11)
    eng = _mk_engine(use_native)
    now = T0
    for dt, window in _workload(rng, 8, glob=True):
        now += dt
        eng.process(window, now=now)
    snap = eng.export_state(now=now)
    got = {}
    for layout in ("int64", "compact32"):
        snap.layout = layout
        e = _mk_engine(use_native)
        e.import_state(snapmod.loads(snapmod.dumps(snap)))
        got[layout] = _export_planes(e, now)
    for a, b in zip(got["int64"], got["compact32"]):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    # and both equal the exporting engine
    for a, b in zip(got["int64"], _export_planes(eng, now)):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_corrupted_snapshot_falls_back_cold(tmp_path, caplog):
    eng = _mk_engine()
    reqs = [RateLimitReq(name="c", unique_key=f"k{i}", hits=1, limit=5,
                         duration=60_000, algorithm=Algorithm.TOKEN_BUCKET)
            for i in range(8)]
    eng.process(reqs, now=T0)
    path = str(tmp_path / "arena.snap")
    snapmod.save(eng.export_state(now=T0 + 100), path)
    blob = open(path, "rb").read()
    cases = {
        "truncated": blob[:len(blob) // 3],
        "bitflip": blob[:64] + bytes([blob[64] ^ 0x10]) + blob[65:],
        "garbage": b"not a snapshot at all",
    }
    for name, bad in cases.items():
        bad_path = str(tmp_path / f"{name}.snap")
        open(bad_path, "wb").write(bad)
        fresh = _mk_engine()
        with caplog.at_level(logging.WARNING, "gubernator.snapshot"):
            got = snapmod.restore_engine(fresh, bad_path)
        assert got is None, name
        assert any("starting cold" in r.getMessage()
                   for r in caplog.records), name
        caplog.clear()
        out = fresh.process(reqs[:2], now=T0 + 200)
        assert all(not r.error for r in out)
        assert [r.remaining for r in out] == [4, 4]  # cold: fresh buckets
    fresh = _mk_engine()
    assert snapmod.restore_engine(fresh, str(tmp_path / "absent.snap")) is None


def test_geometry_mismatch_rejected():
    eng = _mk_engine()
    eng.process([RateLimitReq(name="g", unique_key="x", hits=1, limit=5,
                              duration=1000)], now=T0)
    snap = snapmod.loads(snapmod.dumps(eng.export_state(now=T0)))
    for kw in (dict(capacity_per_shard=32), dict(num_shards=4),
               dict(global_capacity=8)):
        with pytest.raises(snapmod.SnapshotError, match="geometry"):
            _mk_engine(**kw).import_state(snap)


def test_mesh_snapshot_and_exact_keys_refused():
    """A mesh rank's snapshot holds only its own shards (num_local_shards,
    local_shard_offset), which a single-process engine refuses by geometry;
    GLOBAL keys a snapshot holds pending mesh registration restore still
    pending, as the JAX engine restores them (engine.py:1986), since mesh
    snapshots are served now.  An exact-keys router refuses both
    directions (its key bytes are not in the format)."""
    eng = _mk_engine()
    eng.process([RateLimitReq(name="m", unique_key="x", hits=1, limit=5,
                              duration=1000)], now=T0)
    snap = snapmod.loads(snapmod.dumps(eng.export_state(now=T0)))
    rank = snapmod.loads(snapmod.dumps(eng.export_state(now=T0)))
    rank.num_local_shards, rank.local_shard_offset = 4, 4
    with pytest.raises(snapmod.SnapshotError, match="geometry"):
        _mk_engine().import_state(rank)
    snap.gpending = ["glob_g0"]
    restored = _mk_engine()
    restored.import_state(snap)
    assert restored._gpending == {"glob_g0"}
    assert not restored.global_ready("glob_g0")
    if not native.available():
        return
    exact = RateLimitEngine(**GEOM, num_shards=8, device="cpu",
                            use_native="on", exact_keys=True)
    with pytest.raises(snapmod.SnapshotError, match="exact-keys"):
        exact.export_state(now=T0)
    snap.gpending = []
    with pytest.raises(snapmod.SnapshotError, match="exact-keys"):
        exact.import_state(snap)


def test_rebase_to_preserves_remaining_lifetime():
    eng = _mk_engine()
    r = RateLimitReq(name="rb", unique_key="shorty", hits=2, limit=10,
                     duration=50, algorithm=Algorithm.TOKEN_BUCKET)
    eng.process([r], now=T0)
    blob = snapmod.dumps(eng.export_state(now=T0 + 10))
    outage = 600_000
    resumed = _mk_engine()
    resumed.import_state(snapmod.loads(blob), rebase_to=T0 + 10 + outage)
    assert resumed.process([r], now=T0 + 20 + outage)[0].remaining == 6
    cold = _mk_engine()
    cold.import_state(snapmod.loads(blob))
    assert cold.process([r], now=T0 + 20 + outage)[0].remaining == 8


@pytest.mark.skipif(not native.available(), reason="native router unavailable")
def test_python_snapshot_restores_into_native_engine():
    rng = np.random.default_rng(3)
    oracle = PyRefCache()
    py = _mk_engine(False)
    now = _drive(py, oracle, _workload(rng, 6), T0)
    blob = snapmod.dumps(py.export_state(now=now))
    nat = _mk_engine("on")
    nat.import_state(snapmod.loads(blob))
    _drive(nat, _clone_oracle(oracle), _workload(rng, 4), now + 40)
    nat2 = _mk_engine("on")
    for dt, window in _workload(rng, 4):
        nat2.process(window, now=now)
    nblob = snapmod.dumps(nat2.export_state(now=now))
    with pytest.raises(snapmod.SnapshotError, match="fingerprint"):
        _mk_engine(False).import_state(snapmod.loads(nblob))


def test_snapshot_file_roundtrip(tmp_path):
    eng = _mk_engine()
    eng.process([RateLimitReq(name="f", unique_key=f"k{i}", hits=1, limit=9,
                              duration=30_000,
                              algorithm=Algorithm.LEAKY_BUCKET)
                 for i in range(10)], now=T0)
    path = snapmod.snapshot_path(str(tmp_path))
    size = snapmod.save(eng.export_state(now=T0 + 5), path)
    assert size == len(open(path, "rb").read())
    assert not list(tmp_path.glob("*.tmp.*"))
    fresh = _mk_engine()
    restored = snapmod.restore_engine(fresh, path)
    assert restored is not None and restored.total_keys() == 10
    assert fresh.cache_stats(now=T0 + 10)["live"] == 10


def test_cache_stats_coherent():
    eng = _mk_engine()
    reqs = [RateLimitReq(name="st", unique_key=f"k{i}", hits=1, limit=5,
                         duration=100, algorithm=Algorithm.TOKEN_BUCKET)
            for i in range(12)]
    eng.process(reqs, now=T0)
    eng.process(reqs[:6], now=T0 + 10)
    st = eng.cache_stats(now=T0 + 10)
    assert st["size"] == eng.cache_size == 12
    assert st["hits"] == eng.cache_hits == 6
    assert st["misses"] == eng.cache_misses == 12
    assert st["free"] + st["live"] + st["expired"] == st["capacity"]
    assert st["live"] == 12
    st2 = eng.cache_stats(now=T0 + 1000)
    assert st2["expired"] == 12 and st2["live"] == 0


def test_compact32_widens_to_int64_past_its_range():
    """A limit past int32 (the compact latch trips) or a time past the
    rebase clip cannot travel in compact32: dumps writes int64 and the
    restore is exact, and the restored engine keeps the latch."""
    eng = _mk_engine()
    eng.process([RateLimitReq(name="w", unique_key="big", hits=1,
                              limit=2 ** 40, duration=60_000)], now=T0)
    eng.process([RateLimitReq(name="w", unique_key="far", hits=1, limit=5,
                              duration=2 ** 33)], now=T0)
    snap = eng.export_state(now=T0 + 1, layout="compact32")
    assert not snapmod.compact_encodable(snap)
    back = snapmod.loads(snapmod.dumps(snap))
    assert back.layout == "int64" and not back.compact_sound
    fresh = _mk_engine()
    fresh.import_state(back)
    assert not fresh._compact_sound and not fresh._compact_enabled
    for a, b in zip(_export_planes(fresh, T0), _export_planes(eng, T0)):
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_unknown_algorithm_rows_drop_to_cold():
    """Rows with an algorithm past CONCURRENCY (a newer writer) restore as
    cold, their keys gone from the table, as in the JAX loads."""
    eng = _mk_engine()
    eng.process([RateLimitReq(name="u", unique_key=f"k{i}", hits=1, limit=5,
                              duration=60_000) for i in range(4)], now=T0)
    snap = eng.export_state(now=T0 + 1, layout="int64")
    live = np.argwhere(snap.planes["expire"] != 0)
    s, slot = (int(v) for v in live[0])
    snap.planes["algo"][s, slot] = 7
    back = snapmod.loads(snapmod.dumps(snap))
    want = jsnap.loads(snapmod.dumps(snap))
    assert back.planes["expire"][s, slot] == 0
    np.testing.assert_array_equal(back.planes["expire"],
                                  want.planes["expire"])
    assert back.total_keys() == want.total_keys() == 3


# ----------------------------------------------- against the JAX package


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture
def jax_pair(monkeypatch):
    """make(use_native) -> (jax_engine, port_engine) at one geometry on
    two shards; shard_map's replication check off and the executable
    caches emptied, as in the other port tests."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()
    mesh = make_mesh(jax.devices("cpu")[2:4])

    def make(use_native):
        ref = jengine.RateLimitEngine(mesh=mesh, use_native=use_native,
                                      **GEOM)
        return ref, _mk_engine(use_native, num_shards=2)
    yield make
    _clear_jax_executable_caches()


def _serve_both(ref, port, workload, now):
    for dt, window in workload:
        now += dt
        want = ref.process([_jreq(r) for r in window], now=now)
        got = port.process(window, now=now)
        assert [_tuple(g) for g in got] == [_tuple(w) for w in want]
    return now


@pytest.mark.parametrize("layout", ["int64", "compact32"])
@pytest.mark.parametrize("use_native", _backends())
def test_dumps_byte_equal_to_jax(jax_pair, layout, use_native):
    ref, port = jax_pair(use_native)
    rng = np.random.default_rng(5)
    now = _serve_both(ref, port, _workload(rng, 10, glob=True), T0)
    snap = port.export_state(now=now, layout=layout)
    assert snap.gtable and len(snap.gtable[0]) > 0
    got = snapmod.dumps(snap)
    want = jsnap.dumps(ref.export_state(now=now, layout=layout))
    assert got == want
    # "auto" picks the same layout in both
    assert snapmod.dumps(port.export_state(now=now)) == jsnap.dumps(
        ref.export_state(now=now))


def test_dumps_reads_no_clock(monkeypatch):
    """One state dumps to the same bytes whenever it is dumped, in both
    packages: numpy's savez opens each npz member by name, which stamps
    zipfile's fixed 1980-01-01 date, not the wall clock (pinned here by
    moving zipfile's clock between two dumps).  So the byte-equality tests
    need no clock of their own."""
    eng = _mk_engine()
    eng.process([RateLimitReq(name="z", unique_key="k", hits=1, limit=5,
                              duration=60_000)], now=T0)
    snap = eng.export_state(now=T0 + 1)
    blobs = []
    for sec in (T0 / 1000.0, T0 / 1000.0 + 3600):
        monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
            time=lambda sec=sec: sec, localtime=time.localtime))
        blobs.append((snapmod.dumps(snap), jsnap.dumps(snap)))
    assert blobs[0][0] == blobs[0][1] == blobs[1][0] == blobs[1][1]


@pytest.mark.parametrize("use_native", _backends())
def test_files_restore_across_packages(jax_pair, tmp_path, use_native):
    """A file the JAX engine saved restores in the port, and a file the
    port saved restores in the JAX engine; each pair then serves equal
    responses and holds equal arenas."""
    ref, port = jax_pair(use_native)
    rng = np.random.default_rng(9)
    now = _serve_both(ref, port, _workload(rng, 8, glob=True), T0)
    jpath, ppath = str(tmp_path / "jax.snap"), str(tmp_path / "port.snap")
    jsnap.save(ref.export_state(now=now, layout="compact32"), jpath)
    snapmod.save(port.export_state(now=now, layout="compact32"), ppath)

    ref2, port2 = jax_pair(use_native)
    assert snapmod.restore_engine(port2, jpath) is not None
    assert jsnap.restore_engine(ref2, ppath) is not None
    later = _workload(rng, 8, glob=True)
    _serve_both(ref2, port2, later, now + 30)
    _serve_both(ref, port, later, now + 30)
    got = port2.export_state(now=now, layout="int64")
    want = ref2.export_state(now=now, layout="int64")
    for name in got.planes:
        np.testing.assert_array_equal(got.planes[name], want.planes[name])
        np.testing.assert_array_equal(got.gplanes[name], want.gplanes[name])


def test_codec_matches_jax_on_edges():
    """The numpy codec against the JAX rebase_encode / rebase_decode (the
    fused kernel's pair helpers) on deltas at and past +/-(2^31 - 16),
    clipped values, negative deltas, int64 wraparound and dead slots
    against expire == 0."""
    lim = snapmod.REBASE_LIM
    i64 = np.iinfo(np.int64)
    rng = np.random.default_rng(17)
    for now in (T0, 0, -5, i64.max - 3, i64.min + 7):
        deltas = np.array([0, 1, -1, lim - 1, lim, lim + 1, -lim + 1, -lim,
                           -lim - 1, 2 ** 31, -(2 ** 31), 2 ** 40,
                           -(2 ** 40)], np.int64)
        with np.errstate(over="ignore"):
            times = np.concatenate([
                deltas + np.int64(now),
                np.array([i64.max, i64.min, 0], np.int64),
                rng.integers(i64.min, i64.max, 64, dtype=np.int64)])
        dead = np.zeros(times.shape, bool)
        dead[-70:-60] = True
        got = snapmod.rebase_encode(times, dead, now)
        want = jsnap.rebase_encode(times, dead, now)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"now={now}")
        assert (got[dead] == snapmod.DEAD_REL).all()
        back = snapmod.rebase_decode(got, now)
        np.testing.assert_array_equal(back, jsnap.rebase_decode(want, now))
        assert back.dtype == np.int64 and (back[dead] == 0).all()
        # in range the codec is exact
        inside = (~dead) & (np.abs(got.astype(np.int64)) < lim)
        np.testing.assert_array_equal(back[inside], times[inside])
    # a 2-d plane keeps its shape
    plane = np.arange(12, dtype=np.int64).reshape(3, 4) + T0
    dead = plane % 5 == 0
    np.testing.assert_array_equal(
        snapmod.rebase_encode(plane, dead, T0),
        jsnap.rebase_encode(plane, dead, T0))


# ------------------------------------------------- the Instance's quiesce


def _pin(inst, now):
    inst.batcher.now_fn = lambda: now
    if inst.batcher.pipeline is not None:
        inst.batcher.pipeline.now_fn = lambda: now
        inst.batcher.pipeline.gate_enabled = False


def _stream(seed, n_batches):
    """Concurrent RPC batches: compact token/leaky items (the pipelined
    lane) mixed with GCRA, out-of-range and GLOBAL items (the classic
    lane)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        rpcs = []
        for _ in range(int(rng.integers(2, 6))):
            rpc = []
            for _ in range(int(rng.integers(1, 12))):
                k = int(rng.zipf(1.3)) % 40
                kind = k % 9
                algo = k & 1
                behavior = Behavior.BATCHING
                limit = 5 + k % 7
                if kind == 7:
                    algo = Algorithm.GCRA
                elif kind == 8:
                    behavior = Behavior.GLOBAL
                rpc.append(RateLimitReq(
                    name="q", unique_key=f"k{k}",
                    hits=int(rng.integers(0, 3)), limit=limit,
                    duration=(2_000 if k % 3 else 50_000), algorithm=algo,
                    behavior=behavior))
            rpcs.append(rpc)
        out.append((T0 + 37 * b, rpcs))
    return out


async def _serve(inst, batches):
    out = []
    for now, rpcs in batches:
        _pin(inst, now)
        res = await asyncio.gather(*(inst.get_rate_limits(r) for r in rpcs))
        out.append([[_tuple(x) for x in r] for r in res])
    return out


def _quiet(inst) -> bool:
    """Nothing of the Instance waits to be packed or launched (drains may
    still be in flight: launched, their fetch pending)."""
    bt, pipe = inst.batcher, inst.batcher.pipeline
    return not (bt._pending or bt._windows or pipe._singles or pipe._jobs
                or pipe._carried or pipe._predispatch)


@pytest.mark.parametrize("layout", ["int64", "compact32"])
def test_instance_snapshot_with_drains_in_flight(layout):
    """An Instance (native router, pipelined lane, GLOBAL items) serves
    half a stream; then, with the next batch's drains launched and their
    fetches held on the fetch threads, it saves at the quiesce point.  A
    fresh Instance restored from those bytes holds exactly the exported
    state, and serves the rest of the stream as the uninterrupted
    Instance does, every response and both arenas."""
    conf = EngineConfig(num_shards=2, capacity_per_shard=256,
                        batch_per_shard=32, global_capacity=16,
                        global_batch_per_shard=8, max_global_updates=8)
    batches = _stream(21, 24)

    async def run():
        a = Instance(engine_config=conf, device="cpu")
        b = Instance(engine_config=conf, device="cpu")
        pipe = a.batcher.pipeline
        pipe.depth = 16  # every drain of the held batch launches
        await _serve(a, batches[:12])
        gate, held = threading.Event(), []
        fetch = pipe._complete_sync_one

        def held_fetch(res):
            held.append(res)
            gate.wait(30)
            return fetch(res)

        pipe._complete_sync_one = held_fetch
        now, rpcs = batches[12]
        _pin(a, now)
        pending = asyncio.gather(*(a.get_rate_limits(r) for r in rpcs))
        deadline = time.monotonic() + 30
        while not (_quiet(a) and held) and time.monotonic() < deadline:
            await asyncio.sleep(0.001)
        in_flight = pipe._in_flight
        blob = await a.export_snapshot_bytes(layout=layout)
        gate.set()
        await pending
        pipe._complete_sync_one = fetch
        await b.restore_snapshot_bytes(blob)
        restored = b.engine.export_state(layout="int64")
        want = await _serve(a, batches[13:])
        got = await _serve(b, batches[13:])
        sa = await a.export_snapshot(layout="int64")
        sb = await b.export_snapshot(layout="int64")
        a.close()
        b.close()
        return in_flight, snapmod.loads(blob), restored, want, got, sa, sb

    in_flight, snap, restored, want, got, sa, sb = asyncio.run(run())
    assert in_flight > 0, "no drain was in flight at the snapshot"
    for name in snap.planes:
        np.testing.assert_array_equal(restored.planes[name],
                                      snap.planes[name])
        np.testing.assert_array_equal(restored.gplanes[name],
                                      snap.gplanes[name])
        np.testing.assert_array_equal(restored.gcfg.get(name, 0),
                                      snap.gcfg.get(name, 0))
    for ta, tb in zip(restored.native_tables, snap.native_tables):
        for x, y in zip(ta, tb):
            np.testing.assert_array_equal(x, y)
    assert restored.gtable[0] == snap.gtable[0]
    assert got == want
    for name in sa.planes:
        np.testing.assert_array_equal(sa.planes[name], sb.planes[name])
        np.testing.assert_array_equal(sa.gplanes[name], sb.gplanes[name])


def test_instance_restore_then_serve_equals_twin():
    """Save between two halves of a pipelined stream; a restored Instance
    and the uninterrupted one answer every later RPC alike, GLOBAL items
    included, and end with equal arenas."""
    conf = EngineConfig(num_shards=2, capacity_per_shard=256,
                        batch_per_shard=32, global_capacity=16,
                        global_batch_per_shard=8, max_global_updates=8)
    batches = _stream(33, 24)

    async def run():
        a = Instance(engine_config=conf, device="cpu")
        await _serve(a, batches[:12])
        blob = await a.export_snapshot_bytes(layout="compact32")
        b = Instance(engine_config=conf, device="cpu")
        await b.restore_snapshot_bytes(blob)
        want = await _serve(a, batches[12:])
        got = await _serve(b, batches[12:])
        sa = await a.export_snapshot(layout="int64")
        sb = await b.export_snapshot(layout="int64")
        a.close()
        b.close()
        return want, got, sa, sb

    want, got, sa, sb = asyncio.run(run())
    assert got == want
    assert any(r[-1] == "" and r[0] == 0 for batch in got for rpc in batch
               for r in rpc)
    for name in sa.planes:
        np.testing.assert_array_equal(sa.planes[name], sb.planes[name])
        np.testing.assert_array_equal(sa.gplanes[name], sb.gplanes[name])


def test_instance_drops_lease_rows_with_a_warning(caplog):
    """A snapshot's lease rows restore into the Instance's lease book (the
    JAX Instance's restore, service.py:822-823), with no warning that they
    were dropped; the arena restores beside them."""
    eng = _mk_engine(num_shards=1)
    eng.process([RateLimitReq(name="l", unique_key="k", hits=1, limit=5,
                              duration=60_000)], now=T0)
    snap = eng.export_state(now=T0 + 1)
    snap.leases = [("l_k", "client-a", 1, T0 + 60_000)]
    blob = snapmod.dumps(snap)
    inst = Instance(engine=_mk_engine(num_shards=1))
    try:
        with caplog.at_level(logging.WARNING, "gubernator.service"):
            n = asyncio.run(inst.restore_snapshot_bytes(blob))
        assert n == 1
        assert not any("lease" in r.getMessage() for r in caplog.records)
        assert inst.leases.export_rows() == [("l_k", "client-a", 1,
                                              T0 + 60_000)]
        out = inst.engine.process(
            [RateLimitReq(name="l", unique_key="k", hits=1, limit=5,
                          duration=60_000)], now=T0 + 2)
        assert out[0].remaining == 3
    finally:
        inst.close()
