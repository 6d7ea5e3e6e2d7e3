"""The port's native router (gubernator_tpu_torch/native) against the JAX
package's, call for call.

Both wrap a copy of the same C++ source, built separately (the port's into
its own gitignored build/ directory).  Every test issues the same calls on
a port router and a JAX router and compares every output array and
counter exactly: `pack` (full-format windows, lane overflow, eviction,
expiry), `pack_stack` (K-window compact stacks with aggregated runs, the
replay cap, the stack-full code), `occupancy`, `size` / `hits` /
`misses`, `heap_size`, `export_keys` / `import_keys` and the exact-key
guard.  The unit checks mirror tests/test_native_router.py.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gubernator_tpu import native as jnative
from gubernator_tpu_torch import native

pytestmark = pytest.mark.torch_port

T0 = 1_700_000_000_000
ROOT = Path(__file__).resolve().parents[1]


def _routers(S=1, C=8, exact=False, cap=None):
    pair = (native.NativeRouter(S, C), jnative.NativeRouter(S, C))
    for r in pair:
        if exact:
            r.set_exact_keys()
        if cap is not None:
            r.set_replay_cap(cap)
    return pair


def _cols(keys, hits=1, limit=5, duration=1000, algo=0):
    n = len(keys)
    kb = np.frombuffer(b"".join(keys), dtype=np.uint8)
    ends = np.cumsum([len(k) for k in keys]).astype(np.int64)
    full = lambda v, dt: np.broadcast_to(np.asarray(v, dt), (n,)).copy()  # noqa: E731
    return (kb, ends, full(hits, np.int64), full(limit, np.int64),
            full(duration, np.int64), full(algo, np.int32))


def _pack(r, keys, now=T0, lanes=8, shards=1, commit=True, **kw):
    """One router_pack window; returns (packed, every output array)."""
    cols = _cols(keys, **kw)
    n = len(keys)
    outs = (np.full((shards, lanes), -1, np.int32),
            np.zeros((shards, lanes), np.int64),
            np.zeros((shards, lanes), np.int64),
            np.zeros((shards, lanes), np.int64),
            np.zeros((shards, lanes), np.int32),
            np.zeros((shards, lanes), np.uint8),
            np.zeros(n, np.int32), np.zeros(n, np.int32),
            np.zeros(shards, np.int32))
    packed = r.pack(*cols, now, lanes, *outs)
    if commit:
        r.commit()
    return packed, outs


def _same_pack(pair, keys, **kw):
    (pa, oa), (pb, ob) = (_pack(r, keys, **kw) for r in pair)
    assert pa == pb
    for a, b in zip(oa, ob):
        np.testing.assert_array_equal(a, b)
    _same_counters(pair)
    return pa, oa


def _same_counters(pair, now=T0):
    a, b = pair
    assert (a.size, a.hits, a.misses) == (b.size, b.hits, b.misses)
    assert a.occupancy(now) == b.occupancy(now)
    for s in range(a.num_shards):
        assert a.heap_size(s) == b.heap_size(s)


def test_library_builds_into_the_build_dir_and_leaves_the_source_clean():
    assert native.available() and native.build_error() is None
    assert native.LIBRARY.parent == ROOT / "gubernator_tpu_torch" / "build"
    assert native.LIBRARY.is_file()
    src_dir = ROOT / "gubernator_tpu_torch" / "native"
    assert sorted(p.name for p in src_dir.iterdir()
                  if p.name != "__pycache__") == ["__init__.py",
                                                  "host_router.cc"]


def test_build_is_atomic_and_reports_gxx_errors(tmp_path):
    """A fresh build goes through a per-process temp name renamed into
    place; a source g++ rejects raises with g++'s output and leaves no
    library and no temp file behind."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from gubernator_tpu_torch import native as n\n"
        "n.BUILD_DIR = Path(sys.argv[1])\n"
        "n.LIBRARY = n.BUILD_DIR / 'libhost_router.so'\n"
        "if len(sys.argv) > 2:\n"
        "    n.SOURCE = Path(sys.argv[2])\n"
        "print(n.available(), (n.build_error() or '')[:400].replace('\\n', ' '))\n"
        "print(sorted(p.name for p in n.BUILD_DIR.iterdir()))\n")
    good = subprocess.run([sys.executable, "-c", code, str(tmp_path / "ok")],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    assert good.returncode == 0, good.stderr
    ok, files = good.stdout.splitlines()
    assert ok.startswith("True") and files == "['libhost_router.so']"
    bad_src = tmp_path / "bad.cc"
    bad_src.write_text("this is not C++\n")
    bad = subprocess.run([sys.executable, "-c", code, str(tmp_path / "bad"),
                          str(bad_src)], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert bad.returncode == 0, bad.stderr
    status, files = bad.stdout.splitlines()
    assert status.startswith("False g++ failed") and "bad.cc" in status
    assert files == "[]"


def test_lru_eviction_order():
    pair = _routers(1, 4)
    keys = [f"n_k{i}".encode() for i in range(4)]
    _same_pack(pair, keys)
    _same_pack(pair, [keys[0]])            # k0 MRU, k1 LRU
    _same_pack(pair, [b"n_new1", b"n_new2"])  # evict k1, then k2
    _, outs = _same_pack(pair, [keys[0], keys[3]])
    assert outs[5].reshape(-1)[:2].tolist() == [0, 0]
    _, outs = _same_pack(pair, [keys[1]])
    assert outs[5][outs[6][0], outs[7][0]] == 1  # was evicted


def test_lane_overflow_partial_pack():
    pair = _routers(1, 64)
    packed, _ = _same_pack(pair, [f"n_k{i}".encode() for i in range(10)],
                           lanes=4)
    assert packed == 4


def test_expiry_counts_miss_but_keeps_slot():
    pair = _routers(1, 8)
    _, first = _same_pack(pair, [b"n_a"], duration=10)
    h0, m0 = pair[0].hits, pair[0].misses
    _, again = _same_pack(pair, [b"n_a"], now=T0 + 100, duration=10)
    assert pair[0].misses == m0 + 1 and pair[0].hits == h0
    assert again[0].max() == first[0].max()  # same slot


def test_uncommitted_pack_stays_init_pending_until_commit():
    pair = _routers(1, 8)
    _same_pack(pair, [b"n_p"], commit=False)
    _, outs = _same_pack(pair, [b"n_p"], commit=False)
    assert outs[5][0, 0] == 1  # still reported as a fresh allocation
    _, outs = _same_pack(pair, [b"n_p"])
    assert outs[5][0, 0] == 1
    _, outs = _same_pack(pair, [b"n_p"])
    assert outs[5][0, 0] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_pack_windows_with_shards_and_churn(seed):
    rng = np.random.default_rng(seed)
    pair = _routers(4, 16)
    now = T0
    for _ in range(12):
        keys = [f"r{int(rng.integers(0, 90))}".encode()
                for _ in range(int(rng.integers(1, 40)))]
        _same_pack(pair, keys, now=now, lanes=8, shards=4,
                   duration=int(rng.choice([5, 100, 10_000])))
        now += int(rng.choice([0, 3, 50]))
    _same_counters(pair, now)


def _stack(r, cols, K=4, S=2, B=8, now=T0, begin=True):
    if begin:
        r.drain_begin()
    packed = np.zeros((K, S, B, 2), np.int64)
    kcur = np.zeros(S, np.int32)
    fills = np.zeros((K, S), np.int32)
    n = len(cols[1])
    row, lane, pos = (np.zeros(n, np.int32) for _ in range(3))
    rc = r.pack_stack(*cols, now, B, K, packed, kcur, fills, row, lane, pos)
    return rc, (packed, kcur, fills, row, lane, pos)


@pytest.mark.parametrize("cap", [None, 2, 0])
def test_pack_stack_aggregates_runs_and_cuts_windows(cap):
    """A K-window stack from the same columns: AGG runs (hits=1 duplicates
    fold into one lane, their items carry run positions), runs with other
    hits, leaky runs (out_pos bit 30), a mixed-config run cut by the
    replay cap, and the stack-full code -6 once nothing more fits."""
    pair = _routers(2, 32, cap=cap)
    keys = ([b"hot"] * 9 + [b"lk"] * 3 + [b"mix"] * 5
            + [f"u{i}".encode() for i in range(12)])
    hits = [1] * 9 + [1] * 3 + [1, 2, 1, 3, 1] + [2] * 12
    limit = [5] * 9 + [4] * 3 + [6, 6, 7, 6, 6] + [9] * 12
    algo = [0] * 9 + [1] * 3 + [0] * 5 + [1] * 12
    n = len(keys)
    cols = _cols(keys)
    cols = cols[:2] + (np.asarray(hits, np.int64), np.asarray(limit, np.int64),
                       np.full(n, 60_000, np.int64),
                       np.asarray(algo, np.int32))
    a, b = (_stack(r, cols) for r in pair)
    assert a[0] == b[0] == n
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    pos = a[1][5]
    assert (pos[1:9] >= 0).all() and ((pos[9:12] >> 30) & 1).all()
    for r in pair:
        r.commit()
    _same_counters(pair)
    # a stack with no room: -6, nothing staged
    flood = _cols([f"f{i}".encode() for i in range(40)], hits=2)
    a, b = (_stack(r, flood, K=1, B=4) for r in pair)
    assert a[0] == b[0] == -6
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    for r in pair:
        r.abort()
    _same_counters(pair)


def test_pack_stack_out_of_range_and_abort():
    pair = _routers(1, 8)
    bad = _cols([b"x"], limit=1 << 40)
    a, b = (_stack(r, bad, S=1) for r in pair)
    assert a[0] == b[0] == -2
    cols = _cols([b"a", b"b"])
    a, b = (_stack(r, cols, S=1) for r in pair)
    for r in pair:
        r.abort()   # the dispatch failed: the slots stay init-pending
    a, b = (_stack(r, cols, S=1) for r in pair)
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    for r in pair:
        r.commit()
    _same_counters(pair)


def test_export_import_keys_round_trip():
    pair = _routers(2, 16)
    _same_pack(pair, [f"e{i}".encode() for i in range(20)], lanes=16,
               shards=2, duration=500)
    for s in range(2):
        got = pair[0].export_keys(s)
        want = pair[1].export_keys(s)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    fresh = _routers(2, 16)
    for s in range(2):
        for r in fresh:
            r.import_keys(s, *pair[1].export_keys(s))
    _same_counters(fresh)
    _same_pack(fresh, [f"e{i}".encode() for i in range(20)], lanes=16,
               shards=2, duration=500)
    with pytest.raises(ValueError):
        fresh[0].import_keys(0, np.array([1, 2], np.uint64),
                             np.array([3, 3], np.int32),
                             np.array([T0, T0], np.int64))


def test_exact_key_guard_matches_and_refuses_a_fingerprint_import():
    pair = _routers(1, 16, exact=True)
    assert pair[0].exact
    rng = np.random.default_rng(5)
    now = T0
    for _ in range(8):
        keys = [f"xk{int(rng.integers(0, 30))}".encode()
                for _ in range(int(rng.integers(1, 12)))]
        _same_pack(pair, keys, now=now, lanes=16, duration=50)
        now += int(rng.choice([0, 1, 60]))
    with pytest.raises(RuntimeError, match="exact-keys"):
        pair[0].import_keys(0, *pair[0].export_keys(0))


def test_unavailable_router_raises_when_required(monkeypatch):
    """use_native="on" raises with the build's error; "auto" falls back to
    the Python tables."""
    from gubernator_tpu_torch.core.engine import RateLimitEngine
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "g++ failed (1): no compiler")
    with pytest.raises(RuntimeError, match="no compiler"):
        RateLimitEngine(capacity_per_shard=8, batch_per_shard=8,
                        device="cpu", use_native="on")
    eng = RateLimitEngine(capacity_per_shard=8, batch_per_shard=8,
                          device="cpu", use_native="auto")
    assert eng.native is None and len(eng.tables) == 1


def _wire(n, name="clk"):
    """A GetRateLimitsReq of n items in protobuf's wire bytes."""
    from gubernator_tpu_torch.api import pb
    return pb.GetRateLimitsReq(requests=[
        pb.RateLimitReq(name=name, unique_key=f"k{i}", hits=1, limit=10,
                        duration=60_000) for i in range(n)]
    ).SerializeToString()


@pytest.mark.parametrize("n", [1, 300])
def test_router_clocks_time_the_c_work_within_the_binding(n):
    """parse_stack_fast, fastpath_parse_stack, fastpath_encode_w and
    fastpath_encode_parts each add their C work's own nanoseconds (> 0
    for a non-empty RPC) and the binding's wall around it (at least the C
    time) to the RouterClock the caller passes."""
    from gubernator_tpu_torch.core.window_buffers import WindowArena
    K, S, B = 8, 2, 1024
    r = native.NativeRouter(S, 1 << 12)
    arena = WindowArena(K, S, B)
    clock = native.RouterClock()
    data = _wire(n)

    def parsed(parse):
        c0, w0 = clock.parse_c, clock.parse_wall
        got = parse()
        assert got == n
        assert 0 < clock.parse_c - c0 <= clock.parse_wall - w0
        return got

    r.drain_begin()
    scr = arena.acquire_scratch()
    parsed(lambda: r.parse_stack_fast(data, T0, B, K, 1000, arena, scr,
                                      clock=clock))
    r.commit()
    packed = np.zeros((K, S, B, 2), np.int64)
    kcur = np.zeros(S, np.int32)
    fill = np.zeros((K, S), np.int32)
    row, lane, pos, mlen = (np.zeros(1000, np.int32) for _ in range(4))
    limit, off = np.zeros(1000, np.int64), np.zeros(1000, np.int64)
    r.drain_begin()
    parsed(lambda: r.fastpath_parse_stack(data, T0, B, K, 1000, packed, kcur,
                                          fill, row, lane, pos, limit, off,
                                          mlen, clock=clock))
    r.commit()
    words = np.zeros((K * S, B), np.int64)
    buf = np.empty(n * 64 + 64, np.uint8)
    for encode in (
            lambda: r.fastpath_encode_w(words, limit, T0, B, n, row, lane,
                                        pos, buf, clock=clock),
            lambda: r.fastpath_encode_parts(
                words, limit, T0, B, n, row, lane, pos, buf,
                np.empty(n, np.int64), np.empty(n, np.int32),
                clock=clock)):
        c0, w0 = clock.encode_c, clock.encode_wall
        assert encode() > 0
        assert 0 < clock.encode_c - c0 <= clock.encode_wall - w0


def test_router_clocks_sum_only_into_the_clock_passed():
    """A call with no clock reads no clock; a call with one sums into it
    alone, the C time and the wall of each call added up."""
    r = native.NativeRouter(1, 64)
    words = np.zeros((1, 8), np.int64)
    z32 = np.zeros(4, np.int32)
    mine, other = native.RouterClock(), native.RouterClock()

    def encode(**kw):
        return r.fastpath_encode_w(words, np.full(4, 5, np.int64), T0, 8, 4,
                                   z32, z32, np.full(4, -1, np.int32),
                                   np.empty(512, np.uint8), **kw)

    assert encode() > 0
    assert mine.slot.value == 0 and mine.encode_c == mine.encode_wall == 0
    encode(clock=mine)
    first = (mine.encode_c, mine.encode_wall)
    assert 0 < first[0] <= first[1]
    encode(clock=mine)
    assert mine.encode_c > first[0] and mine.encode_wall > first[1]
    assert mine.encode_c <= mine.encode_wall
    assert other.encode_c == other.encode_wall == 0
    assert mine.parse_c == mine.parse_wall == 0
