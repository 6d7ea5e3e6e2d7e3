"""The traffic generator: determinism from the seed, the shapes of its
draws and rules, one caller per key, and the wire codec."""

import json

import numpy as np
import pytest

from portbench import loadgen, manifest, wire
from portbench.harness import decode

T = 1_754_000_000_000


def keyspace(name, count=None):
    cfg = manifest.load_cell(name).config
    if count is not None:
        cfg["keys"]["count"] = count
    return loadgen.Keyspace(cfg)


closed = manifest.piece("drivers", "closed_loop")


def closed_pool(ks, items, seed, per_caller, groups=8):
    return closed.pool(ks, items, np.random.default_rng(seed), "wire",
                       groups, 1.0, items_per_caller=per_caller)


def test_closed_pool_is_the_seeds():
    ks = keyspace("lb-1m-zipf.sat")
    a = closed_pool(ks, 1000, 7, 2000)
    b = closed_pool(ks, 1000, 7, 2000)
    c = closed_pool(ks, 1000, 8, 2000)
    assert a.datas == b.datas and a.streams == b.streams
    assert a.datas != c.datas
    assert [len(i) for i in a.idx] == [len(i) for i in c.idx]


def test_one_caller_per_key():
    ks = keyspace("mixed-10m.sat")
    pool = closed_pool(ks, 100, 1, 5000)
    seen = {}
    for c, stream in enumerate(pool.streams):
        assert len(stream) == 50
        for e in stream:
            assert pool.group[e] == c
            assert (pool.idx[e] % 8 == c).all()
            for k in np.unique(pool.idx[e]).tolist():
                assert seen.setdefault(k, c) == c


def test_zipf_draw_shape():
    ks = keyspace("lb-1m-zipf.sat")
    n = 400_000
    idx = ks.draw_keys(np.random.default_rng(3), n)
    ranks = np.arange(1, ks.count + 1, dtype=np.float64)
    p = ranks ** -1.1 / (ranks ** -1.1).sum()
    counts = np.bincount(idx, minlength=ks.count)
    for r in (0, 1, 9):
        assert counts[r] / n == pytest.approx(p[r], rel=0.03)
    assert idx.min() >= 0 and idx.max() < ks.count
    # conditioned on a group, the draw keeps the group's own weights
    g = ks.draw_keys(np.random.default_rng(4), n, 1, 8)
    assert (g % 8 == 1).all()
    w = p[1::8] / p[1::8].sum()
    assert np.bincount(g // 8)[0] / n == pytest.approx(w[0], rel=0.03)


def test_uniform_draw_shape():
    ks = keyspace("mixed-10m.sat")
    n = 500_000
    idx = ks.draw_keys(np.random.default_rng(5), n)
    assert idx.min() >= 0 and idx.max() < ks.count
    tenths = np.bincount(idx * 10 // ks.count, minlength=10) / n
    assert np.allclose(tenths, 0.1, atol=0.004)
    assert np.array_equal(ks.algos(np.arange(6)), [0, 1, 0, 1, 0, 1])
    assert (keyspace("lb-1m-zipf.sat").algos(np.arange(6)) == 1).all()


def test_unknown_keys_and_parameters_are_refused():
    cfg = manifest.load_cell("mixed-10m.sat").config
    for change in (lambda k: k.update(zipf_a=1.1),
                   lambda k: k["draw"].update(a=1.1),
                   lambda k: k["limit"].update(step=2),
                   lambda k: k["algorithm"].update(rule="nonesuch")):
        bad = json.loads(json.dumps(cfg))
        change(bad["keys"])
        with pytest.raises((ValueError, TypeError, KeyError)):
            loadgen.Keyspace(bad)


def test_rules_compute_each_keys_values():
    ks = keyspace("mixed-10m.sat")
    idx = np.arange(6)
    assert ks.limits(np.array([0, 49, 50, 123])).tolist() == [20, 69, 20, 43]
    assert ks.behaviors(idx).tolist() == [0] * 6
    cfg = manifest.load_cell("mixed-10m.sat").config
    cfg["keys"]["behavior"] = dict(rule="parity", even=0, odd=1)
    assert loadgen.Keyspace(cfg).behaviors(idx).tolist() == [0, 1] * 3


def test_fill_pool_holds_every_key_once():
    ks = keyspace("mixed-10m.sat", count=20_000)
    pool = loadgen.fill_pool(ks, 1000, "wire", 8)
    idx = np.concatenate(pool.idx)
    assert np.array_equal(np.sort(idx), np.arange(20_000))
    assert all((h == 0).all() for h in pool.hits)
    sizes = [len(i) for i in pool.idx]
    assert max(sizes) <= 1000 and max(sizes) - min(sizes) <= 1


def test_request_bytes_match_the_plain_codec():
    ks = keyspace("mixed-10m.sat")
    idx = np.array([0, 1, 79, 80, 9_999_999, 12345])
    hits = np.array([0, 1, 2, 0, 2, 1])
    datas, _, _ = ks.rpcs(idx, hits, 100, "wire")
    want = wire.encode_list([
        dict(name=f"t{i % 80:02d}", unique_key=f"wire{i:07d}", hits=int(h),
             limit=int(20 + i % 50), duration=60_000, algorithm=int(i & 1))
        for i, h in zip(idx.tolist(), hits.tolist())], wire.REQ_FIELDS)
    assert datas == [want]
    # a behavior the keys state is written as its field 7
    cfg = manifest.load_cell("mixed-10m.sat").config
    cfg["keys"]["behavior"] = dict(rule="constant", value=1)
    datas, _, _ = loadgen.Keyspace(cfg).rpcs(idx, hits, 100, "wire")
    assert [b["behavior"] for b in wire.decode_list(
        datas[0], wire.REQ_FIELDS)] == [1] * len(idx)
    back = wire.decode_list(want, wire.REQ_FIELDS)
    assert [b["unique_key"] for b in back] == [f"wire{i:07d}" for i in idx]
    assert [b["hits"] for b in back] == hits.tolist()


def test_varints_match_the_plain_codec():
    v = np.array([0, 1, 127, 128, 300, 60_000, 2 ** 35, 2 ** 62 + 5])
    vb, lens = wire.varints(v)
    for x, row, n in zip(v.tolist(), vb, lens):
        assert bytes(row[:n]) == wire._varint(x)


def test_response_decode_round_trip():
    rng = np.random.default_rng(9)
    items = [dict(status=int(rng.integers(0, 2)),
                  limit=int(rng.integers(1, 100)),
                  remaining=int(rng.integers(0, 100)),
                  reset_time=int(rng.choice([0, T + int(rng.integers(0, 9))])))
             for _ in range(1000)]
    bodies = [wire.encode_list(items[i:i + 100], wire.RESP_FIELDS)
              for i in range(0, 1000, 100)]
    cols, counts = wire.decode_responses(bodies)
    assert counts.tolist() == [100] * 10
    for c in wire.RESP_COLUMNS:
        assert cols[c].tolist() == [it[c] for it in items]
    # a body with an error string is refused at once and read plainly
    odd = wire.encode_list([dict(items[0], error="boom")], wire.RESP_FIELDS)
    with pytest.raises(ValueError):
        wire.decode_responses(bodies[:1] + [odd])
    cols, counts = decode(bodies[:1] + [odd])
    assert counts.tolist() == [100, 1]
    assert cols["limit"][100] == items[0]["limit"]
    with pytest.raises(ValueError):
        wire.decode_responses([bodies[0][:-1]])
