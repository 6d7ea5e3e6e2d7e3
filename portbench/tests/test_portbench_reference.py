"""The reference (reference/buckets.py) against hand-worked token and
leaky bucket sequences, and its replay against apply one by one."""

import numpy as np
import pytest

from portbench.reference import buckets

T = 1_754_000_000_000
TOKEN, LEAKY = buckets.TOKEN_BUCKET, buckets.LEAKY_BUCKET
UNDER, OVER = buckets.UNDER_LIMIT, buckets.OVER_LIMIT


def run(seq, algo, limit=5, duration=10_000):
    """Answers of (hits, now) requests on one key."""
    row, out = None, []
    for hits, now in seq:
        row, resp = buckets.apply(row, hits, limit, duration, algo, now)
        out.append(resp)
    return out, row


def test_token_bucket_hand_worked():
    out, row = run([(2, T), (0, T + 1), (3, T + 2), (1, T + 3), (0, T + 4),
                    (1, T + 10_001)], TOKEN)
    reset = T + 10_000
    assert out == [
        (UNDER, 5, 3, reset),        # a new bucket takes 2 of 5
        (UNDER, 5, 3, reset),        # hits 0 reads
        (UNDER, 5, 0, reset),        # takes what is left
        (OVER, 5, 0, reset),         # empty
        (OVER, 5, 0, reset),         # a read of an empty bucket
        (UNDER, 5, 4, T + 20_001),   # expired: a new bucket
    ]
    assert row == [5, 10_000, 4, T + 20_001, T + 20_001, TOKEN]


def test_token_over_ask_changes_nothing():
    out, row = run([(3, T), (4, T + 1), (2, T + 2), (6, T + 3)], TOKEN)
    assert out[1] == (OVER, 5, 2, T + 10_000)   # asks 4 of 2: refused
    assert out[2] == (UNDER, 5, 0, T + 10_000)  # the 2 are still there
    assert out[3] == (OVER, 5, 0, T + 10_000)
    assert run([(6, T)], TOKEN)[0] == [(OVER, 5, 0, T + 10_000)]


def test_leaky_bucket_hand_worked():
    # rate = 10000 // 5 = 2000 ms a request
    out, row = run([(3, T), (2, T + 1000), (1, T + 1999), (0, T + 4000),
                    (1, T + 4001), (3, T + 5000)], LEAKY)
    assert out == [
        (UNDER, 5, 2, 0),               # new: 5 - 3
        (UNDER, 5, 0, 0),               # nothing leaked yet; takes the 2
        (OVER, 5, 0, T + 1999 + 2000),  # empty; a hit still moves tstamp
        (UNDER, 5, 1, 0),               # a read: 2001 ms since T+1999 leak 1
        (UNDER, 5, 1, 0),               # the same 1 leaks again (tstamp
                                        # kept by the read): 2 - 1
        (OVER, 5, 1, T + 5000 + 2000),  # asks 3 of 1: refused
    ]
    assert row[2] == 1 and row[3] == T + 5000 and row[4] == T + 14_001


def test_leaky_read_keeps_tstamp_and_expire():
    row, _ = buckets.apply(None, 4, 5, 10_000, LEAKY, T)
    assert row == [5, 10_000, 1, T, T + 10_000, LEAKY]
    row, resp = buckets.apply(row, 0, 5, 10_000, LEAKY, T + 4000)
    assert resp == (UNDER, 5, 3, 0)
    assert row == [5, 10_000, 3, T, T + 10_000, LEAKY]
    # the next hit leaks again from the kept tstamp, up to the limit
    row, resp = buckets.apply(row, 1, 5, 10_000, LEAKY, T + 4000)
    assert resp == (UNDER, 5, 4, 0) and row[3] == T + 4000
    assert row[4] == T + 14_000


def test_algorithm_switch_and_expiry_start_afresh():
    row, _ = buckets.apply(None, 1, 5, 10_000, TOKEN, T)
    row, resp = buckets.apply(row, 1, 5, 10_000, LEAKY, T + 1)
    assert resp == (UNDER, 5, 4, 0) and row[5] == LEAKY
    row, resp = buckets.apply(row, 2, 5, 10_000, LEAKY, T + 10_002)
    assert resp == (UNDER, 5, 3, 0) and row[3] == T + 10_002


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_equals_apply_in_order(seed):
    rng = np.random.default_rng(seed)
    n = 20_000
    key = rng.integers(0, 500, n)
    hits = rng.choice([0, 1, 2, 7, 80], n)
    limit = 20 + key % 50
    dur = np.full(n, 5_000)
    algo = key & 1
    now = T + np.cumsum(rng.integers(0, 3, n))
    got, rows = buckets.replay(key, hits, limit, dur, algo, now)
    want_rows, want = {}, []
    for args in zip(key.tolist(), hits.tolist(), limit.tolist(),
                    dur.tolist(), algo.tolist(), now.tolist()):
        row, resp = buckets.apply(want_rows.get(args[0]), *args[1:])
        want_rows[args[0]] = row
        want.append(resp)
    assert np.array_equal(got, np.array(want))
    assert rows == want_rows
