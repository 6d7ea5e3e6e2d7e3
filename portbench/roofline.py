"""Peaks of one NVIDIA H100 SXM and the least time a drain's work needs.

HBM_BYTES_PER_S is NVIDIA's data sheet figure at the full 700 W power
limit.  INT32_OPS_PER_S is assumed, not published: 64 INT32 lanes an SM a
clock (the H100 architecture white paper) x 132 SMs x the 1.98 GHz boost
clock.

The work is counted from the traffic sent, never from the kernel's launch
plan, each byte the inputs need once: per distinct (key, drain) one
request lane in and one response out, the key's arena row read once, and
the row's planes that its hits change written once.  On this work the
bytes bound, not the operations: ~92-100 bytes against ~300 operations.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# a lane of the compact drain: a 16-byte request word pair in, a response
# word and a stored limit (8 + 8 bytes) out
LANE_IN_BYTES, LANE_OUT_BYTES = 16, 16
# an arena row: limit, duration, remaining, tstamp and expire (int64) and
# the algorithm (int32)
ROW_BYTES = 5 * 8 + 4
# the planes a hit changes, by algorithm: a token bucket's remaining (an
# over-ask changes nothing, so where every hit of a (key, drain) is over
# its limit this counts 8 bytes too many); a leaky bucket's remaining and
# tstamp.  A read (hits 0) changes nothing.
WRITE_BYTES = {0: 8, 1: 16}
# 32-bit operations a (key, drain) needs at least: the lane's decode and
# encode (~40), ~100 int64 operations of the bucket ladder (~200 in
# 32-bit units), and two int64 divisions of ~30 32-bit instructions each
OPS_PER_ROW = 40 + 200 + 2 * 30


def row_work(idx, hits, algos):
    """(distinct keys, arena bytes their hits change) of one RPC's items:
    key indices, hits and each item's algorithm."""
    keys, first, inv = np.unique(idx, return_index=True,
                                 return_inverse=True)
    hit = np.bincount(inv, weights=np.asarray(hits) != 0,
                      minlength=len(keys)) > 0
    algo = np.asarray(algos)[first][hit]
    return len(keys), sum(WRITE_BYTES[int(a)] * int(n)
                          for a, n in zip(*np.unique(algo,
                                                     return_counts=True)))


def drain_bound_s(rows: int, write_bytes: int) -> float:
    """The least device seconds for `rows` (distinct key, drain) pairs
    whose hits change `write_bytes` of the arena: the larger of the bytes
    at the memory rate and the integer work at the assumed integer
    rate."""
    nbytes = rows * (LANE_IN_BYTES + LANE_OUT_BYTES + ROW_BYTES) \
        + write_bytes
    return max(nbytes / HBM_BYTES_PER_S, rows * OPS_PER_ROW / INT32_OPS_PER_S)


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in
    microseconds: overlapping copies and kernels count once."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total / 1e6
