"""Token and leaky bucket in plain Python integers: the benchmark's
reference for what the program must answer.

A frozen copy of the gubernator semantics the program states (one row per
key: limit, duration, remaining, tstamp, expire, algorithm), with its
constants written out, for the two algorithms the benchmark's cells
serve.  It imports nothing of the program.  Shared rules:

  * hits == 0 is a read: a token row is left as it is, a leaky row takes
    its leak into `remaining` but keeps its tstamp;
  * an over-ask (hits above what is available) is refused and changes
    nothing;
  * a leaky rate is stored duration // request limit, at least 1 ms;
  * a missing row, an expired one (expire < now) or one of another
    algorithm starts afresh.
"""

from __future__ import annotations

import numpy as np

TOKEN_BUCKET, LEAKY_BUCKET = 0, 1
# the algorithms this reference answers, and the behaviors under which a
# node with no peers answers as it does: BATCHING (0) and NO_BATCHING (1)
ALGORITHMS = (TOKEN_BUCKET, LEAKY_BUCKET)
BEHAVIORS = (0, 1)
UNDER_LIMIT, OVER_LIMIT = 0, 1
# a row: [limit, duration, remaining, tstamp, expire, algorithm]
ROW_FIELDS = ("limit", "duration", "remaining", "tstamp", "expire", "algo")


def apply(row, hits, limit, duration, algo, now):
    """One request against one row (a list, changed in place, or None for
    a missing row).  Returns (row, (status, limit, remaining,
    reset_time))."""
    if row is None or row[4] < now or row[5] != algo:
        over = hits > limit
        remaining = 0 if over else limit - hits
        if algo == LEAKY_BUCKET:
            row = [limit, duration, remaining, now, now + duration, algo]
            reset = 0
        else:
            row = [limit, duration, remaining, now + duration,
                   now + duration, algo]
            reset = now + duration
        return row, (OVER_LIMIT if over else UNDER_LIMIT, limit, remaining,
                     reset)
    lim = row[0]
    if algo == LEAKY_BUCKET:
        rate = max(row[1] // max(limit, 1), 1)
        leak = (now - row[3]) // rate
        r2 = row[2] + min(leak, lim - row[2])
        row[2] = r2
        if hits != 0:
            row[3] = now
        if r2 == 0:
            return row, (OVER_LIMIT, lim, 0, now + rate)
        if hits == r2:
            row[2] = 0
            return row, (UNDER_LIMIT, lim, 0, 0)
        if hits > r2:
            return row, (OVER_LIMIT, lim, r2, now + rate)
        if hits == 0:
            return row, (UNDER_LIMIT, lim, r2, 0)
        row[2] = r2 - hits
        row[4] = now + duration
        return row, (UNDER_LIMIT, lim, r2 - hits, 0)
    r = row[2]
    if r == 0:
        return row, (OVER_LIMIT, lim, 0, row[3])
    if hits == 0:
        return row, (UNDER_LIMIT, lim, r, row[3])
    if hits == r:
        row[2] = 0
        return row, (UNDER_LIMIT, lim, 0, row[3])
    if hits > r:
        return row, (OVER_LIMIT, lim, r, row[3])
    row[2] = r - hits
    return row, (UNDER_LIMIT, lim, r - hits, row[3])


def replay(key, hits, limit, duration, algo, now, rows=None):
    """Apply requests in order (parallel int64 arrays, one entry a
    request), each key's row kept in `rows` (key -> row; a new dict when
    None).  Returns (int64 [n, 4] answers: status, limit, remaining,
    reset_time; rows).

    A key's first request while it has no row starts the row, whatever
    came before it of other keys: those are worked out at once (apply's
    first branch, in numpy); the rest run through apply in order."""
    rows = {} if rows is None else rows
    n = len(key)
    out = np.empty((n, 4), np.int64)
    _, first = np.unique(key, return_index=True)
    fresh = first[np.array([rows.get(k) is None
                            for k in key[first].tolist()], bool)]
    if len(fresh):
        h, lim, d, a, t = (x[fresh] for x in (hits, limit, duration, algo,
                                                now))
        over = h > lim
        remaining = np.where(over, 0, lim - h)
        leaky = a == LEAKY_BUCKET
        out[fresh] = np.stack([over.astype(np.int64), lim, remaining,
                               np.where(leaky, 0, t + d)], 1)
        for k, row in zip(key[fresh].tolist(), zip(
                lim.tolist(), d.tolist(), remaining.tolist(),
                np.where(leaky, t, t + d).tolist(), (t + d).tolist(),
                a.tolist())):
            rows[k] = list(row)
    rest = np.ones(n, bool)
    rest[fresh] = False
    at = np.flatnonzero(rest)
    res = []
    get = rows.get
    for k, h, lim, d, a, t in zip(key[at].tolist(), hits[at].tolist(),
                                  limit[at].tolist(), duration[at].tolist(),
                                  algo[at].tolist(), now[at].tolist()):
        row, resp = apply(get(k), h, lim, d, a, t)
        rows[k] = row
        res.append(resp)
    if res:
        out[at] = np.array(res, np.int64)
    return out, rows
