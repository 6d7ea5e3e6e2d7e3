"""Serial per-algorithm oracles in plain python integers.

These mirror ops/kernel.py transition() branch for branch but share no code
with it (only the format constants), so the differential suites compare two
independent derivations of the same reference semantics.  Every function
takes one request against one stored row and returns the new row plus the
response tuple — exactly what a single-lane device window computes.

Shared contracts (carried from the reference, see ops/kernel.py docstring):
  * hits == 0 is a read and never mutates state;
  * an over-ask (hits > available) rejects WITHOUT mutating;
  * rate / emission interval = stored duration // REQUEST limit, clamped
    to >= 1ms where the reference would divide by zero;
  * out-of-range algorithm values fall back to token bucket
    (algorithms.go:100-104).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from gubernator_tpu_torch.ops.kernel import (
    CONCURRENCY,
    GCRA,
    LEAKY_BUCKET,
    OVER_LIMIT,
    SLIDING_MAX_LIMIT,
    SLIDING_PACK_BITS,
    SLIDING_WINDOW,
    SLIDING_WEIGHT_Q,
    TOKEN_BUCKET,
    UNDER_LIMIT,
)

ALGORITHM_NAMES = {
    TOKEN_BUCKET: "token_bucket",
    LEAKY_BUCKET: "leaky_bucket",
    GCRA: "gcra",
    SLIDING_WINDOW: "sliding_window",
    CONCURRENCY: "concurrency",
}


@dataclass
class Row:
    """One arena row (the SoA columns of a single slot)."""

    limit: int
    duration: int
    remaining: int
    tstamp: int
    expire: int
    algo: int


# response: (status, limit, remaining, reset_time)
Resp = Tuple[int, int, int, int]


def _init(hits: int, limit: int, duration: int, algo: int,
          now: int) -> Tuple[Row, Resp]:
    """Cache-miss path: algorithms.go:68-84 / :161-185 plus the three new
    stored shapes.  The default image is the token one, so out-of-range
    algorithms degrade to token here too."""
    rate_q = max(duration // max(limit, 1), 1)
    sl_l0 = min(limit, SLIDING_MAX_LIMIT)
    eff = sl_l0 if algo == SLIDING_WINDOW else limit
    conc_rel0 = algo == CONCURRENCY and hits < 0
    over = hits > eff and not conc_rel0
    if conc_rel0:
        resp_r = eff  # release with nothing held: full bucket
    elif over:
        resp_r = 0
    else:
        resp_r = eff - hits
    if algo in (LEAKY_BUCKET, SLIDING_WINDOW, CONCURRENCY):
        tstamp = now
    elif algo == GCRA:
        tstamp = now + duration if over else now + hits * rate_q
    else:
        tstamp = now + duration
    if algo == SLIDING_WINDOW:
        store_r = sl_l0 if over else max(hits, 0)
    else:
        store_r = resp_r
    if algo in (LEAKY_BUCKET, CONCURRENCY):
        reset = 0
    elif algo == GCRA:
        reset = now + rate_q if over else now + hits * rate_q
    else:
        reset = now + duration
    row = Row(limit=limit, duration=duration, remaining=store_r,
              tstamp=tstamp, expire=now + duration, algo=algo)
    status = OVER_LIMIT if over else UNDER_LIMIT
    return row, (status, limit, resp_r, reset)


def _token_hit(row: Row, h: int, now: int) -> Tuple[Row, Resp]:
    R = row.remaining
    if R == 0:
        return row, (OVER_LIMIT, row.limit, 0, row.tstamp)
    if h == 0:
        return row, (UNDER_LIMIT, row.limit, R, row.tstamp)
    if h == R:
        row.remaining = 0
        return row, (UNDER_LIMIT, row.limit, 0, row.tstamp)
    if h > R:
        return row, (OVER_LIMIT, row.limit, R, row.tstamp)
    row.remaining = R - h
    return row, (UNDER_LIMIT, row.limit, R - h, row.tstamp)


def _leaky_hit(row: Row, h: int, req_limit: int, req_duration: int,
               now: int) -> Tuple[Row, Resp]:
    rate = max(row.duration // max(req_limit, 1), 1)
    leak = (now - row.tstamp) // rate
    R2 = row.remaining + min(leak, row.limit - row.remaining)
    row.remaining = R2
    if h != 0:
        row.tstamp = now
    if R2 == 0:
        return row, (OVER_LIMIT, row.limit, 0, now + rate)
    if h == R2:
        row.remaining = 0
        return row, (UNDER_LIMIT, row.limit, 0, 0)
    if h > R2:
        return row, (OVER_LIMIT, row.limit, R2, now + rate)
    if h == 0:
        return row, (UNDER_LIMIT, row.limit, R2, 0)
    row.remaining = R2 - h
    row.expire = now + req_duration
    return row, (UNDER_LIMIT, row.limit, R2 - h, 0)


def _gcra_hit(row: Row, h: int, req_limit: int,
              now: int) -> Tuple[Row, Resp]:
    rate = max(row.duration // max(req_limit, 1), 1)
    base = max(row.tstamp, now)
    cap = min(max((now + row.duration - base) // rate, 0), row.limit)
    if cap == 0:
        return row, (OVER_LIMIT, row.limit, 0, now + rate)
    if h == 0:
        return row, (UNDER_LIMIT, row.limit, cap, base)
    if h > cap:
        return row, (OVER_LIMIT, row.limit, cap, now + rate)
    row.tstamp = base + h * rate
    return row, (UNDER_LIMIT, row.limit, cap - h, row.tstamp)


def sliding_roll(R: int, T: int, D: int, L: int,
                 now: int) -> Tuple[int, int, int, int, int]:
    """Advance a packed sliding register to the window containing `now`.
    Mirrors kernel._sliding_roll; returns (prev, cur, window_start,
    weighted_estimate, effective_limit)."""
    sl_l = min(L, SLIDING_MAX_LIMIT)
    cur = R & SLIDING_MAX_LIMIT
    prev = (R >> SLIDING_PACK_BITS) & SLIDING_MAX_LIMIT
    max_d = max(D, 1)
    k = max((now - T) // max_d, 0)
    if k == 0:
        prev1, cur1 = prev, cur
    elif k == 1:
        prev1, cur1 = cur, 0
    else:
        prev1, cur1 = 0, 0
    ws = T + k * max_d
    q = SLIDING_WEIGHT_Q
    off = min(max(now - ws, 0), max_d)
    if max_d <= q:
        pos_q = (off * q) // max_d
    else:
        pos_q = min(off // max(max_d // q, 1), q)
    pos_q = min(max(pos_q, 0), q)
    est = (prev1 * (q - pos_q)) // q + cur1
    return prev1, cur1, ws, est, sl_l


def _sliding_hit(row: Row, h: int, req_duration: int,
                 now: int) -> Tuple[Row, Resp]:
    prev, cur, ws, est, sl_l = sliding_roll(
        row.remaining, row.tstamp, row.duration, row.limit, now)
    # the roll commits on every branch (idempotent, like leaky's leak)
    row.tstamp = ws
    reset = ws + max(row.duration, 1)
    if est >= sl_l:
        row.remaining = cur | (prev << SLIDING_PACK_BITS)
        return row, (OVER_LIMIT, row.limit, 0, reset)
    if h == 0:
        row.remaining = cur | (prev << SLIDING_PACK_BITS)
        return row, (UNDER_LIMIT, row.limit, sl_l - est, reset)
    if est + h > sl_l:
        row.remaining = cur | (prev << SLIDING_PACK_BITS)
        return row, (OVER_LIMIT, row.limit, sl_l - est, reset)
    cur += h
    row.remaining = cur | (prev << SLIDING_PACK_BITS)
    row.expire = now + req_duration
    return row, (UNDER_LIMIT, row.limit, sl_l - est - h, reset)


def _conc_hit(row: Row, h: int, req_duration: int,
              now: int) -> Tuple[Row, Resp]:
    R = row.remaining
    if h < 0:
        R2 = R + min(-h, row.limit - R)  # saturate toward the limit
        row.remaining = R2
        row.tstamp = now
        row.expire = now + req_duration
        return row, (UNDER_LIMIT, row.limit, R2, 0)
    if R == 0:
        return row, (OVER_LIMIT, row.limit, 0, 0)
    if h == 0:
        return row, (UNDER_LIMIT, row.limit, R, 0)
    if h > R:
        return row, (OVER_LIMIT, row.limit, R, 0)
    row.remaining = R - h
    row.tstamp = now
    row.expire = now + req_duration
    return row, (UNDER_LIMIT, row.limit, R - h, 0)


def apply(row: Optional[Row], hits: int, limit: int, duration: int,
          algo: int, now: int) -> Tuple[Row, Resp]:
    """One request against one row; `row` is None on a cache miss.  An
    expired row or a stored-algorithm mismatch re-inits, matching the
    device's fresh-lane rule (`expire < now` in window_prep; algo switch
    in window_math)."""
    if row is None or row.expire < now or row.algo != algo:
        return _init(hits, limit, duration, algo, now)
    if algo == LEAKY_BUCKET:
        return _leaky_hit(row, hits, limit, duration, now)
    if algo == GCRA:
        return _gcra_hit(row, hits, limit, now)
    if algo == SLIDING_WINDOW:
        return _sliding_hit(row, hits, duration, now)
    if algo == CONCURRENCY:
        return _conc_hit(row, hits, duration, now)
    return _token_hit(row, hits, now)
