"""The rate-limit window math as plain PyTorch: the int64 oracle.

A function-for-function port of `gubernator_tpu/ops/kernel.py` (the JAX
package's int64 oracle) onto torch tensors, with the same names, argument
order and NamedTuple shapes so each function can be read beside its
counterpart.  It is the PLAIN version of the hand-written CUDA kernels in
ops/csrc/: window_step of window_drain.cu (ops/drain_kernel.py) and
global_combined of global_window.cu (ops/global_kernel.py).  The wrappers
run it for tensors on the CPU, and tests and chip_smoke.py hold the kernels
against it bit for bit.

Semantics (see the JAX module docstring for the reference line numbers):
one window of requests is sorted by slot; same-slot lanes form segments
that must observe sequential semantics (lane N+1 sees lane N's update);
uniform segments take a closed-form prefix fold, irregular ones replay
round by round; one write per touched slot lands in the arena.  Lazy TTL
expiry, the five algorithm ladders (token, leaky, GCRA, sliding window,
concurrency) and aggregated runs (AGG_SLOT_BIT) are reproduced exactly.

Integer notes for the port: `//` on torch integer tensors floors, like
jnp's, and every divisor below is guarded to be >= 1 exactly as in the
oracle (torch raises on an integer division by zero on the CPU where JAX
does not).  int64 arithmetic wraps on overflow in both frameworks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Algorithm / status constants (proto/gubernator.proto:56-61,126-129 plus
# the algorithm-plane values 2..4).  Any other algorithm value degrades to
# token bucket (reference algorithms.go:100-104).
TOKEN_BUCKET = 0
LEAKY_BUCKET = 1
GCRA = 2
SLIDING_WINDOW = 3
CONCURRENCY = 4
UNDER_LIMIT = 0
OVER_LIMIT = 1

# Sliding-window packing: cur | prev << 15 in the remaining column; limits
# clamp to 2^15-1 and the interpolation weight is quantized to 1/1024ths.
SLIDING_PACK_BITS = 15
SLIDING_MAX_LIMIT = (1 << SLIDING_PACK_BITS) - 1
SLIDING_WEIGHT_Q = 1024
# Compact eligibility cap for sliding durations (half the generic cap).
SLIDING_MAX_DURATION = 1 << 30

# Concurrency hits travel sign-extended through the 28-bit compact hits
# field (bit 27 is the sign), so releases are range-limited to |hits| < 2^27.
CONC_MAX_HITS = 1 << 27

# Slot value marking a padded (unused) lane of a window batch.
PAD_SLOT = -1

# Aggregated-run flag in bit 30 of a lane's slot: the lane's hits carry
# the length n of a run of identical hits=1 requests; the device consumes
# min(n, r_start) and answers with r_start.
AGG_SLOT_BIT = 1 << 30

I32 = torch.int32
I64 = torch.int64


class BucketState(NamedTuple):
    """Dense SoA arena state, one row per key slot (see the JAX module for
    the field semantics): limit/duration/remaining/tstamp/expire i64[C],
    algo i32[C].  expire == 0 reads as never initialized."""

    limit: torch.Tensor
    duration: torch.Tensor
    remaining: torch.Tensor
    tstamp: torch.Tensor
    expire: torch.Tensor
    algo: torch.Tensor

    @classmethod
    def zeros(cls, capacity: int, device) -> "BucketState":
        z = lambda dt: torch.zeros((capacity,), dtype=dt, device=device)  # noqa: E731
        return cls(z(I64), z(I64), z(I64), z(I64), z(I64), z(I32))


class WindowBatch(NamedTuple):
    """One window's requests, routed to slots and padded to length B."""

    slot: torch.Tensor  # i32[B], PAD_SLOT for unused lanes
    hits: torch.Tensor  # i64[B]
    limit: torch.Tensor  # i64[B]
    duration: torch.Tensor  # i64[B]
    algo: torch.Tensor  # i32[B]
    is_init: torch.Tensor  # bool[B]


class WindowOutput(NamedTuple):
    """Per-request responses (RateLimitResp fields, proto:131-143)."""

    status: torch.Tensor  # i32[B]
    limit: torch.Tensor  # i64[B]
    remaining: torch.Tensor  # i64[B]
    reset_time: torch.Tensor  # i64[B]


class _Reg(NamedTuple):
    """A segment's live bucket state during replay (BucketState fields)."""

    limit: torch.Tensor
    duration: torch.Tensor
    remaining: torch.Tensor
    tstamp: torch.Tensor
    expire: torch.Tensor
    algo: torch.Tensor


def _where(cond, a, b):
    """jnp.where with python-int arms allowed on either side."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = torch.tensor(a, dtype=I64, device=cond.device)
    return torch.where(cond, a, b)


def _chain(pairs, default):
    """First-match-wins selection, mirroring the reference's if/else ladders."""
    out = default
    for cond, val in reversed(pairs):
        out = _where(cond, val, out)
    return out


def _status(pairs, default):
    return _chain(pairs, default).to(I32)


def _tmap(fn, *trees):
    return [fn(*xs) for xs in zip(*trees)]


def _sliding_roll(R, T, D, L, now):
    """Advance a sliding-window register to the window containing `now`.
    Returns (prev1, cur1, ws1, est, sl_L)."""
    Q = SLIDING_WEIGHT_Q
    sl_L = torch.clamp(L, max=SLIDING_MAX_LIMIT)
    cur = R & SLIDING_MAX_LIMIT
    prev = (R >> SLIDING_PACK_BITS) & SLIDING_MAX_LIMIT
    maxD = torch.clamp(D, min=1)
    k = torch.clamp((now - T) // maxD, min=0)
    prev1 = _chain([(k == 0, prev), (k == 1, cur)], torch.zeros_like(prev))
    cur1 = _where(k == 0, cur, 0)
    ws1 = T + k * maxD
    offc = torch.minimum(torch.clamp(now - ws1, min=0), maxD)
    pos_q = torch.where(maxD <= Q,
                        (offc * Q) // maxD,
                        torch.clamp(offc // torch.clamp(maxD // Q, min=1),
                                    max=Q))
    pos_q = torch.clamp(pos_q, 0, Q)
    weighted = (prev1 * (Q - pos_q)) // Q
    return prev1, cur1, ws1, weighted + cur1, sl_L


def transition(reg: _Reg, hits, req_limit, req_duration, req_algo, now, fresh,
               agg=None):
    """One request applied to one bucket, vectorized over the batch dimension.

    `fresh` marks lanes that take the cache-miss/init path (new slot, expired
    entry, or algorithm switch).  `agg` marks aggregated runs.  Returns
    (new_reg, WindowOutput); the ladders follow reference
    algorithms.go:24-186 branch for branch (JAX ops/kernel.py:231)."""
    L, D, R, T, E, A = reg
    h = hits
    is_token = req_algo == TOKEN_BUCKET
    is_leaky = req_algo == LEAKY_BUCKET
    is_gcra = req_algo == GCRA
    is_sliding = req_algo == SLIDING_WINDOW
    is_conc = req_algo == CONCURRENCY
    zero = torch.zeros_like(h)

    # ---- init path (cache miss): algorithms.go:68-84 / :161-185 ----
    rate_q = torch.clamp(req_duration // torch.clamp(req_limit, min=1), min=1)
    sl_l0 = torch.clamp(req_limit, max=SLIDING_MAX_LIMIT)
    eff_init_limit = torch.where(is_sliding, sl_l0, req_limit)
    conc_rel0 = is_conc & (h < 0)
    over_init = (h > eff_init_limit) & ~conc_rel0
    init_R = _chain([(conc_rel0, eff_init_limit), (over_init, 0)],
                    eff_init_limit - h)
    init_status = _status([(over_init, OVER_LIMIT)], torch.zeros_like(h))
    init_T = _chain(
        [(is_leaky | is_sliding | is_conc, now + zero),
         (is_gcra, torch.where(over_init, now + req_duration,
                               now + h * rate_q))],
        now + req_duration)
    init_R_store = torch.where(
        is_sliding, torch.where(over_init, sl_l0, torch.clamp(h, min=0)),
        init_R)
    init_reg = _Reg(limit=req_limit, duration=req_duration,
                    remaining=init_R_store, tstamp=init_T,
                    expire=now + req_duration, algo=req_algo)
    init_out = WindowOutput(
        status=init_status,
        limit=req_limit,
        remaining=init_R,
        reset_time=_chain(
            [(is_leaky | is_conc, 0),
             (is_gcra, torch.where(over_init, now + rate_q,
                                   now + h * rate_q)),
             (is_sliding, now + req_duration)],
            now + req_duration),
    )

    # ---- token bucket hit path: algorithms.go:40-65 ----
    tb_at_zero = R == 0
    tb_read = h == 0
    tb_drain = h == R
    tb_over = h > R
    t_status = _status(
        [(tb_at_zero, OVER_LIMIT), (tb_read, UNDER_LIMIT),
         (tb_drain, UNDER_LIMIT), (tb_over, OVER_LIMIT)], zero)
    t_resp_R = _chain([(tb_at_zero, 0), (tb_read, R), (tb_drain, 0),
                       (tb_over, R)], R - h)
    t_new_R = _chain([(tb_at_zero, R), (tb_read, R), (tb_drain, 0),
                      (tb_over, R)], R - h)
    token_reg = _Reg(L, D, t_new_R, T, E, A)
    token_out = WindowOutput(t_status, L, t_resp_R, T)

    # ---- leaky bucket hit path: algorithms.go:107-158 ----
    rate = torch.clamp(D // torch.clamp(req_limit, min=1), min=1)
    leak = (now - T) // rate
    R2 = R + torch.minimum(leak, L - R)
    T2 = torch.where(h != 0, now + zero, T)
    lb_at_zero = R2 == 0
    lb_drain = h == R2
    lb_over = h > R2
    lb_read = h == 0
    l_status = _status(
        [(lb_at_zero, OVER_LIMIT), (lb_drain, UNDER_LIMIT),
         (lb_over, OVER_LIMIT), (lb_read, UNDER_LIMIT)], zero)
    l_resp_R = _chain([(lb_at_zero, 0), (lb_drain, 0), (lb_over, R2),
                       (lb_read, R2)], R2 - h)
    l_reset = _chain([(lb_at_zero, now + rate), (lb_drain, 0),
                      (lb_over, now + rate), (lb_read, 0)], zero)
    l_new_R = _chain([(lb_at_zero, R2), (lb_drain, 0), (lb_over, R2),
                      (lb_read, R2)], R2 - h)
    l_hit = ~(lb_at_zero | lb_drain | lb_over | lb_read)
    l_new_E = torch.where(l_hit, now + req_duration, E)
    leaky_reg = _Reg(L, D, l_new_R, T2, l_new_E, A)
    leaky_out = WindowOutput(l_status, L, l_resp_R, l_reset)

    # ---- GCRA hit path: TAT arithmetic on the tstamp column ----
    g_base = torch.clamp(T, min=now)
    g_raw = torch.clamp((now + D - g_base) // rate, min=0)
    g_cap = torch.minimum(g_raw, L)
    g_at_zero = g_cap == 0
    g_read = h == 0
    g_drain = h == g_cap
    g_over = h > g_cap
    g_status = _status(
        [(g_at_zero, OVER_LIMIT), (g_read, UNDER_LIMIT),
         (g_drain, UNDER_LIMIT), (g_over, OVER_LIMIT)], zero)
    g_resp_R = _chain([(g_at_zero, 0), (g_read, g_cap), (g_drain, 0),
                       (g_over, g_cap)], g_cap - h)
    g_consume = ~(g_at_zero | g_read | g_over)
    g_new_T = torch.where(g_consume, g_base + h * rate, T)
    g_reset = _chain([(g_at_zero, now + rate), (g_read, g_base),
                      (g_over, now + rate)], g_new_T)
    gcra_reg = _Reg(L, D, R, g_new_T, E, A)
    gcra_out = WindowOutput(g_status, L, g_resp_R, g_reset)

    # ---- sliding-window hit path: weighted two-bucket interpolation ----
    sl_prev1, sl_cur1, sl_ws, sl_est, sl_L = _sliding_roll(R, T, D, L, now)
    sl_full = sl_est >= sl_L
    sl_read = h == 0
    sl_over = sl_est + h > sl_L
    sl_status = _status(
        [(sl_full, OVER_LIMIT), (sl_read, UNDER_LIMIT),
         (sl_over, OVER_LIMIT)], zero)
    sl_resp_R = _chain([(sl_full, 0), (sl_read, sl_L - sl_est),
                        (sl_over, sl_L - sl_est)], sl_L - sl_est - h)
    sl_accept = ~(sl_full | sl_read | sl_over)
    sl_cur2 = torch.where(sl_accept, sl_cur1 + h, sl_cur1)
    sl_new_R = sl_cur2 | (sl_prev1 << SLIDING_PACK_BITS)
    sl_new_E = torch.where(sl_accept, now + req_duration, E)
    sliding_reg = _Reg(L, D, sl_new_R, sl_ws, sl_new_E, A)
    sliding_out = WindowOutput(sl_status, L, sl_resp_R,
                               sl_ws + torch.clamp(D, min=1))

    # ---- concurrency hit path: acquire/release over live leases ----
    c_rel = h < 0
    c_at_zero = R == 0
    c_read = h == 0
    c_over = h > R
    c_rel_R = R + torch.minimum(-h, L - R)
    c_status = _status(
        [(c_rel, UNDER_LIMIT), (c_at_zero, OVER_LIMIT),
         (c_read, UNDER_LIMIT), (c_over, OVER_LIMIT)], zero)
    c_resp_R = _chain([(c_rel, c_rel_R), (c_at_zero, 0), (c_read, R),
                       (c_over, R)], R - h)
    c_new_R = _chain([(c_rel, c_rel_R), (c_at_zero, R), (c_read, R),
                      (c_over, R)], R - h)
    c_mut = c_rel | ~(c_at_zero | c_read | c_over)
    conc_reg = _Reg(L, D, c_new_R, torch.where(c_mut, now + zero, T),
                    torch.where(c_mut, now + req_duration, E), A)
    conc_out = WindowOutput(c_status, L, c_resp_R, torch.zeros_like(T))

    # ---- combine: the requested algorithm picks the hit path, token as
    # the default (out-of-range algorithms degrade to token bucket) ----
    hit_reg, hit_out = token_reg, token_out
    for sel, breg, bout in ((is_leaky, leaky_reg, leaky_out),
                            (is_gcra, gcra_reg, gcra_out),
                            (is_sliding, sliding_reg, sliding_out),
                            (is_conc, conc_reg, conc_out)):
        hit_reg = _Reg(*_tmap(lambda b, t, s=sel: torch.where(s, b, t),
                              breg, hit_reg))
        hit_out = WindowOutput(*_tmap(lambda b, t, s=sel: torch.where(s, b, t),
                                      bout, hit_out))

    new_reg = _Reg(*_tmap(lambda i, hh: torch.where(fresh, i, hh),
                          init_reg, hit_reg))
    out = WindowOutput(*_tmap(lambda i, hh: torch.where(fresh, i, hh),
                              init_out, hit_out))
    if agg is None:
        return new_reg, out

    # ---- aggregated runs: n sequential hits=1 transitions in one lane ----
    n = h
    a_L = torch.where(fresh, req_limit, L)
    a_D = torch.where(fresh, req_duration, D)
    a_base_tok = torch.where(fresh, req_limit, R)
    a_base_lky = torch.where(fresh, req_limit, R2)
    a_base = torch.where(is_token, a_base_tok, a_base_lky)
    k = torch.minimum(n, a_base)
    a_R = a_base - k
    a_rate = torch.clamp(a_D // torch.clamp(req_limit, min=1), min=1)
    lky_extended = (k - (a_R == 0).to(I64)) >= 1
    a_reg = _Reg(
        limit=a_L,
        duration=a_D,
        remaining=a_R,
        tstamp=torch.where(is_token,
                           torch.where(fresh, now + req_duration, T),
                           now + zero),
        expire=torch.where(
            is_token,
            torch.where(fresh, now + req_duration, E),
            torch.where(fresh | lky_extended, now + req_duration, E)),
        algo=req_algo,
    )
    a_out = WindowOutput(
        status=_status([(k < n, OVER_LIMIT)], zero),
        limit=a_L,
        remaining=a_base,
        reset_time=torch.where(is_token,
                               torch.where(fresh, now + req_duration, T),
                               now + a_rate),
    )
    new_reg = _Reg(*_tmap(lambda a, b: torch.where(agg, a, b), a_reg, new_reg))
    out = WindowOutput(*_tmap(lambda a, b: torch.where(agg, a, b), a_out, out))
    return new_reg, out


def transition_precompute(reg_duration, reg_tstamp, req_limit, now):
    """The two integer divisions of `transition`'s leaky path (rate, leak),
    factored out exactly as in the JAX module."""
    rate = torch.clamp(reg_duration // torch.clamp(req_limit, min=1), min=1)
    leak = (now - reg_tstamp) // rate
    return rate, leak


def fold_entering(reg: _Reg, fresh0, h0, l0, d0, a0, pos, nz, n_lead,
                  hstar, now):
    """Closed-form ENTERING register for lane `pos` of a foldable segment
    (JAX ops/kernel.py:547): every nonzero hit equals `hstar`, config is
    uniform, no AGG lanes.  One shared `transition` call over these
    registers replaces the lane-by-lane replay."""
    dt = hstar.dtype
    Z = torch.zeros_like(hstar)
    is_lky = a0 == LEAKY_BUCKET
    is_gc = a0 == GCRA
    is_sl = a0 == SLIDING_WINDOW
    is_cc = a0 == CONCURRENCY
    over0 = fresh0 & (h0 > l0)
    L_eff = torch.where(fresh0, l0, reg.limit)
    D_eff = torch.where(fresh0, d0, reg.duration)
    nzd = nz.to(dt)
    hs1 = torch.clamp(hstar, min=1)

    # ---- token: balance only moves on accepts, T/E never move on hits ----
    Rt = torch.where(fresh0, _where(over0, 0, l0), reg.remaining)
    kt = torch.minimum(nzd, Rt // hs1)
    entR_tok = Rt - hstar * kt
    T_tok = torch.where(fresh0, now + d0, reg.tstamp)
    E_tok = torch.where(fresh0, now + d0, reg.expire)

    # ---- leaky: leading reads re-apply the SAME leak0, saturating ----
    rate0 = torch.clamp(D_eff // torch.clamp(l0, min=1), min=1)
    leak0 = torch.where(fresh0, Z, (now - reg.tstamp) // rate0)
    gap = L_eff - reg.remaining
    p_sat = torch.where(leak0 > 0,
                        (gap + leak0 - 1) // torch.clamp(leak0, min=1),
                        torch.full_like(leak0, 1 << 30))

    def satA(p):
        return torch.where(p >= p_sat, L_eff, reg.remaining + p * leak0)

    posd = pos.to(dt)
    fh = n_lead.to(dt)
    Rh = torch.where(fresh0, _where(over0, 0, l0), satA(fh + 1))
    Kf = Rh // hs1
    kl = torch.minimum(nzd, Kf)
    drained = (hstar > 0) & (Rh == Kf * hstar) & (kl == Kf) & (kl >= 1)
    gen = kl - drained.to(dt)
    phaseA = ~fresh0 & (nz == 0)
    entR_lky = torch.where(phaseA, satA(posd), Rh - hstar * kl)
    T_lky = torch.where(fresh0 | (nz > 0), now + Z, reg.tstamp)
    E_lky = torch.where(fresh0 | (gen >= 1), now + d0, reg.expire)

    # ---- GCRA: token-shaped fold on the TAT-derived burst capacity ----
    g_rate0 = rate0
    g_base_nf = torch.clamp(reg.tstamp, min=now)
    g_rawNF = torch.clamp((now + D_eff - g_base_nf) // g_rate0, min=0)
    g_rawT = torch.where(fresh0, _where(over0, 0, D_eff // g_rate0), g_rawNF)
    g_kp = torch.where((hstar > 0) & (hstar <= L_eff),
                       torch.minimum(nzd, g_rawT // hs1), Z)
    g_baset = torch.where(fresh0, torch.where(over0, now + d0, now + Z),
                          g_base_nf)
    entT_gc = torch.where((g_kp > 0) | fresh0,
                          g_baset + g_kp * hstar * g_rate0, reg.tstamp)
    entR_gc = torch.where(fresh0, _where(over0, 0, l0 - h0), reg.remaining)

    # ---- sliding: one roll per window, token greedy min over headroom ----
    s_prev1, s_cur1, s_ws1, s_est0, s_L = _sliding_roll(
        reg.remaining, reg.tstamp, D_eff, L_eff, now)
    s_over0 = fresh0 & (h0 > s_L)
    s_est_base = torch.where(fresh0, _where(s_over0, s_L, 0), s_est0)
    s_kp = torch.where(hstar > 0,
                       torch.minimum(nzd, torch.clamp(s_L - s_est_base, min=0)
                                     // hs1),
                       Z)
    s_cur_ent = (torch.where(fresh0, _where(s_over0, s_L, 0), s_cur1)
                 + s_kp * hstar)
    s_prev_ent = torch.where(fresh0, Z, s_prev1)
    entR_sl = s_cur_ent | (s_prev_ent << SLIDING_PACK_BITS)
    entT_sl = torch.where(fresh0, now + Z, s_ws1)
    E_sl = torch.where(fresh0 | (s_kp >= 1), now + d0, reg.expire)

    # ---- concurrency: acquires fold like token; releases saturate ----
    c_a = -hstar
    c_R0 = reg.remaining
    c_gap = L_eff - c_R0
    c_ksat = torch.where(c_gap > 0,
                         (c_gap + c_a - 1) // torch.clamp(c_a, min=1), Z)
    entR_rel = torch.where(
        fresh0, l0,
        torch.where(nzd == 0, c_R0,
                    torch.where(nzd >= c_ksat, L_eff, c_R0 + nzd * c_a)))
    entR_cc = torch.where(hstar < 0, entR_rel, entR_tok)
    c_applied = torch.where(hstar < 0, nzd, kt)
    T_cc = torch.where(fresh0 | (c_applied >= 1), now + Z, reg.tstamp)
    E_cc = torch.where(fresh0 | (c_applied >= 1), now + d0, reg.expire)

    def pick(lk, gc, sl, cc, tok):
        return _chain([(is_lky, lk), (is_gc, gc), (is_sl, sl), (is_cc, cc)],
                      tok)

    return _Reg(
        limit=L_eff,
        duration=D_eff,
        remaining=pick(entR_lky, entR_gc, entR_sl, entR_cc, entR_tok),
        tstamp=pick(T_lky, entT_gc, entT_sl, T_cc, T_tok),
        expire=pick(E_lky, E_tok, E_sl, E_cc, E_tok),
        algo=a0,
    )


def _cummin_reverse(x):
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


def segment_structure(s_slot, s_valid, s_init):
    """Segment indexing over a slot-sorted window (JAX ops/kernel.py:689).
    Segments are VIRTUAL: they break at slot changes AND at is_init lanes.
    Returns (seg_start, seg_start_idx, pos, seg_len, commit_mask)."""
    B = s_slot.shape[0]
    idx = torch.arange(B, dtype=I32, device=s_slot.device)
    prev_slot = s_slot[torch.clamp(idx - 1, min=0).long()]
    phys_start = (idx == 0) | (s_slot != prev_slot)
    seg_start = phys_start | (s_init & s_valid)
    seg_start_idx = torch.cummax(
        torch.where(seg_start, idx, torch.zeros_like(idx)), 0).values
    pos = idx - seg_start_idx
    nxt = torch.clamp(idx + 1, max=B - 1).long()

    def _next_boundary(start):
        shifted = torch.where(start[nxt] & (idx < B - 1), idx + 1,
                              torch.full_like(idx, B))
        return _cummin_reverse(shifted)

    next_start = _next_boundary(seg_start)
    seg_len = next_start - seg_start_idx
    # a virtual segment is its slot's LAST (the one that commits) iff no
    # further virtual start precedes the next physical slot change
    next_phys = _next_boundary(phys_start)
    commit_mask = seg_start & s_valid & (next_start >= next_phys)
    return seg_start, seg_start_idx, pos, seg_len, commit_mask


def segment_count(flag, seg_start_idx, seg_len):
    """Per-lane count of the lanes of my segment satisfying `flag`."""
    f = flag.to(I32)
    csum = torch.cumsum(f, 0).to(I32)
    seg_end = (seg_start_idx + seg_len - 1).long()
    ssi = seg_start_idx.long()
    return csum[seg_end] - csum[ssi] + f[ssi]


def segment_all(ok, seg_start_idx, seg_len):
    """Per-lane: does EVERY lane of my segment satisfy `ok`?"""
    return segment_count(~ok, seg_start_idx, seg_len) == 0


def fold_classify(s_hits, s_limit, s_duration, s_algo, s_agg,
                  seg_start_idx, seg_len, h0, l0, d0, a0, fresh_seg, reg,
                  now):
    """Classify segments for the zero-replay fold (JAX ops/kernel.py:752).
    Returns (seg_fold, nz, n_lead, hstar), aligned to lanes."""
    B = s_hits.shape[0]
    Z = torch.zeros_like(s_hits)
    nonzero = s_hits != 0
    nzf = nonzero.to(I32)
    csum = torch.cumsum(nzf, 0).to(I32)
    exc = csum - nzf
    ssi = seg_start_idx.long()
    nz = exc - exc[ssi]
    lead = ~nonzero & (nz == 0)
    n_lead = segment_count(lead, seg_start_idx, seg_len)
    first_nz = torch.clamp(seg_start_idx + n_lead, 0, B - 1).long()
    hstar = torch.where(n_lead < seg_len, s_hits[first_nz], Z)
    lane_ok = ((s_limit == l0) & (s_duration == d0) & (s_algo == a0)
               & ~s_agg & ((s_hits == 0) | (s_hits == hstar)))
    cfg_ok = segment_all(lane_ok, seg_start_idx, seg_len)
    fresh0 = fresh_seg | (a0 != reg.algo)
    L_eff = torch.where(fresh0, l0, reg.limit)
    rate0 = torch.clamp(torch.where(fresh0, d0, reg.duration)
                        // torch.clamp(l0, min=1), min=1)
    leak0 = torch.where(fresh0, Z, (now - reg.tstamp) // rate0)
    lky_ok = ((a0 != LEAKY_BUCKET) | fresh0
              | ((reg.remaining <= L_eff) & ((leak0 >= 0) | (n_lead == 0))))
    hstar_ok = (hstar >= 0) | (a0 == CONCURRENCY)
    seg_fold = cfg_ok & hstar_ok & lky_ok
    return seg_fold, nz, n_lead, hstar


class WindowPrep(NamedTuple):
    """Everything window_step derives from a window before the transition
    math (JAX ops/kernel.py:808)."""

    order: torch.Tensor
    s_slot: torch.Tensor
    s_valid: torch.Tensor
    s_hits: torch.Tensor
    s_limit: torch.Tensor
    s_duration: torch.Tensor
    s_algo: torch.Tensor
    s_init: torch.Tensor
    seg_start: torch.Tensor
    seg_start_idx: torch.Tensor
    pos: torch.Tensor
    seg_len: torch.Tensor
    cur: _Reg
    fresh_seg: torch.Tensor
    h0: torch.Tensor
    l0: torch.Tensor
    d0: torch.Tensor
    a0: torch.Tensor
    nz: torch.Tensor
    n_lead: torch.Tensor
    hstar: torch.Tensor
    seg_fold: torch.Tensor
    max_pos: int
    commit_mask: torch.Tensor
    s_agg: torch.Tensor


def window_prep(state: BucketState, batch: WindowBatch, now) -> WindowPrep:
    """Sort by slot, find virtual segments, gather registers, classify
    uniform segments (JAX ops/kernel.py:842)."""
    B = batch.slot.shape[0]
    C = state.limit.shape[0]
    dev = batch.slot.device

    valid = batch.slot >= 0
    # strip the aggregated-run flag BEFORE anything keys on slot values
    agg = valid & ((batch.slot & AGG_SLOT_BIT) != 0)
    slot_clean = torch.where(agg, batch.slot & ~AGG_SLOT_BIT, batch.slot)
    # stable sort by slot, pads last: (key << lane_bits) | lane is a
    # unique key, so a plain sort of it is a stable argsort
    sort_key = torch.where(valid, slot_clean,
                           torch.full_like(slot_clean, 2**31 - 1))
    lane_bits = max((B - 1).bit_length(), 1)
    packed_key = ((sort_key.to(I64) << lane_bits)
                  | torch.arange(B, dtype=I64, device=dev))
    sorted_key = torch.sort(packed_key).values
    order = (sorted_key & ((1 << lane_bits) - 1)).long()
    s_slot = (sorted_key >> lane_bits).to(I32)
    s_valid = valid[order]
    s_hits = batch.hits[order]
    s_limit = batch.limit[order]
    s_duration = batch.duration[order]
    s_algo = batch.algo[order]
    s_init = batch.is_init[order]
    s_agg = agg[order]

    seg_start, seg_start_idx, pos, seg_len, commit_mask = segment_structure(
        s_slot, s_valid, s_init)

    g = torch.clamp(s_slot, 0, C - 1).long()
    cur = _Reg(limit=state.limit[g], duration=state.duration[g],
               remaining=state.remaining[g], tstamp=state.tstamp[g],
               expire=state.expire[g], algo=state.algo[g])
    cur_fresh = s_init | (cur.expire < now)

    ssi = seg_start_idx.long()
    h0 = s_hits[ssi]
    l0 = s_limit[ssi]
    d0 = s_duration[ssi]
    a0 = s_algo[ssi]
    fresh_seg = cur_fresh[ssi]
    seg_fold, nz, n_lead, hstar = fold_classify(
        s_hits, s_limit, s_duration, s_algo, s_agg, seg_start_idx,
        seg_len, h0, l0, d0, a0, fresh_seg, cur, now)
    seg_single = s_valid & ~seg_fold & (seg_len == 1)
    resid = s_valid & ~seg_fold & ~seg_single
    max_pos = int(pos[resid].max()) if bool(resid.any()) else -1

    return WindowPrep(order, s_slot, s_valid, s_hits, s_limit, s_duration,
                      s_algo, s_init, seg_start, seg_start_idx, pos,
                      seg_len, cur, fresh_seg, h0, l0, d0, a0, nz, n_lead,
                      hstar, seg_fold, max_pos, commit_mask, s_agg)


def window_commit(state: BucketState, prep: WindowPrep, fin: _Reg,
                  outs_sorted: WindowOutput, in_place: bool = False
                  ) -> tuple[BucketState, WindowOutput]:
    """One write per touched slot (commit_mask; slots >= C drop), and the
    responses un-sorted to arrival order (JAX ops/kernel.py:947).  The
    writes go into copies of the planes, or with `in_place` into `state`'s
    own planes, which are then returned."""
    C = state.limit.shape[0]
    m = prep.commit_mask & (prep.s_slot < C)
    w = prep.s_slot[m].long()
    new_state = state if in_place else BucketState(*[p.clone()
                                                     for p in state])
    for plane, vals in zip(new_state, fin):
        plane[w] = vals[m]
    unsorted = []
    for v in outs_sorted:
        u = torch.zeros_like(v)
        u[prep.order] = v
        unsorted.append(u)
    return new_state, WindowOutput(*unsorted)


def window_math(now, max_pos, s_valid, s_hits, s_limit, s_duration,
                s_algo, s_agg, pos, seg_len, seg_start_idx, seg_fold,
                h0, l0, d0, a0, fresh_seg, reg, nz, n_lead, hstar):
    """One shared transition over every fold-covered lane, then replay
    rounds for the residual irregular segments (JAX ops/kernel.py:981).
    Returns (out_sorted, fin) with fin replicated per segment."""
    B = pos.shape[0]
    valid = s_valid
    p_arr = pos
    sidx = seg_start_idx
    fresh0 = fresh_seg | (a0 != reg.algo)
    seg_single = valid & ~seg_fold & (seg_len == 1)
    covered = seg_fold | seg_single

    # ---- the shared ladder: every covered lane in ONE transition ----
    ent = fold_entering(reg, fresh0, h0, l0, d0, a0, p_arr, nz, n_lead,
                        hstar, now)
    first = p_arr == 0
    ent = _Reg(*[torch.where(first, r, e) for r, e in zip(reg, ent)])
    ent_fresh = first & (fresh_seg | (s_algo != reg.algo))
    new_reg, f_out = transition(ent, s_hits, s_limit, s_duration, s_algo,
                                now, ent_fresh, agg=s_agg)
    eidx = torch.clamp(sidx + seg_len - 1, 0, B - 1).long()
    fin_cov = _Reg(*[x[eidx] for x in new_reg])

    # ---- replay rounds for residual irregular segments ----
    lim, dur, rem, ts, exp, alg = reg
    fr = fresh0
    ost, oli, ore, ors = f_out
    p = 0
    while p <= max_pos:
        r = _Reg(lim, dur, rem, ts, exp, alg)
        fresh = fr | (s_algo != r.algo)
        new_r, resp = transition(r, s_hits, s_limit, s_duration, s_algo,
                                 now, fresh, agg=s_agg)
        active = (p_arr == p) & valid & ~covered
        ai = torch.clamp(sidx + p, 0, B - 1).long()
        take = active[ai]

        def upd(new, old):
            return torch.where(take, new[ai], old)

        lim = upd(new_r.limit, lim)
        dur = upd(new_r.duration, dur)
        rem = upd(new_r.remaining, rem)
        ts = upd(new_r.tstamp, ts)
        exp = upd(new_r.expire, exp)
        alg = upd(new_r.algo, alg)
        fr = torch.where(take, torch.zeros_like(fr), fr)
        ost = torch.where(active, resp.status, ost)
        oli = torch.where(active, resp.limit, oli)
        ore = torch.where(active, resp.remaining, ore)
        ors = torch.where(active, resp.reset_time, ors)
        p += 1

    out_sorted = WindowOutput(status=ost, limit=oli, remaining=ore,
                              reset_time=ors)
    fin = _Reg(*[torch.where(covered, c, x) for c, x in
                 zip(fin_cov, (lim, dur, rem, ts, exp, alg))])
    return out_sorted, fin


def window_step(state: BucketState, batch: WindowBatch, now
                ) -> tuple[BucketState, WindowOutput]:
    """Apply one window of requests to the arena; returns (new_state,
    responses aligned with the batch lanes).  prep -> window_math -> commit
    in full-width int64 (JAX ops/kernel.py:1084)."""
    now = torch.as_tensor(now, dtype=I64, device=batch.slot.device)
    prep = window_prep(state, batch, now)
    out_sorted, fin = window_math(
        now, prep.max_pos, prep.s_valid, prep.s_hits, prep.s_limit,
        prep.s_duration, prep.s_algo, prep.s_agg, prep.pos, prep.seg_len,
        prep.seg_start_idx, prep.seg_fold, prep.h0, prep.l0, prep.d0,
        prep.a0, prep.fresh_seg, prep.cur, prep.nz, prep.n_lead,
        prep.hstar)
    return window_commit(state, prep, fin, out_sorted)


# ---- GLOBAL behavior -----------------------------------------------------
# GLOBAL keys live in one replicated arena of G rows beside the sharded
# regular arena.  Each window, every shard's GLOBAL lanes read that arena
# without spending (global_read), their hits are summed per slot over all
# shards (global_accumulate; the JAX package's mesh psum), and the sums are
# applied once under each row's config (global_apply).  global_combined is
# the two in one pass, and the plain version of ops/csrc/global_window.cu.


class GlobalConfig(NamedTuple):
    """Per-slot config of the GLOBAL arena (host-written when a request
    refreshes it): the apply half runs each row's summed hits under it
    (JAX ops/kernel.py:1283)."""

    limit: torch.Tensor  # i64[G]
    duration: torch.Tensor  # i64[G]
    algo: torch.Tensor  # i32[G]

    @classmethod
    def zeros(cls, capacity: int, device) -> "GlobalConfig":
        z = lambda dt: torch.zeros((capacity,), dtype=dt, device=device)  # noqa: E731
        return cls(z(I64), z(I64), z(I32))


def _gather_rows(state: BucketState, slot) -> _Reg:
    g = torch.clamp(slot, 0, state.limit.shape[0] - 1).long()
    return _Reg(*[x[g] for x in state])


def global_read(state: BucketState, batch: WindowBatch, now) -> WindowOutput:
    """Answer GLOBAL lanes from the replica without mutating it (JAX
    ops/kernel.py:1243): a cached entry answers through the hit path with
    hits 0; a miss (is_init, expired, or another algorithm) answers through
    the init path with the request's hits."""
    now = torch.as_tensor(now, dtype=I64, device=batch.slot.device)
    reg = _gather_rows(state, batch.slot)
    fresh = batch.is_init | (reg.expire < now) | (batch.algo != reg.algo)
    read_hits = torch.where(fresh, batch.hits, torch.zeros_like(batch.hits))
    _, out = transition(reg, read_hits, batch.limit, batch.duration,
                        batch.algo, now, fresh)
    return out


def global_accumulate(delta, batch: WindowBatch):
    """Scatter-add the lanes' hits into the per-slot delta (JAX
    ops/kernel.py:1273); pad slots (< 0) and slots >= G are dropped."""
    keep = (batch.slot >= 0) & (batch.slot < delta.shape[0])
    return delta.index_add(0, batch.slot[keep].long(), batch.hits[keep])


def global_apply(state: BucketState, cfg: GlobalConfig, summed_hits, now
                 ) -> BucketState:
    """Apply the summed GLOBAL hits to every row under its config, merged
    only where the sum is nonzero (JAX ops/kernel.py:1304)."""
    now = torch.as_tensor(now, dtype=I64, device=summed_hits.device)
    reg = _Reg(*state)
    fresh = (reg.expire < now) | (cfg.algo != reg.algo)
    new_reg, _ = transition(reg, summed_hits, cfg.limit, cfg.duration,
                            cfg.algo, now, fresh)
    touched = summed_hits != 0
    return BucketState(*[torch.where(touched, n, o)
                         for n, o in zip(new_reg, reg)])


def global_combined(state: BucketState, cfg: GlobalConfig, batch: WindowBatch,
                    summed_hits, now) -> tuple[BucketState, WindowOutput]:
    """global_read then global_apply as ONE transition over the read lanes
    and the arena rows concatenated (JAX ops/kernel.py:1334): every read
    sees the pre-apply arena.  Returns (new_state, read_outputs)."""
    now = torch.as_tensor(now, dtype=I64, device=summed_hits.device)
    reg = _Reg(*state)
    r_reg = _gather_rows(state, batch.slot)
    r_fresh = (batch.is_init | (r_reg.expire < now)
               | (batch.algo != r_reg.algo))
    a_fresh = (reg.expire < now) | (cfg.algo != reg.algo)
    cat = lambda a, b: torch.cat([a, b])  # noqa: E731
    ent = _Reg(*[cat(r, s) for r, s in zip(r_reg, reg)])
    new_reg, out = transition(
        ent,
        cat(torch.where(r_fresh, batch.hits, torch.zeros_like(batch.hits)),
            summed_hits),
        cat(batch.limit, cfg.limit),
        cat(batch.duration, cfg.duration),
        cat(batch.algo, cfg.algo),
        now,
        cat(r_fresh, a_fresh),
    )
    n = batch.slot.shape[0]
    read_out = WindowOutput(*[o[:n] for o in out])
    touched = summed_hits != 0
    merged = [torch.where(touched, a[n:], o) for a, o in zip(new_reg, reg)]
    return BucketState(*merged), read_out


# ---- compact wire format -------------------------------------------------
# Eligible windows (host-checked: 0 <= hits < 2^28, 0 <= limit < 2^31,
# 0 <= duration < 2^31-16) travel packed:
#
#   request  i64[B, 2]:
#     w0: bits 0..31 slot+1 (0 = padded lane), bit 32 is_init,
#         bit 33 algorithm bit 0, bits 34..61 hits,
#         bits 62..63 algorithm bits 1..2 (concurrency hits are
#         SIGN-EXTENDED from bit 27 of the hits field)
#     w1: bits 0..31 limit, bits 32..62 duration
#   response word i64:
#     bits 0..30 remaining, bit 31 status,
#     bits 32..63 reset_enc = 0 if reset_time == 0 else reset_time - now + 1
#   plus the response's limit, raw (the STORED limit on hit paths).

COMPACT_MAX_HITS = 1 << 28
COMPACT_MAX_LIMIT = 1 << 31
COMPACT_MAX_DURATION = (1 << 31) - 16


def decode_batch(packed) -> WindowBatch:
    """Device-side decode of the compact request pair (see layout above)."""
    w0 = packed[..., 0]
    w1 = packed[..., 1]
    algo = (((w0 >> 33) & 1) | (((w0 >> 62) & 3) << 1)).to(I32)
    hits_raw = (w0 >> 34) & (COMPACT_MAX_HITS - 1)
    hits = torch.where(algo == CONCURRENCY,
                       (hits_raw ^ CONC_MAX_HITS) - CONC_MAX_HITS, hits_raw)
    return WindowBatch(
        slot=(w0 & 0xFFFFFFFF).to(I32) - 1,
        hits=hits,
        limit=w1 & 0xFFFFFFFF,
        duration=(w1 >> 32) & 0x7FFFFFFF,
        algo=algo,
        is_init=((w0 >> 32) & 1).to(torch.bool),
    )


def encode_batch_host(slot, hits, limit, duration, algo, is_init):
    """Host-side (numpy) encode into the compact request pair.  Caller must
    have verified the COMPACT_MAX_* ranges; padded lanes (slot == PAD_SLOT)
    encode to w0 == 0 regardless of other fields."""
    pad = slot < 0
    a64 = algo.astype(np.int64)
    w0 = ((slot.astype(np.int64) + 1)
          | (is_init.astype(np.int64) << 32)
          | ((a64 & 1) << 33)
          | ((hits & (COMPACT_MAX_HITS - 1)) << 34)
          | (((a64 >> 1) & 3) << 62))
    w0 = np.where(pad, 0, w0)
    w1 = limit | (duration << 32)
    return np.stack([w0, w1], axis=-1)


def encode_output_word(out: WindowOutput, now) -> torch.Tensor:
    """Encode (status, remaining, reset_time) into one i64 word per lane."""
    reset_enc = torch.where(
        out.reset_time == 0,
        torch.zeros_like(out.reset_time),
        torch.clamp(out.reset_time - now, 0, (1 << 31) - 2) + 1,
    )
    return ((reset_enc << 32)
            | (out.status.to(I64) << 31)
            | torch.clamp(out.remaining, 0, (1 << 31) - 1))


def encode_output_compact(out: WindowOutput, now) -> torch.Tensor:
    """Encode responses into i64[B, 2] (packed word, limit)."""
    return torch.stack([encode_output_word(out, now), out.limit], dim=-1)


def decode_output_host(packed, now) -> WindowOutput:
    """Host-side (numpy) decode of the compact response pair."""
    word = packed[..., 0]
    enc = (word >> 32) & 0xFFFFFFFF
    return WindowOutput(
        status=(word >> 31) & 1,
        limit=packed[..., 1],
        remaining=word & 0x7FFFFFFF,
        reset_time=np.where(enc == 0, 0, now + enc - 1),
    )
