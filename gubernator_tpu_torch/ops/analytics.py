"""Device-side traffic analytics: the per-drain stats reduction.

The JAX package's `gubernator_tpu/ops/analytics.py` on torch (and numpy for
the oracle).  A drain already moves every number an operator wants: which
slots were hit, how hard, which lanes went over limit, whether a lane
initialized a bucket.  The reduction turns a drain's compact request stack
and response words, plus the resident expiry plane, into one flat i64
stats vector per shard:

  * outcome counts: occupied lanes, total hits, under/over-limit, inits
    (arena churn), plus post-drain live/expired slot counts from the
    expiry plane (occupancy);
  * a count-min sketch over slot ids, resident on the device across drains
    (decayed by halving on a host-driven cadence), weighted
    `hits + over_weight * over` so keys burning their limit rank above
    merely chatty ones;
  * a candidate top-K: the drain's touched slots ranked by their
    cumulative sketch estimate, ties to the lower slot, shipped as (slot,
    estimate, drain_hits, drain_over) rows for the host's rolling merge
    (observability/analytics.py);
  * per-tenant rows (decisions, hits, over) keyed by host-staged small-int
    tenant ids.

Hits are the request word's raw 28-bit field, as the JAX package's
`shard_stats` and `oracle_stats` read it: a CONCURRENCY release lane's
negative hits count as their 28-bit two's-complement image, and an AGG
lane counts its folded run's total.  (The JAX package's TPU kernels count
releases as negative; ROADMAP Queue 3.)

Three forms of one result:

  * `oracle_stats` - numpy, the ground truth, copied from the JAX package;
  * `shard_stats` - torch ops over one shard's drain (`drain_stats`, the
    dense per-slot / per-tenant / header sums, then `staged_stats_tail`);
  * the two CUDA kernels that serve the engine's composed drain: the
    in-drain accumulation (ops/drain_kernel.py `drain_compact_stats`) and
    the finisher (ops/stats_kernel.py `stats_finish`), whose plain versions
    are built from the functions here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gubernator_tpu_torch.ops.kernel import AGG_SLOT_BIT, COMPACT_MAX_HITS

# The compact path tags a lane's slot+1 field with the aggregated-run flag;
# analytics wants the arena slot, so the flag is stripped on decode.  An
# AGG lane's hits field already carries the folded run's TOTAL n.
_SLOT_MASK = 0xFFFFFFFF & ~AGG_SLOT_BIT

# Stats-vector layout: [HEADER | T tenant rows x 3 | K candidate rows x 4]
HEADER = 8
(IDX_LANES, IDX_HITS, IDX_UNDER, IDX_OVER, IDX_INIT, IDX_LIVE, IDX_EXPIRED,
 IDX_RESERVED) = range(HEADER)
TENANT_COLS = 3   # decisions, hits, over
CAND_COLS = 4     # slot, sketch estimate, drain hits, drain over

# Odd 62-bit multipliers (splitmix64-flavored), one per sketch row.  The
# mask keeps every intermediate non-negative so `>>` and `%` agree across
# torch, numpy and the CUDA finisher (ops/csrc/stats_finish.cu).
_MASK62 = (1 << 62) - 1
_MULTS = (
    0x2545F4914F6CDD1D, 0x369DEA0F31A53F85, 0x27BB2EE687B0B0FD,
    0x106689D45497FDB5, 0x1B873593CC9E2D51, 0x2127599BF4325C37,
    0x0B4B82E749B0A2F5, 0x3C6EF372FE94F82B,
)
MAX_SKETCH_DEPTH = len(_MULTS)


def stats_len(tenant_slots: int, topk: int) -> int:
    return HEADER + tenant_slots * TENANT_COLS + topk * CAND_COLS


def hash_slots(xp, slots, row: int, width: int):
    """Sketch row hash of slot ids (xp is torch or np; `slots` i64):
    multiply-xorshift, bucket in [0, width)."""
    x = ((slots + 1 + row) * _MULTS[row % MAX_SKETCH_DEPTH]) & _MASK62
    x = x ^ (x >> 31)
    return x % width


class DecodedLanes(NamedTuple):
    """Per-lane fields the reduction reads from the drain's wire arrays."""

    slot: object      # i64, pad lanes < 0
    occupied: object  # i64 0/1
    hits: object      # i64 raw 28-bit field, 0 on pads
    is_init: object   # i64 0/1, 0 on pads
    over: object      # i64 0/1 (response status bit), 0 on pads


def _decode(xp, packed, words) -> DecodedLanes:
    """Compact request word0 + response word -> the reduction's inputs
    (kernel.decode_batch / encode_output_word wire layout); xp is torch or
    np."""
    w0 = packed[..., 0]
    slot = (w0 & _SLOT_MASK) - 1
    occ = xp.where(slot >= 0, 1, 0)
    return DecodedLanes(
        slot=slot,
        occupied=occ,
        hits=((w0 >> 34) & (COMPACT_MAX_HITS - 1)) * occ,
        is_init=((w0 >> 32) & 1) * occ,
        over=((words >> 31) & 1) * occ,
    )


class DrainStats(NamedTuple):
    """One shard's sums over one drain (what the in-drain accumulation
    gathers): per arena row (slots past the arena clipped to row C-1) the
    occupied lanes, over-limit lanes and hits; per tenant id (clipped to
    [0, T-1]) the same three; and the header (lanes, hits, over, inits).
    All i64."""

    d_occ: torch.Tensor   # [C]
    d_over: torch.Tensor  # [C]
    d_hits: torch.Tensor  # [C]
    t_occ: torch.Tensor   # [T]
    t_over: torch.Tensor  # [T]
    t_hits: torch.Tensor  # [T]
    hdr: torch.Tensor     # [4]


def drain_stats(packed, words, tenants, capacity: int,
                tenant_slots: int) -> DrainStats:
    """One shard's drain -> DrainStats.  packed i64[K, B, 2], words
    i64[K, B], tenants [K, B] (any int type)."""
    d = _decode(torch, packed, words)
    dev = packed.device
    row = d.slot.clamp(0, capacity - 1).reshape(-1)
    tid = tenants.to(torch.int64).clamp(0, tenant_slots - 1).reshape(-1)

    def add_at(n, idx, v):
        return torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, idx, v.reshape(-1))

    return DrainStats(
        d_occ=add_at(capacity, row, d.occupied),
        d_over=add_at(capacity, row, d.over),
        d_hits=add_at(capacity, row, d.hits),
        t_occ=add_at(tenant_slots, tid, d.occupied),
        t_over=add_at(tenant_slots, tid, d.over),
        t_hits=add_at(tenant_slots, tid, d.hits),
        hdr=torch.stack([d.occupied.sum(), d.hits.sum(), d.over.sum(),
                         d.is_init.sum()]),
    )


def staged_stats_tail(sketch, ds: DrainStats, expire, now, decay, *,
                      tenant_slots: int, topk: int, over_weight: int):
    """Finish one shard's DrainStats into (new_sketch i64[D, W], stats
    i64[V]): decay the sketch (`>> decay`), add each row's weight
    `hits + over_weight * over` into its D hashed buckets, estimate each
    touched row as the minimum over its buckets, rank the touched rows by
    (estimate desc, slot asc) and keep the first `topk` (pads
    (-1, 0, 0, 0)), and count the expiry plane's live and expired rows.
    The JAX package's staged_stats_tail takes the same sums as the TPU
    drain kernel's i32 lo/hi planes."""
    C = ds.d_occ.shape[0]
    D, W = sketch.shape
    dev = sketch.device
    dense_w = ds.d_hits + over_weight * ds.d_over
    rows = torch.arange(C, dtype=torch.int64, device=dev)
    h = torch.stack([hash_slots(torch, rows, r, W) for r in range(D)])
    flat_idx = (torch.arange(D, dtype=torch.int64, device=dev)[:, None] * W
                + h).reshape(-1)
    new_sketch = (sketch >> decay).reshape(-1).index_add(
        0, flat_idx, dense_w.expand(D, C).reshape(-1)).reshape(D, W)
    est = torch.gather(new_sketch, 1, h).min(dim=0).values

    # candidates: touched rows by estimate, ties to the lower slot (a
    # stable descending sort keeps equal scores in slot order)
    score = torch.where(ds.d_occ > 0, est, -1)
    top_est, top_slot = torch.sort(score, descending=True, stable=True)
    top_est, top_slot = top_est[:topk], top_slot[:topk]
    valid = top_est >= 0
    zero = torch.zeros_like(top_est)
    cand = torch.stack([
        torch.where(valid, top_slot, -1),
        torch.where(valid, top_est, zero),
        torch.where(valid, ds.d_hits[top_slot], zero),
        torch.where(valid, ds.d_over[top_slot], zero),
    ], dim=-1)

    trows = torch.stack([ds.t_occ, ds.t_hits, ds.t_over], dim=-1)
    lanes, hits, over, init = ds.hdr
    header = torch.stack([
        lanes, hits, lanes - over, over, init,
        (expire > now).sum(),
        ((expire != 0) & (expire <= now)).sum(),
        torch.zeros((), dtype=torch.int64, device=dev),
    ])
    return new_sketch, torch.cat([header, trows.reshape(-1),
                                  cand.reshape(-1)])


def shard_stats(sketch, packed, words, tenants, expire, now, decay, *,
                tenant_slots: int, topk: int, over_weight: int):
    """One shard's per-drain reduction in torch ops.

    sketch  i64[D, W]  persistent count-min rows (carried across drains)
    packed  i64[K, B, 2] the drain's compact request stack (this shard)
    words   i64[K, B]  the drain's response words (this shard)
    tenants [K, B]     host-staged tenant ids (0 = unattributed)
    expire  i64[C]     the post-drain expiry plane
    now     i64        the drain timestamp (ms)
    decay   0 or 1:    halve the sketch before accumulating

    Returns (new_sketch, stats i64[V]) with V = stats_len(T, topk)."""
    ds = drain_stats(packed, words, tenants, expire.shape[0], tenant_slots)
    return staged_stats_tail(sketch, ds, expire, now, decay,
                             tenant_slots=tenant_slots, topk=topk,
                             over_weight=over_weight)


def oracle_stats(sketch, packed, words, tenants, expire, now, decay, *,
                 tenant_slots: int, topk: int, over_weight: int):
    """Numpy mirror of `shard_stats`: the ground truth.  Same hash mix,
    same halving decay, same candidate rule (ties to the lower slot)."""
    sketch = np.asarray(sketch, np.int64).copy()
    packed = np.asarray(packed, np.int64)
    words = np.asarray(words, np.int64)
    C = int(np.asarray(expire).shape[0])
    d = _decode(np, packed, words)
    cslot = np.clip(d.slot, 0, C - 1).ravel()

    dense_h = np.zeros(C, np.int64)
    dense_o = np.zeros(C, np.int64)
    touched = np.zeros(C, np.int64)
    np.add.at(dense_h, cslot, d.hits.ravel())
    np.add.at(dense_o, cslot, d.over.ravel())
    np.add.at(touched, cslot, d.occupied.ravel())
    dense_w = dense_h + over_weight * dense_o

    all_slots = np.arange(C, dtype=np.int64)
    ests = np.full((sketch.shape[0], C), np.iinfo(np.int64).max)
    for r in range(sketch.shape[0]):
        h = hash_slots(np, all_slots, r, sketch.shape[1])
        sketch[r] >>= decay
        np.add.at(sketch[r], h, dense_w)
        ests[r] = sketch[r][h]
    est = ests.min(axis=0)

    score = np.where(touched > 0, est, -1)
    # ties to the FIRST index: argsort on (-score, slot)
    order = np.lexsort((all_slots, -score))[:topk]
    cand = np.zeros((topk, CAND_COLS), np.int64)
    for i, s in enumerate(order):
        if score[s] >= 0:
            cand[i] = (s, score[s], dense_h[s], dense_o[s])
        else:
            cand[i] = (-1, 0, 0, 0)

    t = np.clip(np.asarray(tenants, np.int64), 0, tenant_slots - 1).ravel()
    trows = np.zeros((tenant_slots, TENANT_COLS), np.int64)
    np.add.at(trows[:, 0], t, d.occupied.ravel())
    np.add.at(trows[:, 1], t, d.hits.ravel())
    np.add.at(trows[:, 2], t, d.over.ravel())

    expire = np.asarray(expire, np.int64)
    lanes = int(d.occupied.sum())
    over = int(d.over.sum())
    header = np.array([
        lanes, d.hits.sum(), lanes - over, over, d.is_init.sum(),
        int((expire > now).sum()), int(((expire != 0) & (expire <= now)).sum()),
        0,
    ], np.int64)
    return sketch, np.concatenate([header, trows.ravel(), cand.ravel()])
