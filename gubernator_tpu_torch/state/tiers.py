"""Tiered key state: the fixed arena as a managed cache over an unbounded
key space.

The port of `gubernator_tpu/state/tiers.py`.  Three tiers, the coldest
rebuilt from nothing:

  hot   the dense arena on the device (ops/kernel.py BucketState); the
        SlotTable still owns which key holds which slot.
  warm  this module: a host store of LIVE bucket rows evicted from the
        arena, in the snapshot's encodings (state/snapshot.py): absolute
        int64 times, or compact32 deltas rebased against the store's
        epoch, encoded and decoded in batches with the snapshot's codec.
  cold  nothing stored.  A miss in both tiers starts the key from the
        request's own config, the reference's stateless-client semantics,
        so a full arena costs a cache miss instead of a wrong count.

Demotion rides SlotTable._reclaim (state/arena.py spill hooks): evicting
a committed live entry hands (key, slot) to `TierManager.on_spill`, and
the engine gathers every spilled row in ONE gather at the fence before
the window's dispatch (core/engine.py _tier_fence), while the victims'
rows are still intact on the device.  Promotion happens while a window is
staged: a key found warm gets a fresh slot and its row is scattered back
in the same fence, before the window launches, so the decisions equal an
arena that never evicts, bit for bit.  A key evicted and requested again
within one undispatched window takes the pending spill as its row source
(gathered, then scattered; the warm store is not touched), which keeps
the demote-then-promote-in-one-window case exact.

Victims are picked by heat: the analytics' rolling top-K (when analytics
is on) gives each key a score, and the SlotTable spills the coldest of
its LRU-head sample; with analytics off every heat reads 0.0 and the
policy is strict LRU.

A row is expired as the kernels count it, expire < now: one whose
expire equals the clock still answers a request at that clock.  The JAX
store and fence drop it (ROADMAP Queue 3); here it stays.

The warm tier needs the Python routing tables (the native router keeps
fingerprints, not key strings); `RateLimitEngine.enable_tiers` enforces
it.  Nothing here imports torch: rows cross as numpy.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from gubernator_tpu_torch.state.snapshot import (
    REBASE_LIM,
    rebase_decode,
    rebase_encode,
)

log = logging.getLogger("gubernator.tiers")

ROW_FIELDS = ("limit", "duration", "remaining", "tstamp", "expire", "algo")
_VAL_FIELDS = ("limit", "duration", "remaining")
_TIME_FIELDS = ("tstamp", "expire")

_I32 = 2 ** 31


class WarmStore:
    """Fixed-capacity host store of demoted bucket rows, one column a
    field.

    Rows live in one of two layouts (per store, chosen at construction):

      int64      every column int64 (algo int32): always representable.
      compact32  limit/duration/remaining int32; tstamp/expire int32
                 deltas rebased against the store's epoch: half the bytes
                 a row.  Rows outside the rebase clip range or the int32
                 value range go to a small int64 side map instead of being
                 truncated, so the layout is never lossy.

    Keys index an insertion-ordered map (oldest first); on overflow the
    store evicts an expired resident first, else the oldest: cold is
    rebuilt from nothing, so a drop costs a miss, not data.
    """

    def __init__(self, capacity: int, layout: str = "int64",
                 epoch: int = 0):
        if capacity <= 0:
            raise ValueError("warm capacity must be positive")
        if layout not in ("int64", "compact32"):
            raise ValueError(f"unknown warm layout {layout!r}")
        self.capacity = capacity
        self.layout = layout
        self.epoch = int(epoch)
        dt = np.int32 if layout == "compact32" else np.int64
        self._cols: Dict[str, np.ndarray] = {
            f: np.zeros(capacity, dt) for f in _VAL_FIELDS + _TIME_FIELDS}
        self._cols["algo"] = np.zeros(capacity, np.int32)
        # absolute expire a row (int64) whatever the layout: expiry checks
        # and overflow eviction never pay a decode
        self._abs_expire = np.zeros(capacity, np.int64)
        self._index: "OrderedDict[str, int]" = OrderedDict()
        self._free = list(range(capacity - 1, -1, -1))
        # compact32 rows that failed the range check, canonical int64
        self._over: Dict[str, dict] = {}
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._index) + len(self._over)

    def __contains__(self, key: str) -> bool:
        return key in self._index or key in self._over

    def nbytes(self) -> int:
        """Allocated column bytes plus the side map's estimate."""
        soa = sum(a.nbytes for a in self._cols.values())
        return soa + self._abs_expire.nbytes + 96 * len(self._over)

    # ----------------------------------------------------------------- put

    def _compact_ok(self, row: dict) -> bool:
        for f in _VAL_FIELDS:
            if not (-_I32 <= row[f] < _I32):
                return False
        for f in _TIME_FIELDS:
            if not (-REBASE_LIM <= row[f] - self.epoch <= REBASE_LIM):
                return False
        return True

    def _alloc(self, key: str, now: int) -> Optional[int]:
        if self._free:
            i = self._free.pop()
        else:
            victim = None
            for scanned, (k, ri) in enumerate(self._index.items()):
                if self._abs_expire[ri] <= now:
                    victim = k
                    break
                if scanned >= 8:
                    break
            if victim is None:
                if not self._index:
                    return None  # capacity entirely held by side-map rows
                victim = next(iter(self._index))
            i = self._index.pop(victim)
            self.evictions += 1
        self._index[key] = i
        return i

    def put_batch(self, rows: List[dict], now: int) -> int:
        """Insert canonical int64 row dicts (encoded once, as a batch).  A
        key already resident is overwritten in place.  Returns the rows
        stored."""
        if not rows:
            return 0
        if self.layout == "compact32":
            fits = [self._compact_ok(r) for r in rows]
            for r, ok in zip(rows, fits):
                if not ok:
                    self._over[r["key"]] = {f: int(r[f]) for f in ROW_FIELDS}
                    self._over[r["key"]]["key"] = r["key"]
                    self._index.pop(r["key"], None)
            rows = [r for r, ok in zip(rows, fits) if ok]
            if not rows:
                return len(fits)
        idxs = []
        kept = []
        for r in rows:
            key = r["key"]
            self._over.pop(key, None)
            i = self._index.get(key)
            if i is not None:
                self._index.move_to_end(key)
            else:
                i = self._alloc(key, now)
                if i is None:
                    self.evictions += 1
                    continue
            idxs.append(i)
            kept.append(r)
        if not kept:
            return 0
        ii = np.asarray(idxs, np.int64)
        for f in _VAL_FIELDS + ("algo",):
            self._cols[f][ii] = [r[f] for r in kept]
        times = np.asarray([[r["tstamp"], r["expire"]] for r in kept],
                           np.int64)
        if self.layout == "compact32":
            rel = rebase_encode(times, np.zeros(times.shape, bool),
                                self.epoch)
            self._cols["tstamp"][ii] = rel[:, 0]
            self._cols["expire"][ii] = rel[:, 1]
        else:
            self._cols["tstamp"][ii] = times[:, 0]
            self._cols["expire"][ii] = times[:, 1]
        self._abs_expire[ii] = times[:, 1]
        return len(kept)

    # ---------------------------------------------------------------- take

    def take(self, key: str, now: int) -> Optional[dict]:
        """Remove and return the row of `key`, or None when absent or
        already expired (the device would read an expired row as a miss
        anyway).  Expired is the kernels' rule, expire < now: a row whose
        expire equals `now` is still live there (the JAX store drops it,
        ROADMAP Queue 3).

        compact32 rows come back raw (rel=True, int32 deltas): the caller
        decodes them as a batch at the fence, so a take only moves
        entries."""
        row = self._over.pop(key, None)
        if row is not None:
            if row["expire"] < now:
                return None
            out = dict(row)
            out["rel"] = False
            return out
        i = self._index.pop(key, None)
        if i is None:
            return None
        self._free.append(i)
        if self._abs_expire[i] < now:
            return None
        out = {f: int(self._cols[f][i]) for f in ROW_FIELDS}
        out["key"] = key
        out["rel"] = self.layout == "compact32"
        out["abs_expire"] = int(self._abs_expire[i])
        return out

    # ------------------------------------------------------- serialization

    def export_rows(self) -> tuple:
        """(keys, {field: int64 array}): every resident row in canonical
        absolute int64 form (the snapshot's optional warm arrays)."""
        keys = list(self._index.keys())
        cols = {}
        if keys:
            ii = np.asarray([self._index[k] for k in keys], np.int64)
            for f in _VAL_FIELDS + ("algo",):
                cols[f] = self._cols[f][ii].astype(np.int64)
            for f in _TIME_FIELDS:
                col = self._cols[f][ii]
                cols[f] = (rebase_decode(col, self.epoch)
                           if self.layout == "compact32"
                           else col.astype(np.int64))
        else:
            cols = {f: np.empty(0, np.int64) for f in ROW_FIELDS}
        for key, row in self._over.items():
            keys.append(key)
            for f in ROW_FIELDS:
                cols[f] = np.append(cols[f], np.int64(row[f]))
        return keys, cols

    def restore_rows(self, keys: List[str], cols: Dict[str, np.ndarray],
                     now: int, shift: int = 0) -> int:
        """Insert exported rows again (a restart: the warm tier rides the
        arena's snapshot).  `shift` rebases times into a new clock domain,
        as engine.import_state does."""
        rows = []
        for j, key in enumerate(keys):
            row = {f: int(cols[f][j]) for f in ROW_FIELDS}
            if shift and row["expire"]:
                row["tstamp"] += shift
                row["expire"] += shift
            row["key"] = key
            if row["expire"] >= now:  # live by the kernels' rule
                rows.append(row)
        return self.put_batch(rows, now)


class TierManager:
    """Bookkeeping between the SlotTable spill hooks, the warm store and
    the engine's fence before each dispatch.  Every method runs on the
    engine's one dispatch thread, so nothing here locks."""

    def __init__(self, conf, epoch: int, analytics=None):
        self.conf = conf
        self.warm = WarmStore(conf.warm_rows, conf.layout, epoch)
        self.analytics = analytics
        self._heat: Dict[str, float] = {}
        self.fences = 0
        # key -> (shard, slot): committed victims evicted since the last
        # fence, their device rows intact until the next dispatch
        self.pending_spills: "OrderedDict[str, tuple]" = OrderedDict()
        # key -> [shard, slot, row | None, spill_src | None]: rows to
        # scatter at the fence.  row is a WarmStore.take dict; spill_src
        # routes a key demoted and promoted in one window straight from
        # the gather.
        self.pending_promos: "OrderedDict[str, list]" = OrderedDict()
        self.counters = {
            "promotions": 0,
            "promotions_from_spill": 0,
            "demotions": 0,
            "demote_dropped_expired": 0,
            "demote_dropped_stale": 0,
            "warm_hits": 0,
            "cold_misses": 0,
        }

    # ------------------------------------------------------------ heat feed

    def heat(self, key: str) -> float:
        return self._heat.get(key, 0.0)

    def refresh_heat(self) -> None:
        """Pull the analytics' rolling top-K into the heat map the
        eviction sampler reads (called from tier_maintain and every 256th
        fence)."""
        if self.analytics is None:
            return
        try:
            self._heat = {r["key"]: float(r["score"])
                          for r in self.analytics.topk_snapshot()}
        except Exception:  # observability must never break serving
            log.exception("tier heat refresh failed")

    # --------------------------------------------------------- spill intake

    def on_spill(self, shard: int, key: str, slot: int, expire: int,
                 stale: bool) -> None:
        """SlotTable spill hook: a committed entry was evicted.  `stale`
        means the current undispatched window touched the victim (only
        when every LRU-head candidate was): its device row misses that
        window's hits, so it drops to cold instead of storing a wrong
        row."""
        promo = self.pending_promos.pop(key, None)
        if promo is not None:
            # a key promoted in THIS window, evicted again before the
            # dispatch: its row never reached the device, so it goes back
            # to warm (or, promoted from a spill, back to the spill list)
            if promo[3] is not None:
                self.pending_spills[key] = promo[3]
            elif promo[2] is not None:
                self._restore_row(promo[2])
            return
        if stale:
            self.counters["demote_dropped_stale"] += 1
            return
        self.pending_spills[key] = (shard, slot)

    def _restore_row(self, row: dict) -> None:
        """Put back a row taken for a promotion cancelled before its
        scatter.  A raw compact row's deltas are unclipped by construction,
        so epoch + delta is the codec's own inverse."""
        canon = {f: int(row[f]) for f in _VAL_FIELDS + ("algo",)}
        for f in _TIME_FIELDS:
            canon[f] = int(row[f]) + (self.warm.epoch if row.get("rel")
                                      else 0)
        canon["key"] = row["key"]
        self.warm.put_batch([canon], now=0)

    # ----------------------------------------------------- staging promotion

    def stage_promote(self, shard: int, table, key: str, now: int,
                      duration: int) -> Optional[int]:
        """For a key absent from the hot table while a window is staged:
        the upserted slot when the key comes back from the warm tier (or
        from a pending spill of the same window), else None, and the
        caller takes the ordinary cold lookup."""
        src = self.pending_spills.pop(key, None)
        if src is not None:
            # demoted earlier in this window and requested again: the old
            # device row is still intact, so the fence's gather reads it
            # into the new slot
            slot = table.upsert(key, now, now + duration)
            self.pending_promos[key] = [shard, slot, None, src]
            self.counters["warm_hits"] += 1
            self.counters["promotions_from_spill"] += 1
            return slot
        row = self.warm.take(key, now)
        if row is None:
            self.counters["cold_misses"] += 1
            return None
        expire = row["abs_expire"] if row.get("rel") else row["expire"]
        slot = table.upsert(key, now, expire)
        self.pending_promos[key] = [shard, slot, row, None]
        self.counters["warm_hits"] += 1
        return slot

    # ------------------------------------------------------------- the fence

    def drain_pending(self) -> tuple:
        """The fence's work lists, and a reset: (spills, promos) with
        spills [(key, shard, slot)] and promos [(key, pending_promos
        value)]."""
        spills = [(k, s[0], s[1]) for k, s in self.pending_spills.items()]
        promos = list(self.pending_promos.items())
        self.pending_spills = OrderedDict()
        self.pending_promos = OrderedDict()
        return spills, promos

    def decode_rows(self, rows: List[dict]) -> List[dict]:
        """Decode raw compact32 rows to canonical int64, as one batch."""
        rel_rows = [r for r in rows if r.get("rel")]
        if rel_rows:
            rel = np.asarray([[r["tstamp"], r["expire"]] for r in rel_rows],
                             np.int32)
            out = rebase_decode(rel, self.warm.epoch)
            for j, r in enumerate(rel_rows):
                r["tstamp"] = int(out[j, 0])
                r["expire"] = int(out[j, 1])
                r["rel"] = False
        return rows

    # ------------------------------------------------------------- reporting

    def stats(self) -> dict:
        out = dict(self.counters)
        out.update({
            "warm_rows": len(self.warm),
            "warm_capacity": self.warm.capacity,
            "warm_bytes": self.warm.nbytes(),
            "warm_evictions": self.warm.evictions,
            "warm_layout": self.warm.layout,
            "fences": self.fences,
            "pending_spills": len(self.pending_spills),
            "pending_promotions": len(self.pending_promos),
        })
        return out
