"""Host-side key→slot management for the device state arenas.

The reference's cache is a map + doubly-linked LRU list holding Go objects
(cache/lru.go:30-96).  Here the *values* live on the device as dense SoA
arrays (ops/kernel.py BucketState) and the host keeps only the key→slot
mapping, LRU order, and hit/miss stats.  Responsibilities are split:

  host (this module):  which slot a key occupies, capacity eviction
                       (evict-oldest-on-overflow, lru.go:92-94), LRU touch on
                       access (lru.go:116), hit/miss counters (lru.go:112-119).
  device (kernel):     the actual bucket values, and lazy TTL expiry
                       (lru.go:110-114) — an expired slot re-initializes
                       in-kernel without any host round trip.

Because TTL expiry is resolved on the device, the host tracks only an
*estimate* of each entry's expiry (refreshed to now+duration on every access)
which it uses for hit/miss accounting and to prefer reclaiming expired slots.
"""

from __future__ import annotations

import heapq
from collections import OrderedDict, deque
from typing import Optional, Tuple


class SlotTable:
    """Fixed-capacity key→slot table with LRU eviction.

    `lookup` returns (slot, is_init): is_init is True when the key was just
    assigned a (possibly recycled) slot, telling the kernel to take the
    cache-miss path regardless of what the slot's previous tenant left behind.
    """

    __slots__ = ("capacity", "_entries", "_free", "hits", "misses",
                 "_seq", "_uncommitted", "_expiry_heap", "_n_expired",
                 "_stats_now", "_expired_pool", "spill_cb", "heat_fn",
                 "victim_sample")

    # entry field indices (see the _entries comment below)
    _SLOT, _EXPIRE, _PENDING, _SEEN, _EXPFLAG, _TOUCH = range(6)

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        # key -> [slot, expire_estimate_ms, pending_init, seen_seq,
        #         expired_flag, touch_seq];
        # insertion order == LRU order (oldest first), maintained with
        # move_to_end on access.  pending_init stays set until a device
        # dispatch commits the window that initialized the slot
        # (commit_window): an aborted pack must NOT consume the init flag,
        # or a retry could inherit a recycled slot's previous tenant's
        # still-live device state.  expired_flag mirrors
        # `expire_estimate < stats horizon` (incremental O(1) stats);
        # touch_seq stamps the drain that last looked the key up, so the
        # tier spill path can refuse victims whose device rows are about to
        # mutate in the not-yet-dispatched drain.
        self._entries: "OrderedDict[str, list]" = OrderedDict()
        self._free = list(range(capacity - 1, -1, -1))
        self.hits = 0
        self.misses = 0
        self._seq = 0
        self._uncommitted: list = []
        # lazy min-heap of (expire_estimate, key): lets a full table reclaim
        # an EXPIRED slot before evicting a live LRU victim.  Entries go
        # stale when a key is re-touched (its real expiry moved); staleness
        # is detected on pop by comparing against the entry's current value.
        self._expiry_heap: list = []
        # incremental occupancy accounting (O(1) stats): count of entries
        # whose expired_flag is set, the stats-call high-water `now` the
        # flags are exact against, and the keys flagged by the lazy heap
        # advance (their heap node was consumed; _reclaim consults this
        # pool first so expired-preference survives a stats() call).
        self._n_expired = 0
        self._stats_now = 0
        self._expired_pool: deque = deque()
        # Tier hooks (state/tiers.py): spill_cb(key, slot, expire, stale)
        # fires when _reclaim evicts a COMMITTED entry, so its device row
        # can demote to the warm tier instead of being lost; heat_fn(key)
        # ranks LRU-head eviction candidates (lowest heat evicted first);
        # victim_sample bounds how many candidates are ranked.  All unset
        # (the default) leaves reclaim byte-identical to the untiered path.
        self.spill_cb = None
        self.heat_fn = None
        self.victim_sample = 1

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def begin_window(self) -> None:
        """Start packing a new window: later duplicate lookups of a
        pending-init key within THIS window report is_init=False (the kernel
        sequences in-window duplicates itself)."""
        self._seq += 1
        self._uncommitted = []

    def commit_window(self) -> None:
        """The window packed since begin_window was dispatched: its fresh
        allocations are now device-initialized."""
        for ent in self._uncommitted:
            ent[2] = False
        self._uncommitted = []

    def lookup(self, key: str, now: int, duration: int) -> Tuple[int, bool]:
        """Find or allocate the slot for `key`. Returns (slot, is_init)."""
        ent = self._entries.get(key)
        if ent is not None:
            # Reference counts an expired entry as a miss (lru.go:110-114);
            # we approximate with the host-side expiry estimate.
            if ent[1] < now:
                self.misses += 1
            else:
                self.hits += 1
            ne = now + duration
            if ent[1] != ne:
                # hint-churn suppression (mirrors native/host_router.cc):
                # re-push only when the expiry moved by more than duration/4
                # or backwards; _reclaim checks the entry's CURRENT expiry,
                # so sparser hints stay correct while the heap stays bounded.
                # A flagged entry's heap node was consumed by the lazy stats
                # advance, so unflagging MUST re-push unconditionally.
                push = ne - ent[1] > duration // 4 or ne < ent[1] or ent[4]
                ent[1] = ne
                self._reflag(key, ent, ne)
                if push:
                    heapq.heappush(self._expiry_heap, (ne, key))
            ent[5] = self._seq
            self._entries.move_to_end(key)
            if ent[2] and ent[3] != self._seq:
                # allocated by an earlier window that never dispatched
                ent[3] = self._seq
                self._uncommitted.append(ent)
                return ent[0], True
            return ent[0], False

        self.misses += 1
        if self._free:
            slot = self._free.pop()
        else:
            slot = self._reclaim(now)
        ent = [slot, now + duration, True, self._seq, False, self._seq]
        self._entries[key] = ent
        self._reflag(key, ent, now + duration)
        heapq.heappush(self._expiry_heap, (now + duration, key))
        self._uncommitted.append(ent)
        return slot, True

    def _reflag(self, key: str, ent: list, new_expire: int) -> None:
        """Keep `expired_flag == (expire < stats horizon)` exact across an
        expiry change, so stats() stays a subtraction."""
        if ent[4]:
            if new_expire >= self._stats_now:
                ent[4] = False
                self._n_expired -= 1
        elif new_expire < self._stats_now:
            ent[4] = True
            self._n_expired += 1
            self._expired_pool.append(key)

    def _reclaim(self, now: int) -> int:
        """Free a slot from a full table: prefer an EXPIRED entry (its
        device state reads as a miss anyway, kernel lazy-TTL), falling back
        to strict LRU eviction (lru.go:92-94,131-136).

        Mirrors native/host_router.cc try_reclaim_expired: reclaim is
        decided by the entry's CURRENT expiry (hints may be sparse under
        push suppression), a hint whose entry refreshed past `now` is
        re-pushed at the current expiry, and work per attempt is capped so
        an allocation never stalls on a stale-hint burst.

        With the tier hooks installed (state/tiers.py) the LIVE victim is
        picked by heat among the first `victim_sample` eligible LRU-head
        entries and handed to spill_cb for demotion to the warm tier;
        entries touched by the CURRENT drain are skipped where possible —
        their device rows mutate in the not-yet-dispatched drain, so a
        pre-dispatch gather of them would be stale."""
        heap = self._expiry_heap
        pool = self._expired_pool
        budget = 32
        # An entry the current window touched is never reclaimed as
        # expired: a negative duration makes its estimate lie behind `now`
        # while its device row stays live for this window.  Its hint is
        # kept (back in the pool, or re-pushed) for a later window.
        touched = []
        out = None
        # flagged-expired keys whose heap node was consumed by stats():
        # the pool keeps expired-preference intact after a lazy advance
        while pool and budget > 0:
            budget -= 1
            key = pool.popleft()
            ent = self._entries.get(key)
            if ent is None or not ent[4]:
                continue  # dead or refreshed since flagging
            if ent[1] >= now:
                # flagged against a later stats horizon than this reclaim's
                # clock — still counted expired, just not reclaimable yet
                pool.append(key)
                break
            if ent[5] == self._seq:
                touched.append(key)
                continue
            out = self._evict(key, ent)
            break
        pool.extend(touched)
        if out is not None:
            return out
        repush = []
        for _ in range(budget):
            if not heap or heap[0][0] >= now:
                break
            exp, key = heapq.heappop(heap)
            ent = self._entries.get(key)
            if ent is None:
                continue  # dead hint
            # truly expired (current expiry, not hint's) and untouched
            if ent[1] < now and ent[5] != self._seq:
                out = self._evict(key, ent)
                break
            repush.append((ent[1], key))
        for node in repush:
            heapq.heappush(heap, node)
        if out is not None:
            return out
        if len(heap) > 4 * self.capacity:  # compact stale heap nodes
            self._expiry_heap = [(e[1], k) for k, e in self._entries.items()]
            heapq.heapify(self._expiry_heap)
        return self._evict(*self._pick_live_victim())

    def _pick_live_victim(self) -> tuple:
        """LRU-head victim, heat-ranked when the tier hooks are installed.
        Without hooks this is exactly popitem(last=False) — the seed path."""
        if self.spill_cb is None and self.heat_fn is None:
            key = next(iter(self._entries))
            return key, self._entries[key]
        sample = max(1, self.victim_sample)
        best = None
        fallback = None
        scanned = 0
        eligible = 0
        for k, e in self._entries.items():
            scanned += 1
            if fallback is None:
                fallback = (k, e)
            if e[5] != self._seq:
                heat = self.heat_fn(k) if self.heat_fn is not None else 0.0
                if best is None or heat < best[0]:
                    best = (heat, k, e)
                eligible += 1
                if eligible >= sample:
                    break
            # entries touched by this drain are skipped while alternatives
            # exist: spilling one pre-dispatch would lose the drain's
            # staged hits.  The scan is capped so an all-hot head never
            # turns an allocation into an O(capacity) walk.
            if scanned >= 4 * sample:
                break
        if best is not None:
            return best[1], best[2]
        return fallback  # every candidate is hot-path-touched: strict LRU

    def _evict(self, key: str, ent: list) -> int:
        """Drop `key` from the table, keeping the incremental occupancy
        counts exact and offering committed victims to the tier spill
        hook.  Returns the freed slot."""
        del self._entries[key]
        if ent[4]:
            self._n_expired -= 1
        if ent[2]:
            # pending-init victim: its device row was never written, and
            # commit_window must not flip the init flag of a freed entry
            self._uncommitted = [e for e in self._uncommitted if e is not ent]
        elif self.spill_cb is not None:
            self.spill_cb(key, ent[0], ent[1], ent[5] == self._seq)
        return ent[0]

    def peek(self, key: str) -> Optional[int]:
        """Slot for key without LRU touch or allocation; None if absent."""
        ent = self._entries.get(key)
        return None if ent is None else ent[0]

    def remove(self, key: str) -> None:
        ent = self._entries.pop(key, None)
        if ent is not None:
            # the entry may still sit in _uncommitted (allocated this
            # window): commit_window would then mutate a freed entry, and a
            # reuse of the slot could have its init flag cleared by the OLD
            # entry's commit — drop it from the pending list with the entry
            self._uncommitted = [e for e in self._uncommitted if e is not ent]
            if ent[4]:
                self._n_expired -= 1
            self._free.append(ent[0])

    # ------------------------------------------------------- state lifecycle

    def stats(self, now: int) -> dict:
        """Occupancy by the host-side expiry estimate: free slots, live and
        expired resident entries (state/snapshot + cache_stats surface).

        O(1) amortized: the expired count is maintained incrementally (the
        expired_flag transitions at refresh/evict/remove), and each call
        advances the lazy expiry heap past `now` — every pop is charged to
        the push or expiry-crossing event that created it, so a per-drain
        scrape never rescans the arena (the seed did an O(capacity) sweep
        here on every call)."""
        if now < self._stats_now:
            # clock regression (tests mixing time domains): the flags are
            # exact against the high-water horizon only — fall back to the
            # full scan rather than report a wrong split
            live = sum(1 for e in self._entries.values() if e[1] >= now)
        else:
            heap = self._expiry_heap
            pool = self._expired_pool
            entries = self._entries
            while heap and heap[0][0] < now:
                _, key = heapq.heappop(heap)
                ent = entries.get(key)
                if ent is None:
                    continue  # dead hint
                if ent[1] < now:
                    if not ent[4]:
                        ent[4] = True
                        self._n_expired += 1
                        pool.append(key)
                    # no re-push: the pool now tracks it for _reclaim
                else:
                    # refreshed past the hint under push suppression —
                    # re-arm at the current expiry
                    heapq.heappush(heap, (ent[1], key))
            self._stats_now = now
            live = len(entries) - self._n_expired
        return {
            "free": self.capacity - len(self._entries),
            "live": live,
            "expired": len(self._entries) - live,
        }

    def export_entries(self):
        """(key, slot, expire_estimate) in LRU order (oldest first).

        Entries still pending device init are skipped: their device rows
        were never written, so a snapshot of them would resurrect whatever
        the slot's previous tenant left behind."""
        return [(k, e[0], e[1]) for k, e in self._entries.items() if not e[2]]

    def restore_entries(self, entries) -> None:
        """Rebuild the table from export_entries() output (oldest first).
        Replaces all current state; restored entries are committed (their
        device rows are restored by the same snapshot)."""
        self._entries = OrderedDict()
        used = set()
        for key, slot, expire in entries:
            if not (0 <= slot < self.capacity) or slot in used:
                raise ValueError(f"invalid slot {slot} for key {key!r}")
            used.add(slot)
            self._entries[key] = [int(slot), int(expire), False, 0, False, -1]
        self._free = [s for s in range(self.capacity - 1, -1, -1)
                      if s not in used]
        self._expiry_heap = [(e[1], k) for k, e in self._entries.items()]
        heapq.heapify(self._expiry_heap)
        self._uncommitted = []
        self._n_expired = 0
        self._stats_now = 0
        self._expired_pool = deque()

    def upsert(self, key: str, now: int, expire_estimate: int) -> int:
        """Slot for `key`, allocating if absent, with the expiry estimate
        set exactly (migration import: the caller writes the device row in
        the same quiesced section, so the entry is born committed — no
        pending init that a later window commit could clear)."""
        ent = self._entries.get(key)
        if ent is not None:
            if ent[1] != expire_estimate:
                ent[1] = expire_estimate
                self._reflag(key, ent, expire_estimate)
                heapq.heappush(self._expiry_heap, (expire_estimate, key))
            ent[5] = self._seq
            self._entries.move_to_end(key)
            return ent[0]
        slot = self._free.pop() if self._free else self._reclaim(now)
        ent = [slot, expire_estimate, False, self._seq, False, self._seq]
        self._entries[key] = ent
        self._reflag(key, ent, expire_estimate)
        heapq.heappush(self._expiry_heap, (expire_estimate, key))
        return slot

    def is_pending(self, key: str) -> bool:
        """True while the key's slot awaits its initializing dispatch."""
        ent = self._entries.get(key)
        return bool(ent is not None and ent[2])

    def keys(self):
        return list(self._entries.keys())
