"""Host-side concurrency-lease book.

The CONCURRENCY algorithm's device state is one counter per key (free
slots); the device neither knows nor cares WHO holds the taken slots.  This
book is the host-side shadow that does: grants per (key, client), so that

  * a client that vanishes (gRPC stream torn down before its acquire
    response was delivered, or a forwarding peer the health detector
    declares dead) gets its held slots released back to the device,
  * ring migration can re-register in-flight leases on the new owner
    (state/migrate.py ships the book rows next to the arena rows), and
  * operators can see who is holding what (lease gauges).

The book is intentionally advisory: the device counter is the source of
truth for admission, and every grant carries the bucket's expiry, so a book
that loses rows (process restart without snapshot) self-heals as buckets
expire on-device.  All mutations are O(1) dict operations under one lock —
the book sits on the host decision path, never on the device path.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple


@dataclass
class LeaseGrant:
    """Live slots one client holds on one key."""

    key: str
    client: str
    count: int
    expire: int  # unix ms; mirrors the bucket row's expire column


class LeaseBook:
    """Grants per (key, client) with reverse index per client."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # key -> client -> [count, expire]
        self._by_key: Dict[str, Dict[str, List[int]]] = {}
        # client -> set of keys (reverse index for release_client)
        self._by_client: Dict[str, set] = {}

    # ------------------------------------------------------------- mutation

    def acquire(self, key: str, client: str, n: int, expire: int) -> None:
        """Record n granted slots; re-arms the grant's expiry (the device
        re-armed the bucket's on the same decision)."""
        if n <= 0:
            return
        with self._lock:
            grants = self._by_key.setdefault(key, {})
            cell = grants.get(client)
            if cell is None:
                grants[client] = [n, expire]
                self._by_client.setdefault(client, set()).add(key)
            else:
                cell[0] += n
                cell[1] = max(cell[1], expire)

    def release(self, key: str, client: str, n: int) -> int:
        """Drop up to n granted slots; returns how many were actually
        held (the device release saturates the same way)."""
        if n <= 0:
            return 0
        with self._lock:
            grants = self._by_key.get(key)
            cell = grants.get(client) if grants else None
            if cell is None:
                return 0
            took = min(n, cell[0])
            cell[0] -= took
            if cell[0] <= 0:
                del grants[client]
                self._unlink(client, key)
                if not grants:
                    del self._by_key[key]
            return took

    def release_client(self, client: str) -> List[Tuple[str, int]]:
        """Drop EVERY grant a client holds (stream close / peer death);
        returns [(key, count)] so the caller can push the matching
        negative-hits releases through the device."""
        with self._lock:
            keys = self._by_client.pop(client, None)
            if not keys:
                return []
            out: List[Tuple[str, int]] = []
            for key in keys:
                grants = self._by_key.get(key)
                cell = grants.pop(client, None) if grants else None
                if cell and cell[0] > 0:
                    out.append((key, cell[0]))
                if grants is not None and not grants:
                    del self._by_key[key]
            return out

    def sweep(self, now: int) -> List[Tuple[str, str, int]]:
        """Drop grants whose expiry passed (the device bucket already
        expired, so there is nothing to release there); returns the dropped
        (key, client, count) rows for the lease gauges."""
        dropped: List[Tuple[str, str, int]] = []
        with self._lock:
            for key in list(self._by_key):
                grants = self._by_key[key]
                for client in list(grants):
                    cnt, exp = grants[client]
                    if exp < now:
                        dropped.append((key, client, cnt))
                        del grants[client]
                        self._unlink(client, key)
                if not grants:
                    del self._by_key[key]
        return dropped

    def _unlink(self, client: str, key: str) -> None:
        keys = self._by_client.get(client)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_client[client]

    # -------------------------------------------------------------- queries

    def held(self, key: str) -> int:
        with self._lock:
            grants = self._by_key.get(key)
            return sum(c[0] for c in grants.values()) if grants else 0

    def count(self, client: str, key: str) -> int:
        """Slots this client holds on this key (0 if none) — the
        GUBER_LEASE_MAX_PER_CLIENT admission pre-check reads this."""
        with self._lock:
            grants = self._by_key.get(key)
            cell = grants.get(client) if grants else None
            return cell[0] if cell else 0

    def holds(self, client: str, key: Optional[str] = None) -> bool:
        """Does this client hold any grant (on `key`, or anywhere)?  Used
        by QoS: lease holders are exempt from deadline shedding — shedding
        a release would leak the slot until bucket expiry."""
        with self._lock:
            keys = self._by_client.get(client)
            if not keys:
                return False
            return key in keys if key is not None else True

    def stats(self) -> Tuple[int, int, int]:
        """(distinct keys, distinct clients, total held slots)."""
        with self._lock:
            total = sum(c[0] for g in self._by_key.values()
                        for c in g.values())
            return len(self._by_key), len(self._by_client), total

    # --------------------------------------------- snapshot / migration I/O

    def export_rows(self,
                    keys: Optional[Iterable[str]] = None
                    ) -> List[Tuple[str, str, int, int]]:
        """[(key, client, count, expire)]; restricted to `keys` when the
        caller is migrating a shard slice rather than snapshotting."""
        with self._lock:
            if keys is None:
                items = self._by_key.items()
            else:
                want = set(keys)
                items = ((k, g) for k, g in self._by_key.items()
                         if k in want)
            return [(k, client, cell[0], cell[1])
                    for k, grants in items
                    for client, cell in grants.items()]

    def import_rows(self,
                    rows: Iterable[Tuple[str, str, int, int]]) -> int:
        """Merge exported rows (snapshot restore, migration import);
        returns how many rows landed.  Merging is additive on count and
        max on expiry — the same shape as concurrent acquires."""
        n = 0
        for key, client, count, expire in rows:
            if count > 0:
                self.acquire(str(key), str(client), int(count), int(expire))
                n += 1
        return n

    def drop_keys(self, keys: Iterable[str]) -> None:
        """Forget grants for keys handed off to another owner (the
        importing side re-registers them from the shipped rows)."""
        with self._lock:
            for key in set(keys):
                grants = self._by_key.pop(key, None)
                if not grants:
                    continue
                for client in grants:
                    self._unlink(client, key)
