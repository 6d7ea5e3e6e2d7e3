"""Host side of the traffic-analytics layer + the SLO burn-rate engine.

The JAX package's `gubernator_tpu/observability/analytics.py`, whole: host
Python over numpy, fed the per-shard stats vectors of the engine's
analytics drains (ops/analytics.py layout).

`TrafficAnalytics` maintains the operator-facing state: a rolling hot-key
top-K merged across drains (scored by the device's cumulative count-min
estimate, decayed in lockstep with the on-device sketch halving),
per-tenant usage totals keyed by tenant name, outcome totals, and the
device-computed arena occupancy/churn.  It also owns the two small
registries a pipeline needs while STAGING a drain: the tenant-name ->
small-int mapping (the device tracks ids, not strings) and the (shard,
slot) -> key labels that turn candidate rows back into readable keys
(unlabelled slots render as ``s<shard>:slot<n>``).  `metrics` may be None:
the port has no metrics module yet.

`SLOEngine` evaluates configured objectives (drain p99, shed rate,
availability) as multi-window multi-burn-rate alerts in the Google SRE
workbook style: burn = bad_fraction / error_budget, and an alert fires
only when BOTH a long window and its short companion (window/12) exceed
the window's threshold.  The clock is injectable for deterministic tests.

Both classes are plain host Python; neither touches the device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from gubernator_tpu_torch.ops import analytics as ops

OTHER_TENANT = "other"


class TrafficAnalytics:
    """Rolling merge of the device stats vectors, one per instance."""

    def __init__(self, conf, metrics=None, now_fn=None):
        self.conf = conf
        self.metrics = metrics
        self._now = now_fn or (lambda: time.time() * 1000.0)
        self._lock = threading.Lock()
        # tenant registry: name -> id in [1, tenant_slots); 0 = other.
        self._tenant_ids: Dict[str, int] = {}
        self._tenant_names: Dict[int, str] = {0: OTHER_TENANT}
        # (shard, slot) -> key string, bounded; insertion order approximates
        # recency well enough for eviction (keys re-label on every staging).
        self._labels: Dict[tuple, str] = {}
        self._label_cap = max(4096, 8 * conf.topk)
        # rolling top-K table: (shard, slot) -> row dict
        self._table: Dict[tuple, dict] = {}
        self._table_cap = 8 * conf.topk
        self._last_decay = None
        self.totals = {
            "decisions": 0, "hits": 0, "under_limit": 0, "over_limit": 0,
            "inits": 0, "drains": 0,
        }
        self._occupancy = {"live": 0, "expired": 0}
        self._tenant_totals: Dict[str, dict] = {}

    # ------------------------------------------------- staging-side registries

    def tenant_id(self, name: str) -> int:
        """Small-int id for a tenant name; the device scatter adds by id.
        Once the registry is full, new tenants share row 0 ("other") —
        bounded accounting beats unbounded label cardinality."""
        tid = self._tenant_ids.get(name)
        if tid is not None:
            return tid
        with self._lock:
            tid = self._tenant_ids.get(name)
            if tid is None:
                nxt = len(self._tenant_ids) + 1
                tid = nxt if nxt < self.conf.tenant_slots else 0
                self._tenant_ids[name] = tid
                if tid:
                    self._tenant_names[tid] = name
        return tid

    def label_slot(self, shard: int, slot: int, key: str) -> None:
        """Remember which key occupies (shard, slot) so candidate rows
        resolve to names.  Called from the staging path — keep it cheap."""
        labels = self._labels
        labels[(shard, slot)] = key
        if len(labels) > self._label_cap:
            # drop the oldest ~25% (dict preserves insertion order)
            for k in list(labels)[:self._label_cap // 4]:
                labels.pop(k, None)

    def forget_labels(self) -> None:
        """Drop every (shard, slot) -> key label (a snapshot restore put
        other keys in the slots; staging labels them again)."""
        self._labels.clear()

    def key_for(self, shard: int, slot: int) -> str:
        return self._labels.get((shard, slot)) or f"s{shard}:slot{slot}"

    # --------------------------------------------------------------- ingest

    def decay_flag(self, now_ms: Optional[float] = None) -> int:
        """1 when the halving cadence elapsed (passed to the device
        reduction as its `decay` scalar), else 0.  The host table halves
        in `ingest` on the same flag so both sides stay comparable."""
        if not self.conf.decay_ms:
            return 0
        now_ms = self._now() if now_ms is None else now_ms
        if self._last_decay is None:
            self._last_decay = now_ms
            return 0
        if now_ms - self._last_decay >= self.conf.decay_ms:
            self._last_decay = now_ms
            return 1
        return 0

    def ingest(self, stats, decayed: int = 0) -> None:
        """Merge one drain's stats block [S_local, V] (host numpy, from
        engine._fetch_local).  Runs on the pipeline completion thread."""
        stats = np.asarray(stats)
        T, K = self.conf.tenant_slots, self.conf.topk
        hdr = stats[:, :ops.HEADER].sum(axis=0)
        trows = stats[:, ops.HEADER:ops.HEADER + T * ops.TENANT_COLS]
        trows = trows.reshape(-1, T, ops.TENANT_COLS).sum(axis=0)
        cands = stats[:, ops.HEADER + T * ops.TENANT_COLS:]
        cands = cands.reshape(-1, K, ops.CAND_COLS)

        m = self.metrics
        with self._lock:
            self.totals["drains"] += 1
            self.totals["decisions"] += int(hdr[ops.IDX_LANES])
            self.totals["hits"] += int(hdr[ops.IDX_HITS])
            self.totals["under_limit"] += int(hdr[ops.IDX_UNDER])
            self.totals["over_limit"] += int(hdr[ops.IDX_OVER])
            self.totals["inits"] += int(hdr[ops.IDX_INIT])
            # occupancy is a level, not a delta: per-shard rows sum to the
            # whole local arena
            self._occupancy = {
                "live": int(stats[:, ops.IDX_LIVE].sum()),
                "expired": int(stats[:, ops.IDX_EXPIRED].sum()),
            }
            if decayed:
                for row in self._table.values():
                    row["score"] >>= 1
                self._table = {k: r for k, r in self._table.items()
                               if r["score"] > 0}

            now_ms = self._now()
            hot = []  # (key, drain_hits) for metrics, outside the lock
            for shard in range(cands.shape[0]):
                for slot, est, dh, dov in cands[shard]:
                    if slot < 0:
                        continue
                    row = self._table.get((shard, slot))
                    if row is None:
                        row = self._table[(shard, slot)] = {
                            "shard": int(shard), "slot": int(slot),
                            "score": 0, "hits": 0, "over": 0, "last_seen": 0}
                    # the estimate is cumulative (the resident sketch), so
                    # overwrite; hits/over are this drain's increments
                    row["score"] = int(est)
                    row["hits"] += int(dh)
                    row["over"] += int(dov)
                    row["last_seen"] = now_ms
                    if dh or dov:
                        hot.append((self.key_for(shard, int(slot)),
                                    int(dh) + int(dov)))
            if len(self._table) > self._table_cap:
                keep = sorted(self._table.items(),
                              key=lambda kv: kv[1]["score"],
                              reverse=True)[:self._table_cap]
                self._table = dict(keep)

            tenant_deltas = []
            for tid in np.nonzero(trows[:, 0])[0]:
                dec, th, tov = (int(x) for x in trows[tid])
                name = self._tenant_names.get(int(tid), OTHER_TENANT)
                tot = self._tenant_totals.setdefault(
                    name, {"decisions": 0, "hits": 0, "over_limit": 0})
                tot["decisions"] += dec
                tot["hits"] += th
                tot["over_limit"] += tov
                tenant_deltas.append((name, dec - tov, tov))

        if m is not None:
            m.observe_churn(int(hdr[ops.IDX_INIT]))
            for key, h in hot:
                m.observe_hot_key(key, h)
            for name, under, over in tenant_deltas:
                m.observe_tenant(name, under, over)

    # ------------------------------------------------------------ snapshots

    def occupancy(self) -> dict:
        with self._lock:
            return dict(self._occupancy)

    def topk_snapshot(self, n: Optional[int] = None) -> List[dict]:
        n = n or self.conf.topk
        with self._lock:
            rows = sorted(self._table.values(),
                          key=lambda r: r["score"], reverse=True)[:n]
            return [{"key": self.key_for(r["shard"], r["slot"]), **r}
                    for r in rows]

    def snapshot(self) -> dict:
        with self._lock:
            totals = dict(self.totals)
            occupancy = dict(self._occupancy)
            tenants = {k: dict(v) for k, v in self._tenant_totals.items()}
        return {
            "totals": totals,
            "occupancy": occupancy,
            "tenants": tenants,
            "topk": self.topk_snapshot(),
        }


class SLOEngine:
    """Multi-window multi-burn-rate evaluation of configured objectives.

    Evidence arrives as good/bad event counts per objective and lands in
    1-second buckets; burn rates are computed over each configured
    (window, threshold) pair at read time, so tests drive it with a fake
    clock and get deterministic firings."""

    BUCKET_S = 1.0

    def __init__(self, conf, now_fn=None):
        self.conf = conf
        self._now = now_fn or time.monotonic
        self._lock = threading.Lock()
        self._windows = conf.windows()
        self._max_window = max(w for w, _ in self._windows)
        # objective -> error budget (allowed bad fraction)
        self.objectives = {
            "drain_p99": conf.drain_budget,
            "shed_rate": conf.shed_budget,
            "availability": 1.0 - conf.availability,
        }
        # objective -> deque of [bucket_ts, good, bad]
        self._buckets = {name: deque() for name in self.objectives}

    def _record(self, name: str, good: int = 0, bad: int = 0) -> None:
        now = self._now()
        ts = int(now / self.BUCKET_S)
        with self._lock:
            dq = self._buckets[name]
            if dq and dq[-1][0] == ts:
                dq[-1][1] += good
                dq[-1][2] += bad
            else:
                dq.append([ts, good, bad])
            horizon = ts - int(self._max_window / self.BUCKET_S) - 1
            while dq and dq[0][0] < horizon:
                dq.popleft()

    # ------------------------------------------------------------- evidence

    def observe_drain(self, wall_seconds: float, decisions: int) -> None:
        """One completed drain: latency evidence for drain_p99, served
        decisions as the good mass for shed_rate/availability."""
        slow = wall_seconds * 1000.0 > self.conf.drain_p99_ms
        self._record("drain_p99", good=0 if slow else 1, bad=1 if slow else 0)
        if decisions > 0:
            self._record("shed_rate", good=decisions)
            self._record("availability", good=decisions)

    def observe_shed(self, n: int = 1) -> None:
        self._record("shed_rate", bad=n)
        self._record("availability", bad=n)

    def observe_error(self, n: int = 1) -> None:
        self._record("availability", bad=n)

    # --------------------------------------------------------------- reading

    def _bad_fraction(self, name: str, window_s: float, now: float) -> float:
        cutoff = int((now - window_s) / self.BUCKET_S)
        good = bad = 0
        for ts, g, b in self._buckets[name]:
            if ts > cutoff:
                good += g
                bad += b
        total = good + bad
        return (bad / total) if total else 0.0

    def burn_rates(self) -> Dict[str, dict]:
        """{objective: {budget, windows: {"300s": burn, ...}, firing}} —
        firing iff ANY (window, threshold) pair has burn > threshold in
        both the window and its window/12 short companion."""
        now = self._now()
        out: Dict[str, dict] = {}
        with self._lock:
            for name, budget in self.objectives.items():
                wins, firing = {}, False
                for win, thr in self._windows:
                    burn = self._bad_fraction(name, win, now) / budget
                    short = self._bad_fraction(
                        name, max(win / 12.0, self.BUCKET_S), now) / budget
                    wins[f"{int(win)}s"] = round(burn, 4)
                    if burn > thr and short > thr:
                        firing = True
                out[name] = {"budget": budget, "windows": wins,
                             "firing": firing}
        return out

    def snapshot(self) -> dict:
        return {
            "objectives": {
                "drain_p99_ms": self.conf.drain_p99_ms,
                "drain_budget": self.conf.drain_budget,
                "shed_budget": self.conf.shed_budget,
                "availability": self.conf.availability,
            },
            "burn_windows": [
                {"window_s": w, "threshold": t} for w, t in self._windows],
            "burn_rates": self.burn_rates(),
        }
