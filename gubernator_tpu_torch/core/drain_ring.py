"""The serving pipeline's drain timeline: the stamps each drain already
takes, kept.

`DispatchPipeline` (core/pipeline.py) stamps every drain on one monotonic
clock (`time.monotonic()`): the loop hands it to the engine executor
(`submitted`), the engine thread starts it, finishes packing and
dispatching it, a fetch thread waits for its event and decodes it, and the
loop resolves its callers (`committed`).  Each committed drain writes
those stamps, its counts (jobs, decisions, lanes, windows), the router's
own C clocks summed over its parse and its encode with the binding's wall
around them (native/__init__.py RouterClock) and the engine thread's CPU
and wall seconds across its fill into one row of a preallocated ring.  A
pump that returns early while decisions are pending opens a hold segment
(start, end, reason) in a second ring: `gate` for the occupancy gate or
the coalescing wait, `depth` when the drains in flight fill the depth;
the segment closes when the reason changes, a drain is submitted, or
nothing is pending.  A drain's `held_since` is the first such pump since
the drain before it was submitted.

The rings are always on: one row write a drain and one a hold segment,
both on the event loop, which is also where they are read (no lock).
The operator reads them in `/v1/admin/debug`: `stage_snapshot()` gives
the drain stages of its `stages` table (the stage histograms' names and
boundaries, with or without a Metrics registry, and the two stages only
the ring sees, `held` and `engine_queue`), and `summary()` the
`pipeline.timeline` figures: per drain, its jobs, decisions, fold factor
and windows; per 1000 decisions, the router's C parse and encode and the
binding's wait around them; the engine thread's CPU share of its fills;
and the share of the drains' wall each host state held, the states taken
in priority order (`fill` first, then `engine_queue`, `gate`, `depth`,
`answer`; `no_work` the rest).  `state_seconds` also splits the card's
idle time, given its busy intervals (portbench/timeline.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# rows (and hold segments) each ring keeps: a 20 s serving window holds at
# most ~10k drains
TIMELINE_CAPACITY = 65_536
# the drains the debug view summarizes
SUMMARY_DRAINS = 1024

HOLD_GATE = 1
HOLD_DEPTH = 2

# stamps are monotonic seconds, 0.0 where the drain never reached one
DRAIN_DTYPE = np.dtype([
    ("held_since", "f8"), ("submitted", "f8"), ("oldest_enq", "f8"),
    ("started", "f8"), ("pack_done", "f8"), ("dispatch_done", "f8"),
    ("wait_start", "f8"), ("fetch_start", "f8"), ("fetch_done", "f8"),
    ("chain_fetch_start", "f8"), ("chain_fetch_done", "f8"),
    ("committed", "f8"),
    ("launched", "i1"), ("jobs", "i4"), ("decisions", "i8"),
    ("lanes", "i8"), ("k_used", "i4"),
    ("parse_c_ns", "i8"), ("parse_wall_ns", "i8"),
    ("encode_c_ns", "i8"), ("encode_wall_ns", "i8"),
    ("fill_cpu_s", "f8"), ("fill_wall_s", "f8"),
])
HOLD_DTYPE = np.dtype([("start", "f8"), ("end", "f8"), ("reason", "i1")])

HOST_STATES = ("fill", "engine_queue", "gate", "depth", "answer", "no_work")


class DrainRing:
    """Two preallocated rings: drain rows (DRAIN_DTYPE) and hold segments
    (HOLD_DTYPE).  `drains_written` / `holds_written` count every row ever
    written; `drains(since)` and `holds(since)` return the rows from that
    count on that the ring still holds, oldest first."""

    def __init__(self, capacity: int = TIMELINE_CAPACITY):
        self.capacity = capacity
        self._drains = np.zeros(capacity, DRAIN_DTYPE)
        self._holds = np.zeros(capacity, HOLD_DTYPE)
        self.drains_written = 0
        self.holds_written = 0

    def add_drain(self, res, committed: float) -> None:
        """One committed drain (a pipeline _DrainResult)."""
        self._drains[self.drains_written % self.capacity] = (
            res.held_since, res.submitted, res.oldest_enq, res.started,
            res.pack_done, res.dispatch_done, res.wait_start,
            res.fetch_start, res.fetch_done, res.chain_fetch_start,
            res.chain_fetch_done, committed, res.words is not None,
            len(res.staged), res.n_decisions, res.n_lanes, res.k_used,
            res.parse_c_ns, res.parse_wall_ns, res.encode_c_ns,
            res.encode_wall_ns, res.fill_cpu_s, res.fill_wall_s)
        self.drains_written += 1

    def add_hold(self, start: float, end: float, reason: int) -> None:
        self._holds[self.holds_written % self.capacity] = (start, end, reason)
        self.holds_written += 1

    def _since(self, ring: np.ndarray, written: int, since: int) -> np.ndarray:
        first = max(since, written - self.capacity, 0)
        idx = np.arange(first, written) % self.capacity
        return ring[idx]

    def drains(self, since: int = 0) -> np.ndarray:
        return self._since(self._drains, self.drains_written, since)

    def holds(self, since: int = 0) -> np.ndarray:
        return self._since(self._holds, self.holds_written, since)

    def stage_snapshot(self, last: int = SUMMARY_DRAINS) -> Dict[str, dict]:
        """The last `last` drains' stages in the stage histograms' form
        (observability/metrics.py stage_snapshot: count, p50/p95/p99 and
        mean in ms, nearest rank), each over the drains that reached both
        its stamps; a chain's shared fetch counts once a chain."""
        rows = self.drains(self.drains_written - last)
        wait = np.where(rows["wait_start"] > 0, rows["wait_start"],
                        rows["fetch_start"])
        chain = rows["chain_fetch_start"]
        first = np.zeros(len(rows), bool)
        first[np.unique(chain, return_index=True)[1]] = True
        stages = (
            ("admission_wait", rows["oldest_enq"], rows["started"], None),
            ("held", rows["held_since"], rows["submitted"], None),
            ("engine_queue", rows["submitted"], rows["started"], None),
            ("window_fill", rows["started"], rows["pack_done"], None),
            ("device_dispatch", rows["pack_done"], rows["dispatch_done"],
             None),
            ("drain_commit", wait, rows["fetch_done"], None),
            ("chain_fetch", chain, rows["chain_fetch_done"], first),
        )
        out = {}
        for name, a, b, keep in stages:
            ok = (a > 0) & (b > 0)
            if keep is not None:
                ok &= keep & (b > a)
            if ok.any():
                ms = (b[ok] - a[ok]) * 1e3
                p50, p95, p99 = np.percentile(ms, [50, 95, 99],
                                              method="inverted_cdf")
                out[name] = {"count": int(ok.sum()), "p50_ms": float(p50),
                             "p95_ms": float(p95), "p99_ms": float(p99),
                             "mean_ms": float(ms.mean())}
        return out

    def summary(self, last: int = SUMMARY_DRAINS) -> dict:
        """The last `last` drains: per drain their jobs, decisions,
        decisions a lane (the fold factor) and windows; per 1000
        decisions the router's C parse and encode and the binding's wait
        around them (its wall less the C time: the ctypes marshalling and
        the wait to take the interpreter lock back), in us; the engine
        thread's CPU share of its fills; and the share of the drains'
        wall (the first one's submission to the last commit) each host
        state held, in percent."""
        rows = self.drains(self.drains_written - last)
        out: dict = {"drains": int(len(rows)),
                     "drains_written": self.drains_written,
                     "holds_written": self.holds_written}
        if not len(rows):
            return out
        dec = float(rows["decisions"].sum())
        lanes = float(rows["lanes"].sum())
        out.update(
            jobs_per_drain=float(rows["jobs"].mean()),
            decisions_per_drain=dec / len(rows),
            decisions_per_lane=dec / lanes if lanes else None,
            windows_per_drain=float(rows["k_used"].mean()),
            **host_figures(rows, dec))
        lo = float(rows["submitted"][0] or rows["started"][0])
        hi = float(rows["committed"].max())
        out["wall_s"] = hi - lo
        sec = state_seconds(rows, self.holds(self.holds_written
                                             - self.capacity), lo, hi)
        out["host_state_pct"] = {k: 100.0 * v / (hi - lo) if hi > lo else 0.0
                                 for k, v in sec.items()}
        return out


def host_figures(rows: np.ndarray, decisions: float) -> dict:
    """Over `rows`, per 1000 `decisions`, in us: the router's C parse, its
    C encodes, and the binding's wall less the C time over both (the
    ctypes marshalling and the wait to take the interpreter lock back);
    and the engine thread's CPU share of the fills, in %."""
    kdec = decisions / 1e3
    c_ns = float(rows["parse_c_ns"].sum() + rows["encode_c_ns"].sum())
    wall_ns = float(rows["parse_wall_ns"].sum()
                    + rows["encode_wall_ns"].sum())
    fill_wall = float(rows["fill_wall_s"].sum())
    return dict(
        parse_c_us_per_kdec=(float(rows["parse_c_ns"].sum()) / 1e3 / kdec
                             if kdec else None),
        encode_c_us_per_kdec=(float(rows["encode_c_ns"].sum()) / 1e3
                              / kdec if kdec else None),
        native_wait_us_per_kdec=((wall_ns - c_ns) / 1e3 / kdec
                                 if kdec else None),
        fill_cpu_pct=(100.0 * float(rows["fill_cpu_s"].sum()) / fill_wall
                      if fill_wall > 0 else None))


def merge(starts, ends, lo: float, hi: float) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """The union of the intervals within [lo, hi] as sorted disjoint
    (starts, ends)."""
    s = np.clip(np.asarray(starts, np.float64), lo, hi)
    e = np.clip(np.asarray(ends, np.float64), lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    if not len(s):
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    # a component starts where an interval begins past every earlier end
    first = np.flatnonzero(np.concatenate(([True], s[1:] > reach[:-1])))
    last = np.concatenate((first[1:], [len(s)])) - 1
    return s[first], reach[last]


def covered(starts, ends, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the union of the intervals covers."""
    s, e = merge(starts, ends, lo, hi)
    return float((e - s).sum())


def state_intervals(rows: np.ndarray, holds: np.ndarray
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(starts, ends) of the five host states the stamps show, in
    HOST_STATES order; `no_work` is what none of them covers."""
    dispatched = rows["dispatch_done"] > 0
    fill_end = np.where(dispatched, rows["dispatch_done"], rows["pack_done"])
    sub = rows["submitted"] > 0
    gate = holds["reason"] == HOLD_GATE
    depth = holds["reason"] == HOLD_DEPTH
    return [
        (rows["started"], fill_end),
        (rows["submitted"][sub], rows["started"][sub]),
        (holds["start"][gate], holds["end"][gate]),
        (holds["start"][depth], holds["end"][depth]),
        (rows["dispatch_done"][dispatched], rows["committed"][dispatched]),
    ]


def state_seconds(rows: np.ndarray, holds: np.ndarray, lo: float, hi: float,
                  busy: Optional[Tuple[np.ndarray, np.ndarray]] = None
                  ) -> Dict[str, float]:
    """Seconds of [lo, hi] outside `busy` ((starts, ends), e.g. the card's
    busy intervals) each host state held, each instant given to the first
    state in HOST_STATES that holds there; `no_work` is the rest."""
    bs, be = busy if busy is not None else (np.zeros(0), np.zeros(0))
    base = covered(bs, be, lo, hi)
    out, prev = {}, 0.0
    ss, ee = [bs], [be]
    for name, (s, e) in zip(HOST_STATES, state_intervals(rows, holds)):
        ss.append(s)
        ee.append(e)
        cum = covered(np.concatenate(ss), np.concatenate(ee), lo, hi) - base
        out[name] = cum - prev
        prev = cum
    out["no_work"] = (hi - lo) - base - prev
    return out
