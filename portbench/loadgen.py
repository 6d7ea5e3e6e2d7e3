"""The benchmark's one traffic generator: a configuration's keys, pools of
RPC bytes drawn from the seed, and the bulk sender.

A configuration file's `keys` states the key population: how many, how
they are drawn (`draw`, a file of draws/) and each key's algorithm, limit
and behavior (`algorithm`, `limit`, `behavior`, each a file of rules/ with
its parameters); `hits` states the hits an item asks.  A traffic file
names the driver (drivers/<driver>.py) that makes its pool from these and
sends it.  Everything is drawn from the run's seed with numpy, and the
RPC bytes are built at once (wire.request_items), before anything is
served.

Keys fall into `groups` by key index modulo `groups`; every RPC holds the
keys of one group, and the check samples whole groups.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from portbench import manifest, wire

# the chunk of items built at once (bounds the generator's memory)
BUILD_CHUNK = 1 << 20
KEYS = frozenset(("count", "prefix", "digits", "names", "duration_ms",
                  "draw", "algorithm", "limit", "behavior"))


class Keyspace:
    """A configuration's keys: key index -> name, unique key, limit,
    duration, algorithm and behavior, and the draw over indices.  A key
    the configuration states that nothing here reads is refused, and so is
    a parameter that its draw or rule does not take."""

    def __init__(self, config: dict, root: Path = manifest.ROOT):
        k = config["keys"]
        unknown = set(k) - KEYS
        if unknown:
            raise ValueError(f"keys: unknown {sorted(unknown)}")
        self.count = int(k["count"])
        self.digits = int(k["digits"])
        if 10 ** self.digits < self.count:
            raise ValueError("keys.digits too few for keys.count")
        self.names = int(k["names"])
        self.duration = int(k["duration_ms"])
        draw = dict(k["draw"])
        self._draw = manifest.piece("draws", draw.pop("name"), root).draw
        self._draw_params = draw
        self._rules = {}
        for what in ("algorithm", "limit", "behavior"):
            rule = dict(k[what])
            fn = manifest.piece("rules", rule.pop("rule"), root).values
            self._rules[what] = (fn, rule)
            fn(np.arange(2, dtype=np.int64), **rule)  # its parameters
        self.draw_keys(np.random.default_rng(0), 1)
        h = config["hits"]
        self.hit_values = np.asarray(h["values"], np.int64)
        w = np.asarray(h["weights"], np.float64)
        self.hit_p = w / w.sum()

    def _rule(self, what, idx):
        fn, params = self._rules[what]
        return fn(np.asarray(idx, np.int64), **params)

    def limits(self, idx):
        return self._rule("limit", idx)

    def algos(self, idx):
        return self._rule("algorithm", idx)

    def behaviors(self, idx):
        return self._rule("behavior", idx)

    def draw_keys(self, rng, n, group=0, groups=1):
        """n key indices from the configuration's draw, conditioned on
        index % groups == group."""
        return np.asarray(self._draw(rng, n, self.count, group, groups,
                                     **self._draw_params), np.int64)

    def draw_hits(self, rng, n):
        return rng.choice(self.hit_values, n, p=self.hit_p)

    def rpcs(self, idx, hits, items, prefix):
        """RPCs of at most `items` items, as many as needed and as even in
        size as they can be, for these keys and hits: (list of request
        bytes, list of idx arrays, list of hits arrays)."""
        datas, idxs, hitss = [], [], []
        n = len(idx)
        k = -(-n // items)
        bounds = np.concatenate([[0], np.cumsum(
            np.full(k, n // k) + (np.arange(k) < n % k))]) if n else [0]
        lo = 0
        while lo < len(bounds) - 1:
            hi = lo + 1
            while (hi < len(bounds) - 1
                   and bounds[hi + 1] - bounds[lo] <= BUILD_CHUNK):
                hi += 1
            a0 = bounds[lo]
            i = np.asarray(idx[a0:bounds[hi]], np.int64)
            h = np.asarray(hits[a0:bounds[hi]], np.int64)
            m = len(i)
            names = np.concatenate(
                [np.full((m, 1), ord("t"), np.uint8),
                 wire.digits(i % self.names, len(str(self.names - 1)))], 1)
            keys = np.concatenate(
                [np.broadcast_to(np.frombuffer(prefix.encode(), np.uint8),
                                 (m, len(prefix))),
                 wire.digits(i, self.digits)], 1)
            flat, starts = wire.request_items(
                names, keys, h, self.limits(i),
                np.full(m, self.duration, np.int64), self.algos(i),
                self.behaviors(i))
            for a, b in zip(bounds[lo:hi] - a0, bounds[lo + 1:hi + 1] - a0):
                datas.append(flat[starts[a]:starts[b]].tobytes())
                idxs.append(i[a:b])
                hitss.append(h[a:b])
            lo = hi
        return datas, idxs, hitss


@dataclass
class Pool:
    """RPCs to send: their bytes and, per RPC, its key indices, hits and
    key group; `streams` holds a driver's order of sending (for a closed
    loop, each caller's RPC indices)."""

    datas: List[bytes] = field(default_factory=list)
    idx: List[np.ndarray] = field(default_factory=list)
    hits: List[np.ndarray] = field(default_factory=list)
    group: List[int] = field(default_factory=list)
    streams: List[List[int]] = field(default_factory=list)

    def add(self, datas, idxs, hitss, group):
        """Append RPCs whose keys all lie in `group`; their indices."""
        first = len(self.datas)
        self.datas += datas
        self.idx += idxs
        self.hits += hitss
        self.group += [group] * len(datas)
        return list(range(first, len(self.datas)))


def fill_pool(ks: Keyspace, items: int, prefix: str, groups: int) -> Pool:
    """Every key once with hits 0, group by group in key order, `items` to
    an RPC."""
    pool = Pool()
    for g in range(groups):
        idx = np.arange(g, ks.count, groups, dtype=np.int64)
        pool.add(*ks.rpcs(idx, np.zeros(len(idx), np.int64), items, prefix),
                 g)
    return pool


@dataclass
class Sent:
    """One RPC sent: its pool index, when it was due (a closed loop: when
    it was sent) and answered (perf_counter seconds), and its response
    bytes (None where the RPC failed or was not kept)."""

    entry: int
    due: float
    done: float
    ok: bool
    out: Optional[bytes]


async def send_all(serve, pool: Pool, concurrency: int,
                   keep=frozenset()) -> List[Sent]:
    """Every RPC of the pool once, `concurrency` at a time (a closed loop
    that stops when the pool is spent); responses kept for RPCs of the
    groups in `keep`."""
    log: List[Sent] = []
    it = iter(range(len(pool.datas)))

    async def worker():
        for e in it:
            t0 = time.perf_counter()
            try:
                out, ok = await serve(pool.datas[e]), True
            except Exception:
                out, ok = None, False
            log.append(Sent(e, t0, time.perf_counter(), ok,
                            out if pool.group[e] in keep else None))

    await asyncio.gather(*(worker() for _ in range(concurrency)))
    return log
