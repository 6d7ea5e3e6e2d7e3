"""A closed loop: each of `groups` callers sends its next RPC when its
last one is answered.

A caller owns the keys of its group (key index % groups): every item drawn
for it is drawn from its own keys (the configuration's draw, conditioned
on the group), so each key's requests arrive in the order its one caller
sends them.  Parameters in the traffic file: `items_per_caller`, the
items of whole RPCs each caller's pool holds (cycled).
"""

from __future__ import annotations

import asyncio
import time
from typing import List

from portbench.loadgen import Keyspace, Pool, Sent


def pool(ks: Keyspace, items: int, rng, prefix: str, groups: int,
         seconds: float, items_per_caller: int) -> Pool:
    """Whole RPCs of at least `items_per_caller` items for each caller,
    each caller's items drawn from its own key group; `streams` holds each
    caller's RPCs in sending order."""
    out = Pool()
    n = -(-int(items_per_caller) // items) * items
    for c in range(groups):
        idx = ks.draw_keys(rng, n, c, groups)
        out.streams.append(out.add(
            *ks.rpcs(idx, ks.draw_hits(rng, n), items, prefix), c))
    return out


async def drive(serve, pool: Pool, seconds: float,
                keep=frozenset()) -> List[Sent]:
    """Each caller sends its next RPC (cycling its stream) when the last
    one is answered, until `seconds` have passed; every RPC in flight then
    runs to its end.  Responses are kept for RPCs of the groups in
    `keep`."""
    log: List[Sent] = []
    stop = time.perf_counter() + seconds

    async def caller(c):
        stream, i = pool.streams[c], 0
        while time.perf_counter() < stop:
            e = stream[i % len(stream)]
            i += 1
            t0 = time.perf_counter()
            try:
                out, ok = await serve(pool.datas[e]), True
            except Exception:
                out, ok = None, False
            log.append(Sent(e, t0, time.perf_counter(), ok,
                            out if pool.group[e] in keep else None))

    await asyncio.gather(*(caller(c) for c in range(len(pool.streams))))
    return log
