"""Drive a front door hub's rings from recorded RPCs, without gRPC.

A replay process stands in for one of frontdoor.py's gRPC workers: it
attaches to the worker's segments and runs the worker's own code path
(`_WorkerV1.GetRateLimits`: batched wire reads, frontdoor_parse_req into
the slab, RAW records for what the parser refuses, the completion pump and
frontdoor_encode_resp), fed by serialized GetRateLimitsReq bytes instead
of a gRPC server.  Like a gRPC worker it imports no torch and no grpc, so
it runs where grpc is not installed and measures the front door's
worker-side costs without the gRPC stack.

Start it through the hub: FrontdoorHub(..., worker_entry=
"gubernator_tpu_torch.frontdoor_replay:replay_main", worker_args=(ctl,)),
where `ctl` is a directory.  It publishes port -1 (no listener).  The
engine side writes commands as pickles `ctl/cmd_<n>.pkl` (n = 0, 1, ...),
each a dict with "mode":

  "burst"     {"rpcs": [bytes], "callers": c}: caller j sends rpcs[j],
              rpcs[j + c], ... back to back; the result's "resps" holds
              each RPC's response bytes (None where it failed);
  "saturate"  {"rpcs", "items": [int], "callers", "seconds"}: each caller
              cycles through its share until the time is up; "n" is the
              decisions answered (an item shed or in a failed call is no
              decision), "rpcs" the calls made, "wall" the seconds;
  "rate"      {"rpcs", "items", "rate", "seconds"}: open loop, one RPC
              every mean(items) / rate seconds; "n" is the decisions
              answered, "rpcs" the calls made, and "lat_ms" the latency
              from its scheduled send of each call answered with no item
              shed;
  "stop"      the process exits.

and each replay process answers with `ctl/res_<n>_<worker>.pkl`, which
also carries the worker's C parse and encode seconds so far ("parse_s",
"encode_s"), its failed calls ("errors") and its calls with a shed item,
by the first shed item's reason ("sheds").
"""

from __future__ import annotations

import asyncio
import os
import pickle
import time
from collections import Counter

from gubernator_tpu_torch.core import shm_ring
from gubernator_tpu_torch.frontdoor import _WorkerV1, attach_worker


class ReplayAbort(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(f"status {code}: {message}")
        self.code = code


class _ReplayContext:
    """What _WorkerV1 reads of a gRPC context: no deadline, no metadata,
    and an abort (integer status codes) that raises."""

    integer_codes = True

    def time_remaining(self):
        return None

    def invocation_metadata(self):
        return ()

    async def abort(self, code, message=""):
        raise ReplayAbort(code, message)


# a metadata map entry's key "shed_reason" (field 1, length 11): one in
# each shed item of a GetRateLimitsResp
_SHED_KEY = b"\x0a\x0bshed_reason"


def _shed_items(resp: bytes) -> int:
    """How many of a response's items were shed."""
    return resp.count(_SHED_KEY)


def _shed_reason(resp: bytes):
    """The shed reason of a response's first item, or None (a shed item's
    metadata carries "shed_reason" followed by the reason)."""
    at = resp.find(b"shed_reason")
    if at < 0:
        return None
    n = resp[at + 12]  # after "shed_reason", the value's tag byte 0x12
    return resp[at + 13:at + 13 + n].decode("utf-8", "replace")


async def _run(v1: _WorkerV1, cmd: dict) -> dict:
    ctx = _ReplayContext()
    rpcs = cmd["rpcs"]
    out = {"errors": 0, "sheds": Counter()}

    async def call(i):
        """RPC i's response (None where the call failed) and the
        decisions it answered."""
        try:
            resp = await v1.GetRateLimits(rpcs[i % len(rpcs)], ctx)
        except ReplayAbort:
            out["errors"] += 1
            return None, 0
        shed = _shed_items(resp)
        if shed:
            out["sheds"][_shed_reason(resp)] += 1
        return resp, items[i % len(rpcs)] - shed if items else 0

    mode = cmd["mode"]
    items = cmd.get("items")
    if mode == "burst":
        c = cmd["callers"]
        resps = [None] * len(rpcs)

        async def caller(j):
            for i in range(j, len(rpcs), c):
                resps[i], _ = await call(i)

        await asyncio.gather(*(caller(j) for j in range(c)))
        out["resps"] = resps
    elif mode == "saturate":
        c = cmd["callers"]
        done, calls = [0], [0]
        stop = time.perf_counter() + cmd["seconds"]

        async def caller(j):
            i = j
            while time.perf_counter() < stop:
                _, n = await call(i)
                done[0] += n
                calls[0] += 1
                i += c

        t0 = time.perf_counter()
        await asyncio.gather(*(caller(j) for j in range(c)))
        out["n"], out["wall"] = done[0], time.perf_counter() - t0
        out["rpcs"] = calls[0]
    elif mode == "rate":
        loop = asyncio.get_running_loop()
        period = (sum(items) / len(items)) / cmd["rate"]
        n = max(1, int(cmd["seconds"] / period))
        lat, done = [], [0]

        async def one(i, at):
            resp, answered = await call(i)
            done[0] += answered
            if resp is not None and answered == items[i % len(rpcs)]:
                lat.append((loop.time() - at) * 1e3)

        t0 = loop.time()
        tasks = []
        for i in range(n):
            at = t0 + i * period
            delay = at - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            tasks.append(asyncio.ensure_future(one(i, at)))
        await asyncio.gather(*tasks)
        out["lat_ms"] = lat
        out["n"], out["rpcs"] = done[0], n
        out["wall"] = loop.time() - t0
    else:
        raise ValueError(f"unknown replay mode {mode!r}")
    out["sheds"] = dict(out["sheds"])
    return out


async def _amain(worker_id, prefix, slots, slab_bytes, fastpath_min,
                 encode_mode, batch_reads, ctl) -> None:
    w = attach_worker(worker_id, prefix, slots, slab_bytes, fastpath_min,
                      encode_mode, batch_reads)
    w.status.set_w(worker_id, shm_ring.W_PORT, -1)
    v1 = _WorkerV1(w)
    poller = asyncio.create_task(w.poll_loop())
    ppid = os.getppid()
    seq = 0
    try:
        while True:
            path = os.path.join(ctl, f"cmd_{seq}.pkl")
            if not os.path.exists(path):
                if os.getppid() != ppid:
                    return  # orphaned: the engine is gone
                await asyncio.sleep(0.01)
                continue
            with open(path, "rb") as f:
                cmd = pickle.load(f)[worker_id]
            if cmd["mode"] == "stop":
                return
            res = await _run(v1, cmd)
            res["parse_s"], res["encode_s"] = w.parse_s, w.encode_s
            tmp = os.path.join(ctl, f".res_{seq}_{worker_id}.tmp")
            with open(tmp, "wb") as f:
                pickle.dump(res, f)
            os.replace(tmp, os.path.join(ctl, f"res_{seq}_{worker_id}.pkl"))
            seq += 1
    finally:
        poller.cancel()
        w.chan.close()
        w.status.close()


def replay_main(worker_id: int, prefix: str, slots: int, slab_bytes: int,
                listen_host: str, port_hint: int, fastpath_min: int,
                encode_mode: str, batch_reads: int, ctl: str) -> None:
    """The replay process's entry point (worker_main's arguments, then
    the command directory)."""
    asyncio.run(_amain(worker_id, prefix, slots, slab_bytes, fastpath_min,
                       encode_mode, batch_reads, ctl))


def write_command(ctl: str, seq: int, per_worker: list) -> None:
    """Publish command `seq`: per_worker[i] is worker i's dict."""
    tmp = os.path.join(ctl, f".cmd_{seq}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(per_worker, f)
    os.replace(tmp, os.path.join(ctl, f"cmd_{seq}.pkl"))


async def await_results(ctl: str, seq: int, workers: int,
                        timeout: float = 600.0) -> list:
    """Wait (yielding to the event loop, which serves the records) for
    every worker's answer to command `seq`."""
    paths = [os.path.join(ctl, f"res_{seq}_{i}.pkl") for i in range(workers)]
    deadline = time.monotonic() + timeout
    while not all(os.path.exists(p) for p in paths):
        if time.monotonic() > deadline:
            raise TimeoutError(f"replay command {seq} unanswered")
        await asyncio.sleep(0.005)
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(pickle.load(f))
    return out
