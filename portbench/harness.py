"""One run of one cell: build the port's Instance, warm it on the cell's
own traffic, serve the cell's traffic through
`gubernator_tpu_torch.server.serve_get_rate_limits` on wire bytes for the
window, then check every sampled answer against the plain reference.

What runs is the cell's files: the configuration's `instance` block is
the port's `Instance` keyword arguments (a block of settings becomes the
settings class the Instance's signature names), and its `keys`, `hits`,
`rpc_items` and `fill` state the key population; the traffic file names
its driver (drivers/<driver>.py) and the driver's parameters.  A key that
nothing reads is refused: a stated setting is never ignored.

Set-up (everything before the window): the port's kernels and native
router built or loaded into the checkout (`gubernator_tpu_torch/build/`),
the Instance, the RPC pools drawn from the seed, a warm-up of the cell's
own traffic on keys of their own, and where the configuration asks for
it, a fill that serves every key once with hits 0.

The node's clock is the harness's: `BASE_MS` plus the milliseconds since
the run began, given to the pipeline and the batcher through their
`now_fn`.  The router's RPC parse is wrapped (StagingLog): each RPC it
stages is logged with the `now` it was staged at, in staging order, and
the host time of the parse and of the response encode is summed.

The check, after the window: each key falls into one of `groups` groups
(key index modulo groups); a sample of groups drawn from the seed (group
0, which holds the most-drawn key, always among them) is checked whole.
Every request of a sampled key, from the fill, the window and a final
read (hits 0) of every key the window touched, is replayed by
reference/buckets.py in the order the router staged it, at the `now` it
was staged at; every answer of those requests, decoded from the response
bytes, must equal the reference's.  Also held: every RPC taken by the
raw-bytes lane and none refused or failed, and the arena's written rows
as many as the distinct keys sent.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import math
import subprocess
import sys
import time
import typing
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from portbench import loadgen, manifest, roofline, wire
from portbench.reference import buckets

# the node's clock when a run begins (ms since the epoch)
BASE_MS = 1_754_000_000_000
# the probe round's and the fill's RPC size, and how many RPCs each keeps
# in flight
BULK_ITEMS = 1000
BULK_CONCURRENCY = 64
# the fewest items a probe RPC holds (a smaller one could fall under the
# raw-bytes lane's least size)
PROBE_MIN = 100
DRAIN_KERNEL = "drain_compact_kernel"
# what a configuration and a traffic file may hold (prose keys included)
CONFIG_KEYS = frozenset(("source", "reduced", "assumed", "guarantees",
                         "instance", "keys", "hits", "rpc_items", "fill"))
TRAFFIC_KEYS = frozenset(("why", "driver", "groups", "check_groups",
                          "params", "warmup"))
COUNTERS = ("drains", "windows", "decisions", "lanes", "gate_holds",
            "active_s", "depth_s", "staged", "leftover", "refused")


class RunError(Exception):
    """The run cannot measure what the cell asks (no card, no native
    router, traffic that would leave the raw-bytes lane)."""


class WireContext:
    """The least a serve_* body needs of its transport: a deadline (none)
    and an abort that raises."""

    def time_remaining(self):
        return None

    async def abort(self, code, details):
        raise RuntimeError(f"serve_get_rate_limits aborted: {details}")


class StagingLog:
    """Wraps the router's RPC parse and response encode on one Instance:
    each RPC the parse staged with the `now` it was given, in staging
    order, and the host seconds each parse and encode took.  The parse
    runs on the engine thread, the encode on the fetch threads; list
    appends need no lock."""

    def __init__(self, nat):
        self.nat = nat
        self.staged, self.parse_s, self.encode_s = [], [], []
        parse, encode = nat.parse_stack_fast, nat.fastpath_encode_w

        def logged_parse(data, now, *a, **kw):
            t0 = time.perf_counter()
            n = parse(data, now, *a, **kw)
            self.parse_s.append(time.perf_counter() - t0)
            if n >= 0:
                self.staged.append((data, now))
            return n

        def timed_encode(*a, **kw):
            t0 = time.perf_counter()
            m = encode(*a, **kw)
            self.encode_s.append(time.perf_counter() - t0)
            return m

        nat.parse_stack_fast = logged_parse
        nat.fastpath_encode_w = timed_encode

    def mark(self):
        return len(self.parse_s), len(self.encode_s)

    def host_seconds(self, a, b):
        """Parse and encode seconds between two marks."""
        return (sum(self.parse_s[a[0]:b[0]]), sum(self.encode_s[a[1]:b[1]]))


def pipeline_counters(pipe) -> dict:
    snap = pipe.overlap_snapshot()
    wall = snap["active_wall_seconds"]
    return dict(drains=pipe.drains, windows=pipe.windows_staged,
                decisions=pipe.decisions_staged, lanes=pipe.lanes_staged,
                gate_holds=snap["gate_holds"], active_s=wall,
                depth_s=snap["mean_inflight"] * wall,
                staged=pipe.rpc_staged, leftover=pipe.rpc_leftover,
                refused=pipe.rpc_refused)


def counter_delta(a: dict, b: dict) -> dict:
    """The counters' change from a to b, with the mean number of drains in
    flight while any was over that span."""
    out = {k: b[k] - a[k] for k in COUNTERS}
    out["mean_inflight"] = (out["depth_s"] / out["active_s"]
                            if out["active_s"] > 0 else 0.0)
    return out


@dataclass
class Program:
    """The parts of the port the benchmark drives."""

    torch: object
    Instance: Callable
    serve_get_rate_limits: Callable
    fastpath_min_bytes: int


def load_program() -> Program:
    import torch

    from gubernator_tpu_torch.core.service import Instance
    from gubernator_tpu_torch.server import (FASTPATH_MIN_BYTES,
                                             serve_get_rate_limits)
    return Program(torch, Instance, serve_get_rate_limits,
                   FASTPATH_MIN_BYTES)


def instance_kwargs(Instance, spec: dict) -> dict:
    """The Instance's keyword arguments from a configuration's `instance`
    block: each key one of its parameters, a block of settings the
    settings class that parameter names (EngineConfig, QoSConfig, ...).
    An unknown parameter or setting raises RunError."""
    hints = typing.get_type_hints(Instance.__init__)
    kwargs = {}
    for name, value in spec.items():
        if name not in hints or name == "engine":
            raise RunError(f"instance: the port's Instance takes no {name!r}")
        t = hints[name]
        args = [a for a in typing.get_args(t) if a is not type(None)]
        cls = args[0] if typing.get_origin(t) is typing.Union \
            and len(args) == 1 else t
        if isinstance(value, dict) and dataclasses.is_dataclass(cls):
            try:
                value = cls(**value)
            except TypeError as e:
                raise RunError(f"instance.{name}: {e}") from None
        kwargs[name] = value
    return kwargs


def refuse_unknown(what: str, spec: dict, known) -> None:
    unknown = set(spec) - set(known)
    if unknown:
        raise RunError(f"{what}: nothing reads {sorted(unknown)}")


@dataclass
class Run:
    """What one run measured; the metric readers (metrics/*.py) read it.
    `drain_rows` counts the distinct (key, drain) pairs the answered RPCs
    needed and `drain_write_bytes` the arena bytes their hits change
    (roofline.row_write_bytes)."""

    driver: str
    setup_s: float
    window_s: float
    decisions: int
    rpcs: int
    latencies_ms: np.ndarray
    counters: dict
    parse_s: float
    encode_s: float
    drain_rows: int
    drain_write_bytes: int
    trace: Optional[dict] = None


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        and res.stdout.strip() else None


def read_trace(prof, window_s: float) -> dict:
    """Device intervals of a torch.profiler trace: busy seconds (their
    union), the drain kernel's summed seconds, and the breakdown (the ten
    device operations that took most time, the ten longest idle gaps
    named by the operation before them)."""
    from torch.autograd import DeviceType
    ivs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not ivs:
        raise RunError("the profiler's trace holds no device time")
    by_op = defaultdict(float)
    for s, e, name in ivs:
        by_op[kernel_base(name)] += (e - s) / 1e6
    gaps, end, before = [], ivs[0][0], "the window's start"
    for s, e, name in ivs:
        if s > end:
            gaps.append((f"after {before}", (s - end) / 1e6))
        if e >= end:
            end, before = e, kernel_base(name)
    busy = roofline.union_seconds([(s, e) for s, e, _ in ivs])
    return dict(
        busy_s=busy, window_s=window_s,
        drain_kernel_s=by_op.get(DRAIN_KERNEL, 0.0),
        drain_launches=sum(1 for *_, n in ivs
                           if kernel_base(n) == DRAIN_KERNEL),
        device_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=sorted(gaps, key=lambda kv: -kv[1])[:10])


def kernel_base(name: str) -> str:
    """A demangled device event's entry name, without its return type,
    namespaces, template and parameters: `(anonymous
    namespace)::drain_compact_kernel(long const*, ...)` ->
    `drain_compact_kernel` (as observability/devprof.py reads it)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for sep in ("(", "<"):
        i = name.find(sep)
        if i >= 0:
            name = name[:i]
    return name.rsplit("::", 1)[-1].strip()


def _rng(seed: int, stream: int):
    return np.random.default_rng([seed & ((1 << 63) - 1), stream])


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             wrap_serve: Optional[Callable] = None, log=print) -> dict:
    """Run `cell` once and return the result line's object.  `device`
    "cpu" runs the kernels' plain versions (tests); `wrap_serve(serve,
    run_state)` puts something between the harness and the program (the
    control)."""
    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = cell.config, cell.traffic
    refuse_unknown(f"configuration of {cell.name}", config, CONFIG_KEYS)
    refuse_unknown(f"traffic of {cell.name}", traffic, TRAFFIC_KEYS)
    prog = load_program()
    torch = prog.torch
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        raise RunError(f"the cell needs {cell.chips} CUDA device(s); "
                       f"torch sees {torch.cuda.device_count()}")
    try:
        ks = loadgen.Keyspace(config, cell.root)
        driver = manifest.piece("drivers", traffic["driver"], cell.root)
    except (KeyError, TypeError, ValueError) as e:
        raise RunError(f"{cell.name}: {e}") from None
    items = int(config["rpc_items"])
    groups = int(traffic["groups"])
    prefix = config["keys"]["prefix"]
    kwargs = instance_kwargs(prog.Instance, config["instance"])

    t = time.perf_counter()
    inst = prog.Instance(device=device, **kwargs)
    eng, pipe = inst.engine, inst.batcher.pipeline
    if eng.native is None or pipe is None or not pipe.enabled:
        inst.close()
        raise RunError("the native router or the raw-bytes lane is missing")
    t_inst = time.perf_counter() - t
    m0 = time.monotonic_ns()

    def now_fn():
        return BASE_MS + (time.monotonic_ns() - m0) // 1_000_000

    inst.batcher.now_fn = now_fn
    pipe.now_fn = now_fn
    slog = StagingLog(eng.native)

    t = time.perf_counter()
    warmup = traffic["warmup"]
    try:
        warm = driver.pool(ks, items, _rng(seed, 1), "warm", groups,
                           float(warmup["seconds"]), **warmup["params"])
        main = driver.pool(ks, items, _rng(seed, 0), prefix, groups,
                           seconds, **traffic["params"])
    except TypeError as e:
        inst.close()
        raise RunError(f"{cell.name}: driver {traffic['driver']}: {e}") \
            from None
    fill = (loadgen.fill_pool(ks, BULK_ITEMS, prefix, groups)
            if config["fill"] else None)
    small = min(len(d) for p in (warm, main, fill) if p is not None
                for d in p.datas)
    min_bytes = prog.fastpath_min_bytes
    judged = unjudged(ks)
    if small < min_bytes or judged:
        inst.close()
        raise RunError(judged or f"an RPC of {small} bytes would leave the "
                       f"raw-bytes lane (FASTPATH_MIN_BYTES {min_bytes})")
    sample = set(_rng(seed, 2).choice(np.arange(1, groups),
                                      int(traffic["check_groups"]) - 1,
                                      replace=False).tolist()) | {0}
    t_pools = time.perf_counter() - t

    ctx = WireContext()
    pools = {"warm": warm, "fill": fill, "main": main}
    state = dict(slog=slog, pools=pools, keyspace=ks, sample=sample)

    async def serve(data):
        return await prog.serve_get_rate_limits(inst, data, ctx)

    if wrap_serve is not None:
        serve = wrap_serve(serve, state)
    out = {}

    async def script():
        t = time.perf_counter()
        out["warm"] = await driver.drive(serve, warm,
                                         float(warmup["seconds"]))
        out["warm_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["fill"] = ([] if fill is None else await loadgen.send_all(
            serve, fill, BULK_CONCURRENCY, sample))
        out["fill_s"] = time.perf_counter() - t
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        gc.collect()
        gc.freeze()
        # every run on the card traces its window: the end-to-end
        # device_us_per_kdec is read from the trace
        prof = None
        if cuda:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        c0, mk0 = pipeline_counters(pipe), slog.mark()
        t0 = out["t0"] = time.perf_counter()
        out["main"] = await driver.drive(serve, main, seconds, sample)
        out["t1"] = time.perf_counter()
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            out["prof"], out["prof_wall"] = prof, time.perf_counter() - t0
        out["counters"] = counter_delta(c0, pipeline_counters(pipe))
        if inst.qos is not None:
            cc = inst.qos.congestion
            out["qos"] = (f"{cc.effective_window()} decisions, stride "
                          f"{cc._stride:.1f}, {cc.decreases} decreases, "
                          f"{cc.stride_decreases} stride decreases")
        out["host_s"] = slog.host_seconds(mk0, slog.mark())
        out["mem"] = torch.cuda.max_memory_allocated() if cuda else 0
        # the final read of every sampled key the window touched, each
        # group's RPCs made up to PROBE_MIN items with keys it did not
        probe = loadgen.Pool()
        sent = {s.entry for s in out["main"]}
        for g in sorted(sample):
            keys = [main.idx[e] for e in sent if main.group[e] == g]
            if not keys:
                continue
            touched = np.unique(np.concatenate(keys))
            if len(touched) < PROBE_MIN:
                rest = np.setdiff1d(np.arange(g, ks.count, groups), touched)
                touched = np.union1d(touched,
                                     rest[:PROBE_MIN - len(touched)])
            probe.add(*ks.rpcs(touched, np.zeros(len(touched), np.int64),
                               BULK_ITEMS, prefix), g)
        if probe.datas and min(map(len, probe.datas)) < min_bytes:
            raise RunError("a probe RPC would leave the raw-bytes lane")
        pools["probe"] = probe
        out["probe"] = await loadgen.send_all(serve, probe, BULK_CONCURRENCY,
                                              sample)
        out["rows"] = await asyncio.get_running_loop().run_in_executor(
            inst.batcher._executor,
            lambda: int((eng.export_arena()["expire"] != 0).sum()))

    try:
        asyncio.run(script())
    finally:
        inst.close()
    gc.unfreeze()
    del eng, pipe, inst
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    setup_s = out["t0"] - t_start
    c = out["counters"]
    mlog: List[loadgen.Sent] = out["main"]
    ok = [s for s in mlog if s.ok]
    done = np.array([s.done - out["t0"] for s in ok])
    n_items = np.array([len(main.idx[s.entry]) for s in ok])
    per_s = np.bincount(done.astype(np.int64), weights=n_items) \
        if len(done) else np.zeros(0)
    log(f"window: {c['drains']} drains, {c['decisions']} decisions staged, "
        f"{c['lanes']} lanes, mean in flight {c['mean_inflight']:.3f}, gate "
        f"holds {c['gate_holds']}; C parse {out['host_s'][0]:.3f} s, C "
        f"encode {out['host_s'][1]:.3f} s; decisions answered a second: "
        + " ".join(f"{x:.0f}" for x in per_s[:int(seconds) + 1])
        + (f"; QoS window {out['qos']}" if out.get("qos") else ""),
        file=sys.stderr)
    log(f"set-up {setup_s:.3f} s: instance {t_inst:.3f} s, pools "
        f"{t_pools:.3f} s, warm-up {out['warm_s']:.3f} s, fill "
        f"{out['fill_s']:.3f} s ({len(fill.datas) if fill else 0} RPCs)",
        file=sys.stderr)

    t_last = max((s.done for s in mlog), default=out["t1"])
    lat = np.array([(s.done - s.due) * 1e3 if s.ok else math.inf
                    for s in mlog])
    need = {}

    def row_work(e):
        if e not in need:
            need[e] = roofline.row_work(main.idx[e], main.hits[e],
                                        ks.algos(main.idx[e]))
        return need[e]

    run = Run(driver=traffic["driver"], setup_s=setup_s,
              window_s=t_last - out["t0"],
              decisions=sum(len(main.idx[s.entry]) for s in ok),
              rpcs=len(mlog), latencies_ms=lat,
              counters=out["counters"], parse_s=out["host_s"][0],
              encode_s=out["host_s"][1],
              drain_rows=sum(row_work(s.entry)[0] for s in ok),
              drain_write_bytes=sum(row_work(s.entry)[1] for s in ok))
    if "prof" in out:
        run.trace = read_trace(out.pop("prof"), out["prof_wall"])

    checks = check(out, pools, slog, ks, sample)
    correct = all(holds(*c) for c in checks.values())
    metrics = {}
    for m in cell.metrics(trace):
        v = manifest.reader(m["name"], cell.root)(run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=cell.chips if cuda else 0,
               memory_peak_bytes=int(out["mem"]))
    if cuda:
        dev["power"] = power_limit()
    result = dict(correct=bool(correct),
                  attempted=sum(len(main.idx[s.entry]) for s in mlog),
                  failed=sum(len(main.idx[s.entry]) for s in mlog
                             if not s.ok),
                  metrics=metrics, device=dev)
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = dict(
            device_ops=[list(x) for x in run.trace["device_ops"]],
            idle_gaps=[list(x) for x in run.trace["idle_gaps"]])
    result["checks"] = checks
    return result


def unjudged(ks) -> Optional[str]:
    """Why the reference cannot judge the configuration's keys (an
    algorithm or a behavior it has no rule for), or None."""
    idx = np.arange(ks.count, dtype=np.int64)
    for what, have, rules in (("algorithm", ks.algos(idx), buckets.ALGORITHMS),
                              ("behavior", ks.behaviors(idx),
                               buckets.BEHAVIORS)):
        odd = np.ones(len(have), bool)
        for r in rules:
            odd &= have != r
        if odd.any():
            return (f"the reference has no rule for {what} "
                    f"{sorted(set(have[odd].tolist()))[:8]}")
    return None


def decode(bodies):
    """(columns, counts) of the response bodies: wire.decode_responses, or
    the plain codec body by body where a body holds anything else (an
    error string, metadata), so that it still compares."""
    try:
        return wire.decode_responses(bodies)
    except ValueError:
        rows, counts = [], []
        for b in bodies:
            try:
                items = wire.decode_list(b, wire.RESP_FIELDS)
            except (ValueError, IndexError):
                items = []
            counts.append(len(items))
            rows += [[it[c] for c in wire.RESP_COLUMNS] for it in items]
        arr = np.array(rows, np.int64).reshape(-1, 4)
        return ({c: arr[:, j] for j, c in enumerate(wire.RESP_COLUMNS)},
                np.array(counts, np.int64))


def check(out, pools, slog, ks, sample) -> dict:
    """The numbers `correct` compares: [value, relation, limit] each."""
    ids = {}
    for kind, pool in pools.items():
        if pool is not None:
            for e, d in enumerate(pool.datas):
                ids[id(d)] = (kind, e)
    sends = {k: defaultdict(list) for k in pools}
    for kind in pools:
        for s in sorted(out.get(kind, ()), key=lambda s: s.due):
            sends[kind][s.entry].append(s)
    n_sent = sum(len(v) for k in pools for v in sends[k].values())
    taken = defaultdict(int)
    keys, hits, nows, bodies = [], [], [], []
    unknown = 0
    for data, now in slog.staged:
        kind, e = ids.get(id(data), (None, None))
        if kind is None:
            unknown += 1
            continue
        i = taken[kind, e]
        taken[kind, e] += 1
        if i >= len(sends[kind][e]):
            unknown += 1
            continue
        if kind == "warm" or pools[kind].group[e] not in sample:
            continue
        idx = pools[kind].idx[e]
        keys.append(idx)
        hits.append(pools[kind].hits[e])
        nows.append(np.full(len(idx), now, np.int64))
        s = sends[kind][e][i]
        bodies.append((s.out if s.ok else None, len(idx)))
    n_staged = sum(taken.values())
    key = np.concatenate(keys) if keys else np.zeros(0, np.int64)
    want, _ = buckets.replay(
        key, np.concatenate(hits) if hits else key, ks.limits(key),
        np.full(len(key), ks.duration, np.int64), ks.algos(key),
        np.concatenate(nows) if nows else key)
    cols, counts = decode([b for b, _ in bodies if b is not None])
    stacked = np.stack([cols[c] for c in wire.RESP_COLUMNS], 1)
    got = np.zeros((len(key), 4), np.int64)
    valid = np.zeros(len(key), bool)
    pos = item = k = 0
    for b, n in bodies:
        if b is not None:
            cnt = int(counts[k])
            k += 1
            if cnt == n:
                got[pos:pos + n] = stacked[item:item + cnt]
                valid[pos:pos + n] = True
            item += cnt
        pos += n
    wrong = int((~valid).sum() + ((got != want).any(axis=1) & valid).sum())
    failed = sum(1 for kind in pools for s in out.get(kind, ()) if not s.ok)

    def distinct(kinds):
        arrays = [pools[k].idx[e] for k in kinds if pools.get(k) is not None
                  for e, ss in sends[k].items() if ss]
        return len(np.unique(np.concatenate(arrays))) if arrays else 0

    keys_sent = distinct(("warm",)) + distinct(("fill", "main", "probe"))
    return {
        "answers_checked": [len(key), ">=", 1],
        "answers_wrong": [wrong, "<=", 0],
        "rpcs_failed": [failed, "<=", 0],
        "rpcs_not_staged_once": [abs(n_sent - n_staged) + unknown, "<=", 0],
        "rows_minus_keys": [out["rows"] - keys_sent, "==", 0],
    }


def holds(value, relation, limit) -> bool:
    return {"<=": value <= limit, ">=": value >= limit,
            "==": value == limit}[relation]
