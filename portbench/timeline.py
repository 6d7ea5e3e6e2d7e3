"""What the host was doing while the card sat idle: one run of a cell with
the program's drain timeline placed on the profiler's clock.

    python3 portbench/timeline.py --workload <cell> --seed <n> \
        --seconds <s>

runs the cell once as `portbench/run.py --trace 1` does
(harness.run_cell) and reads, around its window, what the harness's
result does not hold: the port's drain timeline (its pipeline's
`timeline`, gubernator_tpu_torch/core/drain_ring.py: a row for every
committed drain with the stamps the pipeline takes on `time.monotonic()`,
its counts, the router's own C clocks over its parse and encode with the
binding's wall around them, the engine thread's CPU and wall seconds
across its fill; a segment for every pump that held pending decisions
back, `gate` or `depth`), anchor pairs of the monotonic and real clocks,
and the window's device events.  The timeline's log goes to standard
error, and the last line of standard output is one JSON object: the
router's clocks and the fill's CPU share over the window, the split of
the card's idle time into host states, the clock fit it rests on, and the
outside timing (`wire_host_us_per_kdec.sat`) beside them.

The harness has no hook for these reads, so `traced_run` takes them by
wrapping, for its one run, the harness's `pipeline_counters` (called just
after the profiler starts and just after it stops: the window's first
anchor and ring marks, then its rows), its `read_trace` (the device
events) and the driver's `drive` (the window's end).  The benchmark's
own runs, metrics and checks are untouched by it.

The shared clock.  A device event of the torch.profiler trace sits at
`trace_start_ns + time_range.start x 1000` on the profiler's clock, which
reads as CLOCK_REALTIME; the first anchor maps it onto the pipeline's
monotonic stamps.  The mapping is then checked against the drains
themselves, matched in dispatch order to the `drain_compact_kernel`
launches: a kernel cannot start before its drain's pack_done, and the
fetch thread's wait (fetch_start; a chain's chain_fetch_done) cannot end
before the drain's first copy out ends.  So each drain bounds the
correction d (host = anchor-mapped + d) from both sides.  The card's
clock can wander from the host's by milliseconds for seconds, so d is
fitted in pieces of PIECE_DRAINS drains: a constant inside every bound of
the piece (0 where the anchor lies in the band), else a line with the
drift that leaves the widest band.  The band's width bounds the error of
each device interval's placement.  The idle split is None, and the log
says why, where a piece fits no line or where d must step at a piece's
start, from the band the piece before allows there to its own, by more
than its band (the mapping between the two is then unknown): a wrong
attribution is worse than none.

The attribution.  Every device-idle instant of the window is given to the
first host state that holds there (core/drain_ring.py state_seconds):
fill (the engine thread between a drain's started and its dispatch_done),
engine_queue (submitted, not started), gate, depth (held pending
decisions), answer (between dispatch_done and committed), no_work.  Idle
time the ring no longer covers (rows lost to a wrap) is `unknown`.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

# the drift a fit may try, in seconds a second
MAX_DRIFT = 1e-3
# drains a piece of the clock fit spans (section "The shared clock")
PIECE_DRAINS = 256
ROOT = Path(__file__).resolve().parent.parent


def anchor() -> tuple:
    """(monotonic ns, realtime ns), read back to back."""
    return time.monotonic_ns(), time.time_ns()


def ring_marks(pipe) -> Optional[tuple]:
    """The timeline's write counts (drains, holds), or None for a program
    without one."""
    ring = getattr(pipe, "timeline", None)
    if ring is None:
        return None
    return ring.drains_written, ring.holds_written


def ring_rows(pipe, marks) -> Optional[dict]:
    """The drain rows and hold segments written since `marks`, and how
    many of them the ring no longer held."""
    if marks is None:
        return None
    ring = pipe.timeline
    rows, holds = ring.drains(marks[0]), ring.holds(marks[1])
    return dict(rows=rows, holds=holds,
                lost=(ring.drains_written - marks[0] - len(rows))
                + (ring.holds_written - marks[1] - len(holds)))


def device_events(prof) -> Optional[dict]:
    """The trace's device intervals as (start us, end us, name) from the
    trace's start, and that start in profiler-clock ns; None without a
    start."""
    from torch.autograd import DeviceType
    try:
        start_ns = int(prof.profiler.kineto_results.trace_start_ns())
    except AttributeError:
        return None
    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return dict(start_ns=start_ns, events=evs)


def to_host(device: dict, a0: tuple):
    """The trace's events placed on the monotonic clock by the anchor a0:
    (starts, ends) in seconds and their names."""
    # the trace's start on the monotonic clock
    base = (device["start_ns"] - (a0[1] - a0[0])) / 1e9
    evs = device["events"]
    return (np.array([base + s / 1e6 for s, _, _ in evs]),
            np.array([base + e / 1e6 for _, e, _ in evs]),
            [n for _, _, n in evs])


def _bounds(rows, kernels, dtoh):
    """Each launched drain's bounds on the correction d, in dispatch
    order: lower (pack_done - its kernel's start), upper (its fetch wait's
    end - its first copy out's end; NaN where no copy out follows its
    kernel before the next), and that wait's end."""
    ks = np.array([k[0] for k in kernels])
    lower = rows["pack_done"] - ks
    order = np.argsort([c[0] for c in dtoh], kind="stable")
    ds = np.array([dtoh[i][0] for i in order])
    de = np.array([dtoh[i][1] for i in order])
    nxt = np.concatenate((ks[1:], [np.inf]))
    j = np.searchsorted(ds, ks, side="left")
    wait = np.where(rows["chain_fetch_done"] > 0, rows["chain_fetch_done"],
                    rows["fetch_start"])
    has = (j < len(ds)) & (ds[np.minimum(j, len(ds) - 1)] < nxt) \
        & (wait > 0) if len(ds) else np.zeros(len(ks), bool)
    upper = np.full(len(ks), np.nan)
    upper[has] = wait[has] - de[j[has]]
    return lower, upper, wait


def _fit_piece(lo_b, lo_t, hi_b, hi_t) -> dict:
    """d over one piece: a constant where one fits inside every bound,
    else a + b (t - t0) with the drift b that leaves the widest band."""
    lo, hi = float(lo_b.max()), float(hi_b.min())
    t0 = float(lo_t[0])
    if lo <= hi:
        inside = lo <= 0.0 <= hi
        return dict(ok=True, t0=t0, drift=0.0, band_s=hi - lo, lower_s=lo,
                    upper_s=hi, anchor_in_band=inside,
                    anchor_place=(-lo / (hi - lo) if hi > lo else 0.5),
                    offset_s=0.0 if inside else (lo + hi) / 2)

    def gap(b):
        return (float((lo_b - b * (lo_t - t0)).max())
                - float((hi_b - b * (hi_t - t0)).min()))

    a, c = -MAX_DRIFT, MAX_DRIFT
    for _ in range(200):  # the gap is convex in b
        m1, m2 = a + (c - a) / 3, c - (c - a) / 3
        if gap(m1) <= gap(m2):
            c = m2
        else:
            a = m1
    b = (a + c) / 2
    if gap(b) > 0:
        return dict(ok=False, cross_s=lo - hi, cross_drift_s=gap(b),
                    drift=b)
    a0 = float((lo_b - b * (lo_t - t0)).max())
    return dict(ok=True, t0=t0, drift=b, band_s=-gap(b), lower_s=lo,
                upper_s=hi, anchor_in_band=False, anchor_place=None,
                offset_s=a0 - gap(b) / 2)


def _band_at(p: dict, t: float) -> tuple:
    """The d a piece allows at time t: its constant band, or its line's
    band about the line."""
    if p["drift"] == 0.0:
        return p["lower_s"], p["upper_s"]
    c = p["offset_s"] + p["drift"] * (t - p["t0"])
    return c - p["band_s"] / 2, c + p["band_s"] / 2


def fit(rows, kernels, dtoh) -> dict:
    """The correction d that places the anchor-mapped trace on the
    pipeline's clock, fitted inside every drain's bounds, piece by piece
    (PIECE_DRAINS drains each; the last piece takes a short tail): in each
    a constant where one fits, else with a linear drift.  The rows come
    in commit order, which two fetch threads can swap: they are matched to
    the kernels in dispatch order (the engine thread starts drains one at
    a time).  Returns {ok, why, pieces, ...}; `jumps` lists the pieces
    at whose first kernel d must step, from the piece before's band to
    their own, by more than their band."""
    rows = np.sort(rows, order="started")
    if len(kernels) != len(rows):
        first = rows["pack_done"][0] - kernels[0][0] if len(rows) else 0.0
        edges = "" if not len(kernels) or not len(rows) else (
            f" (the first packed {1e3 * first:.3f} ms after the first "
            f"kernel's start, the last "
            f"{1e3 * (rows['pack_done'][-1] - kernels[-1][0]):.3f} ms after "
            f"the last's)")
        return dict(ok=False, why=f"{len(kernels)} drain kernel launches in "
                    f"the trace, {len(rows)} launched drains in the ring"
                    + edges)
    if not len(rows):
        return dict(ok=False, why="no launched drain to place the trace")
    lower, upper, wait = _bounds(rows, kernels, dtoh)
    n = len(rows)
    cuts = list(range(0, n, PIECE_DRAINS))
    if len(cuts) > 1 and n - cuts[-1] < PIECE_DRAINS // 2:
        cuts.pop()
    pieces = []
    for a, b in zip(cuts, cuts[1:] + [n]):
        up = upper[a:b]
        has = ~np.isnan(up)
        if not has.any():
            return dict(ok=False, why=f"drains {a}-{b - 1}: no copy out "
                        "bounds the trace from above", pieces=pieces)
        p = _fit_piece(lower[a:b], rows["pack_done"][a:b], up[has],
                       wait[a:b][has])
        if not p["ok"]:
            return dict(ok=False, pieces=pieces, why=(
                f"no offset fits drains {a}-{b - 1}: their bounds cross by "
                f"{1e3 * p['cross_s']:.3f} ms, {1e3 * p['cross_drift_s']:.3f}"
                f" ms with the best drift ({p['drift'] * 1e6:.1f} ppm)"))
        p["drains"] = (a, b)
        p["device_from"] = float(kernels[a][0])
        pieces.append(p)
    jumps = []
    for k, (p, q) in enumerate(zip(pieces, pieces[1:]), 1):
        (lp, hp), (lq, hq) = (_band_at(x, q["device_from"]) for x in (p, q))
        step = lq - hp if lq > hp else hq - lp if hq < lp else 0.0
        if abs(step) > q["band_s"]:
            jumps.append((k, step, q["band_s"]))
    bands = [p["band_s"] for p in pieces]
    return dict(ok=True, why="", pieces=pieces, band_s=min(bands),
                band_max_s=max(bands),
                anchor_in_band=all(p["anchor_in_band"] for p in pieces),
                anchor_pieces=sum(p["anchor_in_band"] for p in pieces),
                drift_pieces=sum(p["drift"] != 0.0 for p in pieces),
                jumps=jumps, bounded=(n, int((~np.isnan(upper)).sum())))


def correction(f: dict, t) -> np.ndarray:
    """The fitted d at anchor-mapped times t: each time in the piece whose
    first kernel it follows (times before the first piece in that one)."""
    ps = f["pieces"]
    starts = np.array([p["device_from"] for p in ps])
    k = np.clip(np.searchsorted(starts, t, side="right") - 1, 0, len(ps) - 1)
    off = np.array([p["offset_s"] for p in ps])[k]
    drift = np.array([p["drift"] for p in ps])[k]
    t0 = np.array([p["t0"] for p in ps])[k]
    return off + drift * (t - t0)


def fit_summary(f: Optional[dict]) -> Optional[dict]:
    """What a run's attribution rests on: its pieces, how many hold the
    anchor in their band, how many needed a drift, the bands' widths (the
    error bound of each device interval's placement) and the jumps."""
    if f is None or not f.get("pieces"):
        return None
    ps = f["pieces"]
    return dict(pieces=len(ps),
                anchor_pieces=sum(p["anchor_in_band"] for p in ps),
                drift_pieces=sum(p["drift"] != 0.0 for p in ps),
                band_min_ms=1e3 * min(p["band_s"] for p in ps),
                band_max_ms=1e3 * max(p["band_s"] for p in ps),
                offset_min_ms=1e3 * min(p["offset_s"] for p in ps),
                offset_max_ms=1e3 * max(p["offset_s"] for p in ps),
                jumps=len(f.get("jumps", ())))


def analyse(ring: Optional[dict], device: Optional[dict], a0: tuple,
            a1: tuple, log=print) -> Optional[dict]:
    """The window's ring counts and, with a device trace, the fit and the
    split of the card's idle time (seconds and percent of it), with the
    ten longest idle gaps and their splits.  None for a program without a
    timeline."""
    if ring is None:
        return None
    from gubernator_tpu_torch.core.drain_ring import merge, state_seconds
    from portbench.harness import DRAIN_KERNEL, kernel_base
    rows, holds = ring["rows"], ring["holds"]
    launched = rows[rows["launched"] == 1]
    out = dict(rows=len(rows), launched=len(launched), lost=ring["lost"],
               holds=len(holds), decisions=int(rows["decisions"].sum()),
               fit=None, idle_pct=None, why="no trace")
    if device is None:
        return out
    lo_h, hi_h = a0[0] / 1e9, a1[0] / 1e9
    ds, de, names = to_host(device, a0)
    names = [kernel_base(n) for n in names]
    kernels = [(s, e) for s, e, n in zip(ds, de, names) if n == DRAIN_KERNEL]
    dtoh = [(s, e) for s, e, n in zip(ds, de, names) if "DtoH" in n]
    f = out["fit"] = fit(launched, kernels, dtoh)
    anchor_drift_ms = ((a1[1] - a1[0]) - (a0[1] - a0[0])) / 1e6
    if not f["ok"]:
        out["why"] = f["why"]
        log(f"timeline: no attribution: {f['why']}", file=sys.stderr)
        return out
    ps = f["pieces"]
    log(f"timeline: {len(rows)} drains ({len(launched)} launched, "
        f"{ring['lost']} rows lost), {len(holds)} holds; clock fit in "
        f"{len(ps)} pieces: band {f['band_s'] * 1e3:.4f}-"
        f"{f['band_max_s'] * 1e3:.4f} ms, the anchor inside in "
        f"{f['anchor_pieces']} of {len(ps)}, drift in {f['drift_pieces']}"
        f" (at most {max(abs(p['drift']) for p in ps) * 1e6:.1f} ppm), "
        f"{len(f['jumps'])} jumps; bounds {f['bounded'][0]} below, "
        f"{f['bounded'][1]} above; the second anchor "
        f"{anchor_drift_ms:.4f} ms off the first", file=sys.stderr)
    for p in ps:
        log(f"timeline: piece drains {p['drains'][0]}-{p['drains'][1] - 1}"
            f": band {p['lower_s'] * 1e3:.4f} to {p['upper_s'] * 1e3:.4f} "
            f"ms, {p['band_s'] * 1e3:.4f} wide, anchor place "
            f"{p['anchor_place']}, offset {p['offset_s'] * 1e3:.4f} ms, "
            f"drift {p['drift'] * 1e6:.1f} ppm", file=sys.stderr)
    if f["jumps"]:
        k, step, band = f["jumps"][0]
        out["why"] = (f"the clock's correction steps {step * 1e3:.4f} ms "
                      f"at piece {k}, past its {band * 1e3:.4f} ms band "
                      f"({len(f['jumps'])} jumps)")
        log(f"timeline: no attribution: {out['why']}", file=sys.stderr)
        return out
    shift = correction(f, ds)
    busy = merge(ds + shift, de + shift, lo_h, hi_h)
    known = lo_h if not ring["lost"] else max(
        lo_h, float(rows["submitted"][0] or rows["started"][0]))
    sec = state_seconds(rows, holds, known, hi_h, busy)
    idle = (hi_h - lo_h) - float((busy[1] - busy[0]).sum())
    unknown = idle - sum(sec.values())
    out.update(idle_s=idle, idle_state_s=sec, unknown_s=unknown, why="",
               idle_pct={k: 100.0 * v / idle for k, v in sec.items()}
               if idle > 0 else None)
    # the idle gaps: between the window's edges and the busy union
    gs = np.concatenate(([lo_h], busy[1]))
    ge = np.concatenate((busy[0], [hi_h]))
    order = np.argsort(gs - ge)[:10]
    gaps = [(float(gs[i] - lo_h), float(ge[i] - gs[i]),
             state_seconds(rows, holds, float(gs[i]), float(ge[i])))
            for i in order if ge[i] > gs[i]]
    out["gaps"] = gaps
    if out["idle_pct"] is not None:
        log("timeline: device idle "
            f"{idle:.4f} s: " + ", ".join(
                f"{k} {v:.3f}%" for k, v in out["idle_pct"].items())
            + f"; unknown {100.0 * unknown / idle:.3f}%", file=sys.stderr)
    for at, length, sp in gaps:
        log(f"timeline: idle gap at {at:.4f} s, {length * 1e3:.3f} ms: "
            + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in sp.items()
                        if v > 0), file=sys.stderr)
    return out


def traced_run(cell, seed: int, seconds: float, device: str = "cuda",
               log=print) -> dict:
    """Run `cell` once through harness.run_cell with its window traced,
    the timeline read around the window (see the module's docstring), and
    return the result object the tool prints."""
    from portbench import harness, manifest
    driver = manifest.piece("drivers", cell.traffic["driver"], cell.root)
    counters, read_trace, drive = (harness.pipeline_counters,
                                   harness.read_trace, driver.drive)
    seen: dict = {}

    def window_counters(pipe):
        c = counters(pipe)
        if "a0" not in seen:
            seen.update(a0=anchor(), marks=ring_marks(pipe), c0=c)
        else:
            seen.update(ring=ring_rows(pipe, seen["marks"]), c1=c)
        return c

    def traced(prof, window_s):
        seen["device"] = device_events(prof)
        return read_trace(prof, window_s)

    async def timed_drive(*a, **kw):
        sent = await drive(*a, **kw)
        if "a0" in seen and "a1" not in seen:
            seen["a1"] = anchor()
        return sent

    harness.pipeline_counters, harness.read_trace = window_counters, traced
    driver.drive = timed_drive
    try:
        res = harness.run_cell(cell, seed, seconds, True, device, log=log)
    finally:
        harness.pipeline_counters, harness.read_trace = counters, read_trace
        driver.drive = drive
    decisions = res["attempted"] - res["failed"]
    out = dict(workload=cell.name, seed=seed, correct=res["correct"],
               device=res["device"], decisions=decisions,
               wire_host_us_per_kdec=res["metrics"].get(
                   "wire_host_us_per_kdec.sat", {}).get("value"))
    t = analyse(seen.get("ring"), seen.get("device"), seen["a0"],
                seen["a1"], log)
    if t is None:
        out["why"] = "the program keeps no drain timeline"
        return out
    from gubernator_tpu_torch.core.drain_ring import host_figures
    c0, c1 = seen["c0"], seen["c1"]
    out.update(host_figures(seen["ring"]["rows"], decisions))
    inside = [out.get(k) for k in ("parse_c_us_per_kdec",
                                   "encode_c_us_per_kdec",
                                   "native_wait_us_per_kdec")]
    if out["wire_host_us_per_kdec"] and None not in inside:
        out["inside_over_outside"] = sum(inside) / \
            out["wire_host_us_per_kdec"]
    out.update(idle_pct=t["idle_pct"], why=t["why"],
               fit=fit_summary(t["fit"]), launched=t["launched"],
               drains_counted=c1["drains"] - c0["drains"],
               ring_decisions=t["decisions"],
               decisions_staged=c1["decisions"] - c0["decisions"])
    if t["idle_pct"] is not None:
        out["idle_unknown_pct"] = 100.0 * t["unknown_s"] / t["idle_s"]
        out["idle_sum_pct"] = sum(t["idle_pct"].values())
    return out


def main(argv=None) -> int:
    import argparse
    import os
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    # the program's settings come from the cell's configuration alone
    for k in [k for k in os.environ if k.startswith("GUBER_")]:
        del os.environ[k]
    from portbench import harness, manifest
    cell = manifest.load_cell(args.workload, ROOT)
    try:
        out = traced_run(cell, args.seed, args.seconds)
    except harness.RunError as e:
        print(f"timeline: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
