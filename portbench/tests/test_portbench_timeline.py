"""portbench/timeline.py: the clock fit against drains' bounds, the
split of the card's idle time on synthetic drains and device events, the
anchor's mapping of a CPU profiler event onto the pipeline's clock, and a
traced run on the CPU through the tool's wrapping of the harness."""

import time

import numpy as np
import pytest

from gubernator_tpu_torch.core.drain_ring import (
    DRAIN_DTYPE,
    HOLD_DTYPE,
    HOST_STATES,
)
from portbench import harness, manifest, timeline
from portbench.tests.test_portbench_faults import small

def drains(n, period=1.0, t0=100.0):
    """n drains a period apart: submitted at t, started 0.1 later, packed
    by 0.3, dispatched by 0.35, fetched 0.5-0.55, committed at 0.6."""
    rows = np.zeros(n, DRAIN_DTYPE)
    t = t0 + period * np.arange(n)
    for name, at in (("submitted", 0.0), ("started", 0.1),
                     ("pack_done", 0.3), ("dispatch_done", 0.35),
                     ("wait_start", 0.36), ("fetch_start", 0.5),
                     ("fetch_done", 0.55), ("committed", 0.6)):
        rows[name] = t + at
    rows["launched"] = 1
    rows["decisions"] = 100
    return rows


def device_for(rows, skew=0.0, drift=0.0):
    """Each drain's device work as the harness reads it: a copy in, the
    drain kernel 0.31-0.40 after submission, two copies out to 0.45, on a
    clock `skew` s behind the host's, running `drift` s a second fast."""
    evs = []
    for t in rows["submitted"]:
        for a, b, name in ((0.305, 0.308, "Memcpy HtoD (Pinned -> Device)"),
                           (0.31, 0.40, "void (anonymous namespace)::"
                            "drain_compact_kernel(long const*, long*)"),
                           (0.41, 0.43, "Memcpy DtoH (Device -> Pinned)"),
                           (0.43, 0.45, "Memcpy DtoH (Device -> Pinned)")):
            evs.append(((t + a - skew) * (1 + drift), (t + b - skew)
                        * (1 + drift), name))
    return evs


def ring(rows, holds=None):
    return dict(rows=rows, holds=np.zeros(0, HOLD_DTYPE)
                if holds is None else holds, lost=0)


def device(evs, start_ns=0):
    """Events given in host seconds as the trace holds them: us from a
    trace start, itself in realtime ns (the anchor (0, start_ns) maps it
    back onto host seconds)."""
    return dict(start_ns=start_ns,
                events=[(s * 1e6, e * 1e6, n) for s, e, n in evs])


def quiet(*a, **k):
    pass


def test_fit_finds_the_anchor_inside_the_band():
    rows = drains(50)
    f = timeline.fit(rows, *kernels_and_copies(device_for(rows)))
    assert f["ok"] and f["anchor_in_band"] and len(f["pieces"]) == 1
    assert f["jumps"] == []
    p = f["pieces"][0]
    # the kernel starts 0.01 after pack_done, the fetch wait ends 0.07
    # after the first copy out
    assert p["lower_s"] == pytest.approx(-0.01)
    assert p["upper_s"] == pytest.approx(0.07)
    assert p["offset_s"] == 0.0 and p["drift"] == 0.0
    assert f["band_s"] == pytest.approx(0.08)
    # rows come in commit order, which two fetch threads can swap: they
    # are matched to the kernels in dispatch order all the same
    swapped = rows.copy()
    swapped[[20, 21]] = swapped[[21, 20]]
    g = timeline.fit(swapped, *kernels_and_copies(device_for(rows)))
    assert g["ok"] and g["anchor_in_band"]
    assert g["pieces"][0]["lower_s"] == p["lower_s"]
    assert g["pieces"][0]["upper_s"] == p["upper_s"]


def kernels_and_copies(evs):
    k = [(s, e) for s, e, n in evs if "drain_compact_kernel" in n]
    d = [(s, e) for s, e, n in evs if "DtoH" in n]
    return k, d


def test_fit_corrects_a_skew_and_a_drift():
    rows = drains(50)
    f = timeline.fit(rows, *kernels_and_copies(device_for(rows, skew=0.2)))
    assert f["ok"] and not f["anchor_in_band"]
    p = f["pieces"][0]
    assert p["lower_s"] <= p["offset_s"] <= p["upper_s"]
    assert 0.19 <= p["offset_s"] <= 0.27
    # 500 ppm over 200 s moves the last drain 100 ms past the first: a
    # constant cannot fit bounds 80 ms wide at every drain, a drift can
    rows = drains(100, period=2.0, t0=1000.0)
    evs = device_for(rows, drift=500e-6)
    k, d = kernels_and_copies(evs)
    assert timeline.fit(rows[:1], k[:1], d[:2])["ok"]
    f = timeline.fit(rows, k, d)
    assert f["ok"] and f["band_s"] >= 0 and f["drift_pieces"] == 1
    assert f["pieces"][0]["drift"] == pytest.approx(-500e-6, rel=0.1)


def test_fit_follows_a_step_piece_by_piece():
    """The device clock steps 0.5 s between the first PIECE_DRAINS drains
    and the rest: no one line fits every drain, one fit a piece does, the
    correction moves the later device work by the step, and the step is
    a jump wider than the band, so the idle split is withheld."""
    n = timeline.PIECE_DRAINS
    rows = drains(2 * n)
    evs = device_for(rows[:n]) + device_for(rows[n:], skew=0.5)
    k, d = kernels_and_copies(evs)
    f = timeline.fit(rows, k, d)
    assert f["ok"] and len(f["pieces"]) == 2
    assert f["anchor_pieces"] == 1 and not f["anchor_in_band"]
    first, second = f["pieces"]
    assert first["drains"] == (0, n) and second["drains"] == (n, 2 * n)
    assert first["offset_s"] == 0.0
    assert 0.49 <= second["offset_s"] <= 0.57
    t = np.array([k[0][0], k[n][0]])
    assert timeline.correction(f, t) == pytest.approx(
        [0.0, second["offset_s"]])
    assert [k for k, _, _ in f["jumps"]] == [1]
    out = timeline.analyse(ring(rows), device(evs), (0, 0),
                           (int(600e9), int(600e9)), quiet)
    assert out["fit"]["ok"] and out["idle_pct"] is None
    assert "jumps" in out["why"]
    assert timeline.fit_summary(out["fit"])["jumps"] == 1
    # a short tail joins the last piece
    g = timeline.fit(rows[:n + 10],
                     *kernels_and_copies(device_for(rows[:n + 10])))
    assert [p["drains"] for p in g["pieces"]] == [(0, n + 10)]


def test_a_steady_drift_across_pieces_makes_no_jump():
    """500 ppm over 512 drains a second apart: each piece needs a drift,
    and the two pieces' lines meet within the band at the second's first
    kernel, so the split is given."""
    n = timeline.PIECE_DRAINS
    rows = drains(2 * n)
    evs = device_for(rows, drift=500e-6)
    f = timeline.fit(rows, *kernels_and_copies(evs))
    assert f["ok"] and len(f["pieces"]) == 2 and f["drift_pieces"] == 2
    assert f["jumps"] == []
    out = timeline.analyse(ring(rows), device(evs), (0, 0),
                           (int(700e9), int(700e9)), quiet)
    assert out["idle_pct"] is not None
    assert sum(out["idle_pct"].values()) == pytest.approx(100.0)


def test_a_step_the_bands_allow_is_no_jump():
    """The device clock steps 60 ms after the first piece: the pieces'
    bands (80 ms wide) still meet, so no step of the correction is
    forced there, though the offsets chosen in them (0 at the anchor,
    the second band's middle) lie 90 ms apart."""
    n = timeline.PIECE_DRAINS
    rows = drains(2 * n)
    evs = device_for(rows[:n]) + device_for(rows[n:], skew=0.06)
    f = timeline.fit(rows, *kernels_and_copies(evs))
    first, second = f["pieces"]
    assert second["offset_s"] - first["offset_s"] > second["band_s"]
    assert f["jumps"] == []


def test_no_fit_gives_no_attribution():
    rows = drains(20)
    evs = device_for(rows)
    # drain 10's kernel placed before its pack_done by more than every
    # other drain's copy-out slack allows
    k, d = kernels_and_copies(evs)
    k[10] = (k[10][0] - 0.5, k[10][1])
    k[11] = (k[11][0] + 0.5, k[11][1])
    d[22] = (d[22][0] + 0.5, d[22][1] + 0.5)
    f = timeline.fit(rows, k, d)
    assert not f["ok"] and "no offset fits" in f["why"]
    assert not timeline.fit(rows[:-1], k, d)["ok"]
    ev2 = [(s, e, n) for s, e, n in evs]
    ev2[10 * 4 + 1] = (ev2[10 * 4 + 1][0] - 0.5, ev2[10 * 4 + 1][1],
                       ev2[10 * 4 + 1][2])
    ev2[11 * 4 + 1] = (ev2[11 * 4 + 1][0] + 0.5, ev2[11 * 4 + 1][1] + 0.5,
                       ev2[11 * 4 + 1][2])
    ev2[11 * 4 + 2] = (ev2[11 * 4 + 2][0] + 0.5, ev2[11 * 4 + 2][1] + 0.5,
                       ev2[11 * 4 + 2][2])
    out = timeline.analyse(ring(rows), device(ev2), (0, 0),
                           (int(200e9), int(200e9)), quiet)
    assert out["fit"]["ok"] is False and out["idle_pct"] is None


def test_analyse_splits_the_idle_time():
    rows = drains(10)
    holds = np.zeros(2, HOLD_DTYPE)
    holds["start"], holds["end"] = [100.6, 101.62], [101.0, 101.9]
    holds["reason"] = [1, 2]
    out = timeline.analyse(ring(rows, holds), device(device_for(rows)),
                           (int(100e9), int(100e9)),
                           (int(110e9), int(110e9)), quiet)
    assert out["fit"]["ok"] and out["fit"]["anchor_in_band"]
    pct = out["idle_pct"]
    assert set(pct) == set(HOST_STATES)
    assert sum(pct.values()) == pytest.approx(100.0)
    assert out["unknown_s"] == pytest.approx(0.0, abs=1e-9)
    # each drain's device work is busy 0.133 s; fill 0.1-0.35 less the
    # copy in and the kernel's start (0.207 s), engine_queue 0-0.1,
    # answer 0.35-0.6 less the kernel's end and the copies out (0.16 s);
    # the rest of each second no work, but for the holds: gate 0.6-1.0
    # after the first drain, depth 0.62-0.9 after the second
    assert out["idle_s"] == pytest.approx(10 - 10 * 0.133)
    s = out["idle_state_s"]
    assert s["fill"] == pytest.approx(10 * 0.207)
    assert s["engine_queue"] == pytest.approx(10 * 0.1)
    assert s["gate"] == pytest.approx(0.4)
    assert s["depth"] == pytest.approx(0.28)
    assert s["answer"] == pytest.approx(10 * 0.16)
    assert len(out["gaps"]) == 10
    assert out["rows"] == out["launched"] == 10 and out["decisions"] == 1000


def test_anchor_maps_a_profiler_event_onto_the_pipeline_clock():
    """A region under record_function, stamped on time.monotonic() as the
    pipeline stamps its drains, lands within 1 ms of the profiler's own
    event once the anchor maps the trace."""
    import torch  # noqa: F401
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with record_function("warm"):
        pass
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    a0 = timeline.anchor()
    with record_function("timeline_region"):
        t_in = time.monotonic()
        time.sleep(0.02)
        t_out = time.monotonic()
    prof.__exit__(None, None, None)
    dev = dict(start_ns=int(prof.profiler.kineto_results.trace_start_ns()),
               events=[(e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CPU])
    s, e, names = timeline.to_host(dev, a0)
    i = names.index("timeline_region")
    assert abs(s[i] - t_in) < 1e-3 and abs(e[i] - t_out) < 1e-3


def test_a_program_without_the_timeline_reads_none():
    assert timeline.ring_marks(object()) is None
    assert timeline.ring_rows(object(), None) is None
    assert timeline.analyse(None, None, (0, 0), (1, 1), quiet) is None
    assert timeline.fit_summary(None) is None


def test_cpu_run_reads_the_host_figures_and_agrees_with_the_outside():
    """A run of a small cell on the CPU through the tool: the router's
    clocks and the fill's CPU share are there and the idle split is not
    (no device trace); the parse and encode timed inside the program make
    up most of the outside timing and never exceed it; the window's
    launched rows equal the drains counted and their decisions the
    decisions staged; the harness's functions are restored after."""
    before = (harness.pipeline_counters, harness.read_trace)
    cell = small("mixed-10m.sat")
    drive = manifest.piece("drivers", cell.traffic["driver"],
                           cell.root).drive
    out = timeline.traced_run(cell, 2 ** 31 + 23, 1.0, device="cpu",
                              log=quiet)
    assert (harness.pipeline_counters, harness.read_trace) == before
    assert manifest.piece("drivers", cell.traffic["driver"],
                          cell.root).drive is drive
    assert out["correct"]
    assert out["idle_pct"] is None and out["why"] == "no trace"
    # the inside walls nest in the outside ones; what lies between (the
    # outside wrapper's frame and clock reads, ~1 us a call) weighs 3-5%
    # of a 100-item RPC's ~30 us parse here, ~0.2% of the card host's
    assert 0.85 <= out["inside_over_outside"] <= 1.0
    assert out["parse_c_us_per_kdec"] > 0 and out["encode_c_us_per_kdec"] > 0
    assert 0 < out["fill_cpu_pct"] <= 100.0
    assert out["launched"] == out["drains_counted"] > 0
    assert out["ring_decisions"] == out["decisions_staged"]


def test_recorder_cost_probe_measures_every_cost():
    from portbench import recorder_cost
    out = recorder_cost.measure(2)
    assert set(out) == {"row_ns", "hold_ns", "call_ns", "drain_fixed_ns",
                        "timed_call_ns"}
    assert all(v > 0 for k, v in out.items() if k != "timed_call_ns")
