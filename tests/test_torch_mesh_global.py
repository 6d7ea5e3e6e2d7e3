"""The mesh GLOBAL window's two entry points (ops/global_kernel.py
global_stage_read and global_apply_rows; ops/csrc/global_window.cu and
global_apply.cu) against the JAX engine's GLOBAL window, whose
`kernel.global_combined` applies the psum'd sums (gubernator_tpu/core/
engine.py:2665-2703, ops/kernel.py:1334).

A window's lanes are split between two ranks (the shards of one half each),
every rank holding the same replica and the same control writes: each rank
runs global_stage_read on its lanes, the two scratches are summed (the
all-reduce), and each rank runs global_apply_rows on the sum.  The
reference is tests/test_torch_global_window.py's jax_window over all the
lanes (_apply_config, global_accumulate over every shard summed,
global_combined).  Held equal bit for bit: each rank's read block (its
lanes' rows of the reference's, pads 0), each rank's replica and config,
and each scratch back at all zero.  Checked on the plain versions and on
the CUDA sources' device code built for the host (tests/
test_torch_drain_host.py's shim): phase A and B's segments over 1, 5 and
a thread per read lane, forward and backward, and phase C' over the rows
forward and backward.  The edge windows include a slot only the other
rank's lanes hit, which the single-card apply (a thread per own lane)
would never visit.
"""

import ctypes

import numpy as np
import pytest
import torch

import gubernator_tpu  # noqa: F401  (enables x64)

from gubernator_tpu_torch.ops import global_kernel as gk
from gubernator_tpu_torch.ops import kernel as tk

from .test_torch_drain_host import (
    _PHASES,
    _edge_lanes,
    _edge_upd,
    _edge_window,
    _host_build,
    _ptr,
    _live_arena,
    EDGE_WINDOWS,
)
from .test_torch_global_window import jax_window

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000

_MESH_ENTRY = _PHASES + r"""
// global_stage_read's segments as `threads` threads run them (phase A0
// when the control has upsert lanes, then A, the cluster barrier, then B),
// each segment over every thread in turn, forward or backward
extern "C" void host_global_stage_read(HOST_ARENA_ARGS, long long ku, long long now,
                                       int64_t* read, int backward, long long threads) {
  HOST_ARENA_KU;
  std::vector<WindowThread> ts(static_cast<size_t>(threads));
  for (long long t = 0; t < threads; ++t) {
    ts[t].first = t;
    ts[t].stride = threads;
  }
  auto each = [&](auto seg) {
    for (long long k = 0; k < threads; ++k) seg(ts[backward ? threads - 1 - k : k]);
  };
  if (ku > 0) each([&](WindowThread& t) { window_seg_u(a, cfg, c, t); });
  each([&](WindowThread& t) { stage_seg_a(a, cfg, c, sums, t); });
  each([&](WindowThread& t) { stage_seg_b(a, c, now, read, t); });
}
"""

_ROWS_ENTRY = r"""
// global_apply_rows' rows, forward or backward (no row depends on another)
extern "C" void host_global_apply_rows(int64_t* limit, int64_t* duration, int64_t* remaining,
                                       int64_t* tstamp, int64_t* expire, int32_t* algo,
                                       int64_t* cfg_limit, int64_t* cfg_duration,
                                       int32_t* cfg_algo, long long G, int64_t* sums,
                                       long long now, int backward) {
  const GArena a{limit, duration, remaining, tstamp, expire, algo, G};
  const GConfig cfg{cfg_limit, cfg_duration, cfg_algo};
  for (long long k = 0; k < G; ++k) apply_row(a, cfg, sums, now, backward ? G - 1 - k : k);
}
"""


@pytest.fixture(scope="module")
def host_mesh(tmp_path_factory):
    """global_window.cu's stage-read segments and global_apply.cu's apply
    row, behind the shim, in one host library each."""
    return (_host_build(tmp_path_factory, "global_window", _MESH_ENTRY),
            _host_build(tmp_path_factory, "global_apply", _ROWS_ENTRY))


def _split(gbatch, gacc):
    """The window's lanes as two ranks' halves: [S / 2, Bg] each."""
    h = gacc.shape[0] // 2
    return [(tk.WindowBatch(*[a[r * h:(r + 1) * h] for a in gbatch]),
             gacc[r * h:(r + 1) * h]) for r in range(2)]


def _numpy(st, cf):
    return ([np.ascontiguousarray(np.asarray(st[f])).copy()
             for f in tk.BucketState._fields],
            [np.ascontiguousarray(np.asarray(cf[f])).copy()
             for f in tk.GlobalConfig._fields])


def _plain_rank(state, cfg, gbatch, gacc, upd, now):
    """One rank's stage-read through the plain version on CPU tensors:
    (gstate, gcfg, scratch, read) after it."""
    planes, cfgs = _numpy(state, cfg)
    gs = tk.BucketState(*[torch.from_numpy(p) for p in planes])
    gc = tk.GlobalConfig(*[torch.from_numpy(c) for c in cfgs])
    scratch = torch.zeros(planes[0].shape[0], dtype=torch.int64)
    read = gk.global_stage_read(gs, gc, gk.make_control(gbatch, gacc, upd,
                                                        "cpu"), scratch, now)
    return gs, gc, scratch, read.numpy()


def _host_rank(libs, state, cfg, gbatch, gacc, upd, now, backward,
               threads):
    """One rank's stage-read through the device code on the host:
    (planes, cfgs, scratch, read) numpy, written in place."""
    planes, cfgs = _numpy(state, cfg)
    ctl = gk.make_control(gbatch, gacc, upd, "cpu")
    block = np.ascontiguousarray(ctl.block.numpy())
    sums = np.zeros(planes[0].shape[0], np.int64)
    read = np.full((ctl.n, 4), -7, np.int64)
    libs[0].host_global_stage_read(
        *[_ptr(p) for p in planes], *[_ptr(c) for c in cfgs],
        ctypes.c_longlong(sums.shape[0]), _ptr(block),
        ctypes.c_longlong(ctl.n), ctypes.c_longlong(ctl.kg), _ptr(sums),
        ctypes.c_longlong(0), ctypes.c_longlong(now), _ptr(read),
        ctypes.c_int(backward),
        ctypes.c_longlong(ctl.n if threads is None else threads))
    return planes, cfgs, sums, read


def _host_apply_rows(libs, planes, cfgs, sums, now, backward):
    libs[1].host_global_apply_rows(
        *[_ptr(p) for p in planes], *[_ptr(c) for c in cfgs],
        ctypes.c_longlong(sums.shape[0]), _ptr(sums),
        ctypes.c_longlong(now), ctypes.c_int(backward))


def _other_rank_window(now):
    """Rank 0's lanes hit row 2 only, rank 1's rows 11 (expired) and 13
    (expiring at now) only, both row 5;
    rank 1 also reads row 2 with hits 0 (its replica must take rank 0's
    sum), and config writes land on rows both ranks read."""
    G, S, Bg, Kg = 16, 4, 4, 6
    state, cfg = _live_arena(G, now)
    state["expire"][11] = now - 1
    state["expire"][13] = now  # live: a row expires strictly before now
    lane = lambda s_, ln, slot, hits, acc=None: (  # noqa: E731
        s_, ln, slot, hits, hits if acc is None else acc, 10, 60_000, 0,
        False)
    lanes = [lane(0, 0, 2, 3), lane(1, 2, 2, 1), lane(0, 1, 5, 2),
             lane(2, 0, 11, 4), lane(3, 1, 11, 1), lane(2, 2, 5, 1),
             lane(3, 0, 2, 0, acc=0), lane(3, 2, 13, 2)]
    gbatch, gacc = _edge_lanes(G, S, Bg, lanes)
    return state, cfg, (gbatch, gacc, _edge_upd(G, Kg, [(5, 12, 60_000, 0)]))


WINDOWS = EDGE_WINDOWS + ("other_rank",)


def _window(kind, now):
    return (_other_rank_window(now) if kind == "other_rank"
            else _edge_window(kind, now))


@pytest.mark.parametrize("kind", WINDOWS)
def test_plain_halves_across_an_all_reduce_equal_global_combined(kind):
    now = T0 + 77
    state, cfg, (gbatch, gacc, upd) = _window(kind, now)
    w_state, w_cfg, w_read = jax_window(state, cfg, gbatch, gacc, upd, now)
    halves = _split(gbatch, gacc)
    ranks = [_plain_rank(state, cfg, gb, ga, upd, now) for gb, ga in halves]
    summed = sum(r[2] for r in ranks)
    n = w_read.shape[0] // 2
    for r, (gs, gc, scratch, read) in enumerate(ranks):
        scratch.copy_(summed)
        gk.global_apply_rows(gs, gc, scratch, now)
        tag = f"{kind} rank {r}"
        np.testing.assert_array_equal(read, w_read[r * n:(r + 1) * n],
                                      err_msg=f"{tag} read")
        for f, a, b in zip(tk.BucketState._fields, gs, w_state):
            np.testing.assert_array_equal(a.numpy(), b,
                                          err_msg=f"{tag} gstate.{f}")
        for f, a, b in zip(tk.GlobalConfig._fields, gc, w_cfg):
            np.testing.assert_array_equal(a.numpy(), b,
                                          err_msg=f"{tag} gcfg.{f}")
        assert not scratch.any(), f"{tag}: the scratch is not back at 0"


@pytest.mark.parametrize("kind", WINDOWS)
def test_device_code_halves_across_an_all_reduce_equal_global_combined(
        host_mesh, kind):
    now = T0 + 77
    state, cfg, (gbatch, gacc, upd) = _window(kind, now)
    w_state, w_cfg, w_read = jax_window(state, cfg, gbatch, gacc, upd, now)
    halves = _split(gbatch, gacc)
    n = w_read.shape[0] // 2
    for backward in (0, 1):
        for threads in (None, 1, 5):
            ranks = [_host_rank(host_mesh, state, cfg, gb, ga, upd, now,
                                backward, threads) for gb, ga in halves]
            summed = sum(r[2] for r in ranks)
            for r, (planes, cfgs, sums, read) in enumerate(ranks):
                sums[:] = summed
                _host_apply_rows(host_mesh, planes, cfgs, sums, now,
                                 backward)
                tag = f"{kind} rank {r} backward={backward} threads={threads}"
                np.testing.assert_array_equal(read, w_read[r * n:(r + 1) * n],
                                              err_msg=f"{tag} read")
                for f, a, b in zip(tk.BucketState._fields, planes, w_state):
                    np.testing.assert_array_equal(a, b,
                                                  err_msg=f"{tag} gstate.{f}")
                for f, a, b in zip(tk.GlobalConfig._fields, cfgs, w_cfg):
                    np.testing.assert_array_equal(a, b,
                                                  err_msg=f"{tag} gcfg.{f}")
                assert not sums.any(), f"{tag}: the scratch is not back at 0"


def test_wrappers_count_plain_calls_on_cpu_and_check_their_inputs():
    """On CPU tensors the wrappers run their plain versions and count
    them; a scratch of the wrong shape or dtype raises before anything
    runs."""
    now = T0
    state, cfg, (gbatch, gacc, upd) = _edge_window("cancel", now)
    gk.reset_counts()
    gs, gc, scratch, _ = _plain_rank(state, cfg, gbatch, gacc, upd, now)
    gk.global_apply_rows(gs, gc, scratch, now)
    assert gk.plain_calls["global_stage_read"] == 1
    assert gk.plain_calls["global_apply_rows"] == 1
    assert not any(gk.launches.values())
    with pytest.raises(ValueError, match="scratch"):
        gk.global_apply_rows(gs, gc, scratch.to(torch.int32), now)
    with pytest.raises(ValueError, match="gstate.limit: want"):
        gk.global_apply_rows(gs, gc, scratch[:-1], now)
