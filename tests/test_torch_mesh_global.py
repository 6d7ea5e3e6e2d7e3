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
global_combined), or jax_window_ups with _apply_control where the control
carries upsert lanes.  Held equal bit for bit: each rank's read block (its
lanes' rows of the reference's, pads 0), each rank's replica and config,
and each scratch back at all zero.  Checked on the plain versions and on
the CUDA sources' device code built for the host (tests/
test_torch_drain_host.py's shim).  global_stage_read has no barrier
across CTAs, so its items (upsert lanes, phase A's stage items, read
lanes) run in any order: forward (upserts, stage, reads: the order a
barrier would give), backward, every read before every stage and upsert
item, and two seeded permutations, each with the CTAs' row tables cut at
1, 3 and 8 lanes a CTA; and its CTA body as the kernel runs it, a thread
a CTA, the CTAs forward and backward.  global_apply_rows' kernel runs
both its instances: the scan over 1, 3 and 7 one-thread CTAs (its
stride), and the one-turn launch over a thread a row and a few more,
forward and backward, on a scratch 16-byte aligned and not (the scalar
head), at G = 1, 3, 16 and 4097 (the scalar tail).  The edge windows
include a slot only the other rank's lanes hit, which the single-card
apply (a thread per own lane) would never visit, reads on rows the window
upserts, resets and config-writes at once, on row G - 1 through a slot
past G, and resets and upserts that come last in their column, behind
pads.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gubernator_tpu  # noqa: F401  (enables x64)
from gubernator_tpu.ops import kernel as jk

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
from .test_torch_global_window import (
    arena,
    jax_window,
    jax_window_ups,
    random_control,
    random_upserts,
)

pytestmark = pytest.mark.torch_port

T0 = 1_754_000_000_000

_MESH_ENTRY = _PHASES + r"""
// global_stage_read's items one at a time in the given order: code
// [0, ku) upsert lane, [ku, ku + kg + n) phase A's stage item, then read
// lane; each CTA (`lanes` items a CTA) with its row table built first, as
// the kernel's CTAs build theirs before their items run
extern "C" void host_stage_read_items(HOST_ARENA_ARGS, long long ku, long long now,
                                      int64_t* read, long long lanes, const int64_t* order,
                                      long long n_order) {
  HOST_ARENA_KU;
  if (lanes < 1 || lanes > 8) return;
  long long items = n > ku ? n : ku;
  if (items < 1) items = 1;
  std::vector<RowTable<8>> tabs(static_cast<size_t>((items + lanes - 1) / lanes));
  const bool writes = window_writes(c, G, 0, 1);
  for (size_t b = 0; b < tabs.size(); ++b) {
    table_clear(tabs[b], 0, 1);
    if (!writes) continue;
    for (long long i = b * lanes; i < (long long)(b + 1) * lanes && i < items; ++i)
      table_insert_item(tabs[b], c, G, i);
    table_mark(tabs[b], c, G, 0, 1);
  }
  const long long stage = stage_items(c);
  for (long long k = 0; k < n_order; ++k) {
    const long long code = order[k];
    if (code < ku) {
      if (writes) upsert_item_table(a, cfg, c, tabs[code / lanes], code);
    } else if (code < ku + stage) {
      stage_item(a, cfg, c, sums, code - ku);
    } else {
      const long long i = code - ku - stage;
      ReadLane l = read_request(c, G, i);
      read_row(a, c, writes ? &tabs[i / lanes] : nullptr, l);
      read_answer(now, read, l);
    }
  }
}
// the kernel's CTA body, a thread a CTA, the CTAs forward or backward
extern "C" void host_stage_read_ctas(HOST_ARENA_ARGS, long long ku, long long now,
                                     int64_t* read, int backward) {
  HOST_ARENA_KU;
  long long items = n > ku ? n : ku;
  if (items < 1) items = 1;
  gridDim.x = static_cast<unsigned>(items);
  for (long long k = 0; k < items; ++k) {
    blockIdx.x = static_cast<unsigned>(backward ? items - 1 - k : k);
    RowTable<1> table;
    stage_read_cta<1>(a, cfg, c, sums, now, read, table);
  }
}
"""

_ROWS_ENTRY = r"""
// global_apply_rows' kernel, the scan (scan != 0) or the one-turn
// instance (which needs a thread a row: ctas >= G), over `ctas` one-thread
// CTAs (its stride), forward or backward (no row depends on another)
extern "C" void host_global_apply_rows(int64_t* limit, int64_t* duration, int64_t* remaining,
                                       int64_t* tstamp, int64_t* expire, int32_t* algo,
                                       int64_t* cfg_limit, int64_t* cfg_duration,
                                       int32_t* cfg_algo, long long G, int64_t* sums,
                                       long long now, int ctas, int backward, int scan) {
  const GArena a{limit, duration, remaining, tstamp, expire, algo, G};
  const GConfig cfg{cfg_limit, cfg_duration, cfg_algo};
  gridDim.x = static_cast<unsigned>(ctas);
  for (int k = 0; k < ctas; ++k) {
    blockIdx.x = static_cast<unsigned>(backward ? ctas - 1 - k : k);
    if (scan) {
      global_apply_rows_kernel<true>(a, cfg, sums, now);
    } else {
      global_apply_rows_kernel<false>(a, cfg, sums, now);
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_mesh(tmp_path_factory):
    """global_window.cu's stage-read device code and global_apply.cu's
    apply-rows kernel, behind the shim, in one host library each."""
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


def _plain_rank(state, cfg, gbatch, gacc, upd, now, ups=None):
    """One rank's stage-read through the plain version on CPU tensors:
    (gstate, gcfg, scratch, read) after it."""
    planes, cfgs = _numpy(state, cfg)
    gs = tk.BucketState(*[torch.from_numpy(p) for p in planes])
    gc = tk.GlobalConfig(*[torch.from_numpy(c) for c in cfgs])
    scratch = torch.zeros(planes[0].shape[0], dtype=torch.int64)
    read = gk.global_stage_read(
        gs, gc, gk.make_control(gbatch, gacc, upd, "cpu", ups), scratch, now)
    return gs, gc, scratch, read.numpy()


# the item orders of global_stage_read's device code
ORDERS = ("forward", "backward", "reads_first", "perm0", "perm1")


def _order(kind, ctl):
    """The item codes of host_stage_read_items in order `kind`."""
    n_items = ctl.ku + ctl.kg + 2 * ctl.n
    codes = np.arange(n_items, dtype=np.int64)
    if kind == "backward":
        return codes[::-1].copy()
    if kind == "reads_first":
        cut = ctl.ku + ctl.kg + ctl.n
        return np.concatenate([codes[cut:], codes[:cut]])
    if kind.startswith("perm"):
        return np.random.default_rng(1700 + int(kind[4:])).permutation(codes)
    return codes


def _host_rank(libs, state, cfg, gbatch, gacc, upd, now, ups, mode):
    """One rank's stage-read through the device code on the host, `mode`
    ("items", order kind, lanes a CTA) or ("ctas", backward): (planes,
    cfgs, scratch, read) numpy, written in place."""
    planes, cfgs = _numpy(state, cfg)
    ctl = gk.make_control(gbatch, gacc, upd, "cpu", ups)
    block = np.ascontiguousarray(ctl.block.numpy())
    sums = np.zeros(planes[0].shape[0], np.int64)
    read = np.full((ctl.n, 4), -7, np.int64)
    args = (*[_ptr(p) for p in planes], *[_ptr(c) for c in cfgs],
            ctypes.c_longlong(sums.shape[0]), _ptr(block),
            ctypes.c_longlong(ctl.n), ctypes.c_longlong(ctl.kg), _ptr(sums),
            ctypes.c_longlong(ctl.ku), ctypes.c_longlong(now), _ptr(read))
    if mode[0] == "items":
        order = _order(mode[1], ctl)
        libs[0].host_stage_read_items(*args, ctypes.c_longlong(mode[2]),
                                      _ptr(order),
                                      ctypes.c_longlong(order.size))
    else:
        libs[0].host_stage_read_ctas(*args, ctypes.c_int(mode[1]))
    return planes, cfgs, sums, read


# the apply's launches on the host: (scan, CTAs) with the CTAs given, or
# one turn (None: a thread a row and 3 more)
APPLY_LAUNCHES = ((True, 1), (True, 3), (True, 7), (False, None))


def _host_apply_rows(libs, planes, cfgs, sums, now, launch, backward):
    scan, ctas = launch
    G = sums.shape[0]
    libs[1].host_global_apply_rows(
        *[_ptr(p) for p in planes], *[_ptr(c) for c in cfgs],
        ctypes.c_longlong(G), _ptr(sums), ctypes.c_longlong(now),
        ctypes.c_int(G + 3 if ctas is None else ctas), ctypes.c_int(backward),
        ctypes.c_int(scan))


# every way the host runs global_stage_read's device code
MODES = ([("items", o, lanes) for o in ORDERS for lanes in (1, 3, 8)]
         + [("ctas", 0), ("ctas", 1)])


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


def _ups(G, entries, ku=6):
    """numpy upsert lanes of [ku]: pads (pslot G) but for entries (pslot,
    limit, duration, remaining, tstamp, expire, algo)."""
    cols = [np.full(ku, G, np.int32)] + [np.zeros(ku, np.int64)
                                         for _ in range(5)]
    cols.append(np.zeros(ku, np.int32))
    for i, e in enumerate(entries):
        for col, v in zip(cols, e):
            col[i] = v
    return tuple(cols)


def _upsert_window(kind, now):
    """(state, cfg, (gbatch, gacc, upd, ups)) of one GLOBAL edge window
    whose control carries upsert lanes."""
    G, S, Bg, Kg = 16, 4, 4, 6
    if kind.startswith("random"):
        rng = np.random.default_rng(1710 + int(kind[6:]))
        G = 64
        state, cfg = arena(rng, G)
        gbatch, gacc, upd = random_control(rng, G, S, Bg, Kg)
        ups = random_upserts(rng, G, 10, upd)
        # lanes of both ranks on upserted rows, on a reset row, past G
        rows = np.where(ups[0] < 0, ups[0] + G, ups[0])
        flat = gbatch.slot.reshape(-1)
        flat[[0, 1, 8, 9]] = rows[:4]
        flat[[2, 10]] = np.where(upd[4][0] < 0, upd[4][0] + G, upd[4][0])
        flat[11] = G + 2
        return state, cfg, (gbatch, gacc, upd, ups)
    state, cfg = _live_arena(G, now)
    lane = lambda s_, ln, slot, hits, acc=None, algo=0, init=False: (  # noqa: E731
        s_, ln, slot, hits, hits if acc is None else acc, 10, 60_000,
        algo, init)
    pads = [(G + 3, 1, 1, 1, 1, 1, 1), (-G - 1, 2, 2, 2, 2, 2, 1)]
    if kind == "read_upserted":
        # row 4 upserted live and leaky: a leaky read sees the broadcast's
        # remaining, a token one switches algorithm (fresh); row 13 (by
        # index -3) upserted already expired, read by rank 1 only, hit by
        # both; row 7 not upserted
        ups = _ups(G, [(4, 30, 9_000, 17, now - 100, now + 5_000, 1),
                       (-3, 8, 2_000, 1, now - 10, now - 1, 0)] + pads)
        lanes = [lane(0, 0, 4, 2, algo=1), lane(2, 1, 4, 1),
                 lane(3, 0, 13, 3), lane(1, 1, 13, 0, acc=1),
                 lane(0, 2, 7, 1), lane(2, 3, 4, 0, algo=1)]
        upd = _edge_upd(G, Kg)
    elif kind == "read_reset":
        # rows 3 and 5 (by index -11) reset; row 9 upserted, so the window
        # builds its tables; reads on all three from both ranks
        ups = _ups(G, [(9, 12, 4_000, 6, now - 50, now + 100, 0)] + pads)
        lanes = [lane(0, 0, 3, 2), lane(2, 0, 3, 1), lane(1, 3, 5, 1),
                 lane(3, 3, 5, 0, acc=0), lane(0, 1, 9, 1),
                 lane(3, 1, 9, 2)]
        upd = _edge_upd(G, Kg, resets=[3, -G + 5])
    elif kind == "upsert_reset_config":
        # row 6 upserted, config-written (switching leaky) and reset (by
        # index -10): the reads see the upsert's remaining, tstamp and
        # algo with expire 0, and the config lane's fields stay; row 2
        # upserted and config-written only, row 11 upserted and reset only
        ups = _ups(G, [(6, 40, 7_000, 25, now - 300, now + 9_000, 0),
                       (2, 15, 3_000, 2, now - 20, now + 800, 1),
                       (11, 9, 1_000, 0, now - 5, now + 50, 0)] + pads)
        lanes = [lane(0, 0, 6, 3), lane(2, 0, 6, 1, algo=1),
                 lane(1, 2, 6, 0, init=True), lane(3, 2, 2, 2, algo=1),
                 lane(0, 3, 2, 1), lane(2, 2, 11, 4), lane(3, 3, 11, 1)]
        upd = _edge_upd(G, Kg, [(6, 50, 20_000, 1), (-G + 2, 5, 5_000, 0)],
                        [-10, 11])
    elif kind == "last_row_wrap":
        # lanes past G read row G - 1 while rslot -1 resets it; row 0
        # upserted, so the window builds its tables
        ups = _ups(G, [(0, 7, 7_000, 3, now - 1, now + 10, 0)] + pads)
        lanes = [lane(0, 0, G + 3, 2), lane(2, 1, G, 1),
                 lane(3, 0, G - 1, 1), lane(1, 0, 0, 1)]
        upd = _edge_upd(G, Kg, resets=[-1])
    elif kind == "late_reset":
        # pads lead the reset column and no upsert lane is live: row 5's
        # reset is its column's last, so a vote that stopped early would
        # read row 5's stale expire
        ups = _ups(G, pads)
        lanes = [lane(0, 0, 5, 2), lane(2, 1, 5, 1), lane(0, 3, 12, 1)]
        upd = _edge_upd(G, Kg, resets=[G, -G - 2, G + 9, 5])
    elif kind == "late_upsert":
        # pads lead the upsert column and no reset is live: row 9's upsert
        # is its column's last
        ups = _ups(G, pads + [(9, 14, 5_000, 3, now - 30, now + 400, 1)])
        lanes = [lane(1, 1, 9, 1, algo=1), lane(3, 0, 9, 2, algo=1),
                 lane(0, 3, 12, 1)]
        upd = _edge_upd(G, Kg, [(4, 11, 7_000, 0)])
    else:  # last_row_upsert: row G - 1 upserted by index -1, reset and
        # config-written by G - 1, read through slots past G
        ups = _ups(G, [(-1, 22, 11_000, 19, now - 40, now + 700, 1)] + pads)
        lanes = [lane(0, 0, G + 9, 2, algo=1), lane(2, 0, G - 1, 1),
                 lane(3, 2, G + 1, 0, acc=3, algo=1)]
        upd = _edge_upd(G, Kg, [(G - 1, 33, 6_000, 1)], [G - 1])
    gbatch, gacc = _edge_lanes(G, S, Bg, lanes)
    return state, cfg, (gbatch, gacc, upd, ups)


UPSERT_WINDOWS = ("read_upserted", "read_reset", "upsert_reset_config",
                  "last_row_wrap", "last_row_upsert", "late_reset",
                  "late_upsert", "random0", "random1")


def _assert_rank(tag, read, planes, cfgs, sums, want, r):
    w_state, w_cfg, w_read = want
    n = w_read.shape[0] // 2
    np.testing.assert_array_equal(read, w_read[r * n:(r + 1) * n],
                                  err_msg=f"{tag} read")
    for f, a, b in zip(tk.BucketState._fields, planes, w_state):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=f"{tag} gstate.{f}")
    for f, a, b in zip(tk.GlobalConfig._fields, cfgs, w_cfg):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=f"{tag} gcfg.{f}")
    assert not np.asarray(sums).any(), f"{tag}: the scratch is not back at 0"


def _plain_across(state, cfg, gbatch, gacc, upd, ups, now, want, kind):
    ranks = [_plain_rank(state, cfg, gb, ga, upd, now, ups)
             for gb, ga in _split(gbatch, gacc)]
    summed = sum(r[2] for r in ranks)
    for r, (gs, gc, scratch, read) in enumerate(ranks):
        scratch.copy_(summed)
        gk.global_apply_rows(gs, gc, scratch, now)
        _assert_rank(f"{kind} rank {r}", read, [a.numpy() for a in gs],
                     [a.numpy() for a in gc], scratch.numpy(), want, r)


def _device_across(libs, state, cfg, gbatch, gacc, upd, ups, now, want,
                   kind):
    for k, mode in enumerate(MODES):
        ranks = [_host_rank(libs, state, cfg, gb, ga, upd, now, ups, mode)
                 for gb, ga in _split(gbatch, gacc)]
        summed = sum(r[2] for r in ranks)
        launch = APPLY_LAUNCHES[k % len(APPLY_LAUNCHES)]
        backward = (k // len(APPLY_LAUNCHES)) % 2
        for r, (planes, cfgs, sums, read) in enumerate(ranks):
            sums[:] = summed
            _host_apply_rows(libs, planes, cfgs, sums, now, launch, backward)
            _assert_rank(f"{kind} rank {r} {mode} apply {launch} "
                         f"backward={backward}", read, planes, cfgs, sums,
                         want, r)


@pytest.mark.parametrize("kind", WINDOWS)
def test_plain_halves_across_an_all_reduce_equal_global_combined(kind):
    now = T0 + 77
    state, cfg, (gbatch, gacc, upd) = _window(kind, now)
    want = jax_window(state, cfg, gbatch, gacc, upd, now)
    _plain_across(state, cfg, gbatch, gacc, upd, None, now, want, kind)


@pytest.mark.parametrize("kind", WINDOWS)
def test_device_code_halves_across_an_all_reduce_equal_global_combined(
        host_mesh, kind):
    now = T0 + 77
    state, cfg, (gbatch, gacc, upd) = _window(kind, now)
    want = jax_window(state, cfg, gbatch, gacc, upd, now)
    _device_across(host_mesh, state, cfg, gbatch, gacc, upd, None, now,
                   want, kind)


@pytest.mark.parametrize("kind", UPSERT_WINDOWS)
def test_plain_halves_with_upserts_across_an_all_reduce_equal_jax(kind):
    now = T0 + 91
    state, cfg, (gbatch, gacc, upd, ups) = _upsert_window(kind, now)
    want = jax_window_ups(state, cfg, gbatch, gacc, upd, ups, now)
    _plain_across(state, cfg, gbatch, gacc, upd, ups, now, want, kind)


@pytest.mark.parametrize("kind", UPSERT_WINDOWS)
def test_device_code_with_upserts_in_any_item_order_equals_jax(host_mesh,
                                                               kind):
    """global_stage_read's items with upsert lanes in every order and CTA
    cut, then global_apply_rows, against JAX _apply_control and
    global_combined: a read of an upserted row takes the broadcast's
    planes, of a reset row expire 0, and an upsert leaves the config lane's
    fields and the reset's expire on its row."""
    now = T0 + 91
    state, cfg, (gbatch, gacc, upd, ups) = _upsert_window(kind, now)
    want = jax_window_ups(state, cfg, gbatch, gacc, upd, ups, now)
    _device_across(host_mesh, state, cfg, gbatch, gacc, upd, ups, now, want,
                   kind)


@pytest.mark.parametrize("G", [1, 3, 16, 4097])
def test_device_code_apply_rows_equals_jax_global_apply(host_mesh, G):
    """global_apply_rows' streaming scan against JAX kernel.global_apply
    on an all-reduced scratch with nonzero sums in the first row, the last
    row (the scalar tail at an odd G) and scattered between, a negative
    (CONCURRENCY release) sum and int64 extremes: the scan over 1, 3 and
    7 CTAs and the one-turn launch, forward and backward, on a 16-byte
    aligned scratch and on one that is not (the scalar head): every
    plane, the config untouched, the scratch back at zero."""
    now = T0 + 13
    rng = np.random.default_rng(1720 + G)
    state, cfg = arena(rng, G, algos=range(5))
    summed = np.where(rng.random(G) < 0.3,
                      rng.integers(-5, 40, G), 0).astype(np.int64)
    summed[0] = 3
    summed[G - 1] = -2 if G > 1 else 3
    if G > 8:
        summed[[1, G // 2]] = (np.iinfo(np.int64).max, np.iinfo(np.int64).min)
    js = jk.BucketState(**{k: jnp.asarray(v) for k, v in state.items()})
    jc = jk.GlobalConfig(**{k: jnp.asarray(v) for k, v in cfg.items()})
    want = [np.asarray(a) for a in jk.global_apply(js, jc, jnp.asarray(summed),
                                                   jnp.int64(now))]
    for launch in APPLY_LAUNCHES:
        for backward in (0, 1):
            for head in (0, 1):
                planes, cfgs = _numpy(state, cfg)
                # a buffer 16-byte aligned, the scratch at its start or
                # one row in
                buf = np.zeros(G + 3, np.int64)
                off = (-(buf.ctypes.data // 8)) % 2 + head
                sums = buf[off:off + G]
                assert (sums.ctypes.data % 16 != 0) == bool(head)
                sums[:] = summed
                _host_apply_rows(host_mesh, planes, cfgs, sums, now, launch,
                                 backward)
                tag = f"G={G} {launch} backward={backward} head={head}"
                for f, a, b in zip(tk.BucketState._fields, planes, want):
                    np.testing.assert_array_equal(a, b,
                                                  err_msg=f"{tag} {f}")
                for f, a in zip(tk.GlobalConfig._fields, cfgs):
                    np.testing.assert_array_equal(a, cfg[f],
                                                  err_msg=f"{tag} cfg {f}")
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
