"""Mesh serving on the CPU: two ranks of a gloo group, each holding four of
eight shards, against the JAX package's engine on the 8-device CPU mesh.

Each rank is a process of its own (tests/torch_mesh_rank.py, a time limit
each) that joins the group through parallel/distributed.py
initialize_from_env and plays one scenario: GLOBAL keys registered on every
rank at one `now`; ticks, each rank stepping its own window (engine.step,
or step_stacked at a stack of 2) at the tick's `now`, the two windows
together holding all five algorithms, duplicate runs, keys on both ranks'
shards and GLOBAL lanes (a GLOBAL key only rank 0 hits, one only rank 1
hits, one both hit, a hits = 0 read); a tick on which rank 1 is idle while
rank 0 carries GLOBAL lanes; a two-phase registration (phase 1 on both
ranks, the key refused until phase 2).  The reference is
`gubernator_tpu.core.engine.RateLimitEngine.step` (and `step_stacked`) on
make_mesh() - one process over all eight shards, whose
`kernel.global_combined` applies the psum'd hits - fed the union of the
two ranks' windows at the same `now`.  Equal bit for bit: every response;
each rank's regular planes against the JAX engine's planes of its shards;
both ranks' GLOBAL replicas (gstate) and configs (gcfg) against each other
and the JAX engine's.  Then each rank round-trips a snapshot through its
own file (arena-r<offset>.snap) with a key pending registration, serves
through a lockstep WindowBatcher, and the two stop at the tick rank 0
proposes (Mesh.propose_stop), with their GLOBAL replicas equal after it.
While they serve, the tick loop's snapshot hook saves each rank's file at
one tick both share and at a tick of each rank's own; restore_mesh_engine
restores the shared tick's files on both ranks, with equal GLOBAL
replicas, and the files of different ticks, or a set missing one rank's
file, on neither rank.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)

from gubernator_tpu import compat
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu_torch import native
from gubernator_tpu_torch.core.engine import shard_of

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
RANK_SCRIPT = REPO / "tests" / "torch_mesh_rank.py"
T0 = 1_754_000_000_000
WORLD, LOCAL = 2, 4
S = WORLD * LOCAL
GEOM = dict(C=64, B=16, G=32, Bg=4, Kg=8)
FIELDS = ("limit", "duration", "remaining", "tstamp", "expire", "algo")
GLOBAL, BATCHING = 2, 0
CHILD_TIMEOUT_S = 240


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _clear_jax_executable_caches():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


@pytest.fixture
def jax_engine(monkeypatch):
    """make(native) -> the JAX engine on make_mesh() at GEOM, with
    shard_map's replication check off (tests/test_torch_engine.py)."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    _clear_jax_executable_caches()

    def make(use_native):
        g = GEOM
        return jengine.RateLimitEngine(
            mesh=make_mesh(), capacity_per_shard=g["C"],
            batch_per_shard=g["B"], global_capacity=g["G"],
            global_batch_per_shard=g["Bg"], max_global_updates=g["Kg"],
            use_native="on" if use_native else False, skip_global=False)
    yield make
    _clear_jax_executable_caches()


def _rank_keys(rng, n):
    """n regular keys of each rank's shards: keys[rank] = [unique_key]."""
    keys = [[], []]
    i = 0
    while min(len(k) for k in keys) < n:
        uk = f"k{i}"
        owner = shard_of(f"mesh_{uk}", S) // LOCAL
        if len(keys[owner]) < n:
            keys[owner].append(uk)
        i += 1
    return keys


def _regular(rng, uk):
    algo = int(rng.integers(0, 5))
    hits = int(rng.integers(0, 4))
    if algo == 4 and rng.random() < 0.2:
        hits = -1  # a CONCURRENCY release
    return ["mesh", uk, hits, int(rng.integers(5, 13)),
            int(rng.choice([60_000, 400])), algo, BATCHING]


def _global(key, hits, limit, algo):
    return ["mg", key, hits, limit, 60_000, algo, GLOBAL]


# GLOBAL keys: (unique_key, limit, algorithm); g0 only rank 0 hits, g2 only
# rank 1, g1 both, g3 rank 1 reads with hits = 0, g4 registers mid-run
GKEYS = {"g0": (100, 0), "g1": (50, 1), "g2": (80, 0), "g3": (40, 1),
         "g4": (60, 0)}


def _spec(uk):
    limit, algo = GKEYS[uk]
    return [f"mg_{uk}", limit, 60_000, algo]


def _window(rng, keys, rank, tick, idle=False, g4=False):
    if idle:
        return []
    w = [_regular(rng, keys[rank][int(rng.integers(0, len(keys[rank])))])
         for _ in range(int(rng.integers(5, 10)))]
    mine = ["g0", "g1"] if rank == 0 else ["g1", "g2"]
    for uk in mine:
        limit, algo = GKEYS[uk]
        w.append(_global(uk, int(rng.integers(1, 4)), limit, algo))
    if rank == 1 and tick % 2:
        w.append(_global("g3", 0, *GKEYS["g3"]))
    if g4 and rank == 0:
        w.append(_global("g4", 2, *GKEYS["g4"]))
    rng.shuffle(w)
    return w


def scenario(seed, stack, use_native, ticks=6):
    rng = np.random.default_rng(seed)
    keys = _rank_keys(rng, 6)
    steps = [dict(op="register", now=T0,
                  specs=[_spec(k) for k in ("g0", "g1", "g2", "g3")])]
    for t in range(ticks):
        now = T0 + 50 * t
        if t == 3:
            steps.append(dict(op="register", now=now, pending=True,
                              specs=[_spec("g4")]))
            steps.append(dict(op="refused",
                              req=[_global("g4", 1, *GKEYS["g4"])] * 2))
            steps.append(dict(op="activate", keys=["mg_g4"]))
        idle = t == 2
        windows = [[_window(rng, keys, r, t, idle=idle and r == 1,
                            g4=t > 3) for _ in range(stack)]
                   for r in range(WORLD)]
        steps.append(dict(op="tick", now=now, windows=windows))
    return dict(
        geometry=GEOM, local_shards=LOCAL, native=use_native, stack=stack,
        steps=steps, snapshot_now=T0 + 50 * ticks,
        pending_at_snapshot=[["mg_g5", 30, 60_000, 0]],
        serve=dict(interval=0.02, reqs=[
            [_global("g0", 1, *GKEYS["g0"]) for _ in range(3)]
            + [_regular(rng, keys[0][0]), _regular(rng, keys[0][1])],
            [_global("g2", 2, *GKEYS["g2"]), _regular(rng, keys[1][0])]]))


def run_ranks(sc, tmp_path, env_extra=None):
    """Both ranks' outputs (npz dicts), each process under its own time
    limit; env_extra: more environment for the ranks."""
    path = tmp_path / "scenario.json"
    path.write_text(json.dumps(sc))
    port = _free_port()
    procs, outs = [], []
    for rank in range(WORLD):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("GUBER_")}
        env.update(GUBER_MESH_COORDINATOR=f"127.0.0.1:{port}",
                   GUBER_MESH_NUM_PROCESSES=str(WORLD),
                   GUBER_MESH_PROCESS_ID=str(rank), **(env_extra or {}))
        out = tmp_path / f"rank{rank}.npz"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(RANK_SCRIPT), str(path), str(rank),
             str(out)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
            log += "\n<TIMEOUT>"
        logs.append(log)
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"rank {rank}: OK" in log, \
            f"rank {rank} failed:\n{log[-6000:]}"
    return [dict(np.load(o)) for o in outs]


def _jreq(r):
    name, key, hits, limit, duration, algo, behavior = r
    return JReq(name=name, unique_key=key, hits=hits, limit=limit,
                duration=duration, algorithm=algo, behavior=behavior)


def _rows(resps):
    return np.asarray([[r.status, r.limit, r.remaining, r.reset_time]
                       for r in resps], np.int64).reshape(-1, 4)


def reference(sc, ref):
    """The JAX engine's responses per tick window, each split by rank."""
    got = []
    for step in sc["steps"]:
        op = step["op"]
        if op == "register":
            ref.register_global_keys([tuple(s) for s in step["specs"]],
                                     now=step["now"],
                                     pending=step.get("pending", False))
        elif op == "activate":
            ref.activate_global_keys(step["keys"])
        elif op == "tick":
            w0, w1 = step["windows"]
            union = [[_jreq(r) for r in a + b] for a, b in zip(w0, w1)]
            if sc["stack"] > 1:
                resps = ref.step_stacked(union, step["now"],
                                         k_stack=sc["stack"])
            else:
                resps = [ref.step(union[0], step["now"])]
            got.append([(_rows(rs[:len(a)]), _rows(rs[len(a):]))
                        for rs, a in zip(resps, w0)])
    return got


@pytest.mark.parametrize("use_native,stack,per_op", [
    (False, 1, False),
    pytest.param(True, 2, False, marks=pytest.mark.skipif(
        not native.available(), reason="native router unavailable")),
    (False, 2, True),
], ids=["python-tables-step", "router-step-stacked", "per-op-step-stacked"])
def test_two_ranks_equal_the_jax_engine_on_the_8_device_mesh(
        jax_engine, tmp_path, use_native, stack, per_op):
    """per_op: the ranks run the per-op lowering (GUBER_PALLAS=1: their
    GLOBAL window is global_stage, the torch reads, the all-reduce and
    global_apply_rows); the reference stays the JAX default engine, whose
    answers both lowerings equal."""
    sc = scenario(5 + stack + per_op, stack, use_native)
    sc["serve"]["snapshots"] = dict(dir=str(tmp_path / "ticks"),
                                    agreed_tick=3, skewed_ticks=[2, 4])
    ranks = run_ranks(sc, tmp_path,
                      dict(GUBER_PALLAS="1") if per_op else None)
    assert [int(r["per_op"]) for r in ranks] == [int(per_op)] * WORLD
    ref = jax_engine(use_native)
    want = reference(sc, ref)
    for t, windows in enumerate(want):
        for k, by_rank in enumerate(windows):
            for rank in range(WORLD):
                np.testing.assert_array_equal(
                    ranks[rank][f"tick{t}_w{k}"], by_rank[rank],
                    err_msg=f"tick {t} window {k} rank {rank} responses")
    for f in FIELDS:
        jplane = np.asarray(getattr(ref.state, f))
        for rank in range(WORLD):
            np.testing.assert_array_equal(
                ranks[rank][f"plane.{f}"],
                jplane[rank * LOCAL:(rank + 1) * LOCAL],
                err_msg=f"rank {rank} regular plane {f}")
            np.testing.assert_array_equal(
                ranks[rank][f"plane.gstate.{f}"],
                np.asarray(getattr(ref.gstate, f)),
                err_msg=f"rank {rank} GLOBAL replica {f}")
    for f in ("limit", "duration", "algo"):
        for rank in range(WORLD):
            np.testing.assert_array_equal(
                ranks[rank][f"plane.gcfg.{f}"],
                np.asarray(getattr(ref.gcfg, f)),
                err_msg=f"rank {rank} GLOBAL config {f}")
    # a slot only one rank's lanes hit moved on both: g0's and g2's rows
    # hold hits from one rank each (the JAX replica above has them too)
    g0 = ref.gtable.lookup("mg_g0", T0, 60_000)[0]
    g2 = ref.gtable.lookup("mg_g2", T0, 60_000)[0]
    for rank in range(WORLD):
        rem = ranks[rank]["plane.gstate.remaining"]
        assert rem[g0] < GKEYS["g0"][0] and rem[g2] < GKEYS["g2"][0]
    # the same collective sequence on both ranks: an all-reduce a window
    n_windows = stack * sum(1 for s in sc["steps"] if s["op"] == "tick")
    assert [int(r["reductions"]) for r in ranks] == [n_windows] * WORLD
    # the per-rank snapshot files, pending key included (checked inside)
    assert [str(r["snapshot_name"]) for r in ranks] == [
        "arena-r0.snap", f"arena-r{LOCAL}.snap"]
    assert all(int(r["snapshot_ok"]) for r in ranks)
    # lockstep serving ended on both ranks at the tick rank 0 proposed
    stops = [int(r["serve_stop_tick"]) for r in ranks]
    assert stops[0] == stops[1] > 0
    assert [int(r["serve_ticks"]) for r in ranks] == stops
    assert [int(r["serve_pipeline"]) for r in ranks] == [int(use_native)] * 2
    for f in FIELDS:
        np.testing.assert_array_equal(ranks[0][f"after_serve.gstate.{f}"],
                                      ranks[1][f"after_serve.gstate.{f}"])
    # the tick snapshots: one agreed tick's files restore on both ranks,
    # stamped with that tick's time, with equal GLOBAL replicas; files of
    # different ticks, or a set missing rank 1's, restore on neither
    assert [int(r["restored_agreed"]) for r in ranks] == [1, 1]
    assert (int(ranks[0]["restored_agreed_now"])
            == int(ranks[1]["restored_agreed_now"])
            == int(ranks[0]["agreed_tick_now"]))
    for name in ranks[0]:
        if name.startswith("restored.g"):
            np.testing.assert_array_equal(ranks[0][name], ranks[1][name])
    for kind in ("skewed", "missing"):
        assert [int(r[f"restored_{kind}"]) for r in ranks] == [0, 0], kind
        assert [int(r[f"cold_{kind}"]) for r in ranks] == [1, 1], kind


def test_an_idle_rank_keeps_the_collective_sequence():
    """Rank 1 never stages a lane while rank 0 carries GLOBAL lanes every
    window: both ranks all-reduce every window, finish, and hold equal
    GLOBAL replicas with every one of rank 0's hits applied once."""
    import tempfile
    ticks = 5
    steps = [dict(op="register", now=T0, specs=[_spec("g0"), _spec("g1")])]
    for t in range(ticks):
        steps.append(dict(op="tick", now=T0 + 10 * t, windows=[
            [[_global("g0", 2, *GKEYS["g0"]), _global("g1", 1,
                                                      *GKEYS["g1"])]],
            [[]]]))
    sc = dict(geometry=GEOM, local_shards=LOCAL, native=False, stack=1,
              steps=steps)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(sc, Path(tmp))
    assert [int(r["reductions"]) for r in ranks] == [ticks, ticks]
    for f in FIELDS:
        np.testing.assert_array_equal(ranks[0][f"plane.gstate.{f}"],
                                      ranks[1][f"plane.gstate.{f}"])
    # g0 is slot 0 (registered first): 100 - 2 a tick; each tick's read
    # sees the replica before that tick's apply (the first, a fresh row,
    # as if initialized with its hits)
    assert int(ranks[0]["plane.gstate.remaining"][0]) == 100 - 2 * ticks
    reads = [int(ranks[0][f"tick{t}_w0"][0, 2]) for t in range(ticks)]
    assert reads == [100 - 2 * max(t, 1) for t in range(ticks)]
