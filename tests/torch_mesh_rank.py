"""One rank of a two-rank mesh on the CPU, for tests/test_torch_mesh.py.

    python tests/torch_mesh_rank.py SCENARIO.json RANK OUT.npz

Run from the repository root, with GUBER_MESH_COORDINATOR,
GUBER_MESH_NUM_PROCESSES and GUBER_MESH_PROCESS_ID set: the rank joins
the gloo group through parallel/distributed.py initialize_from_env (on
the CPU), builds a mesh RateLimitEngine of the scenario's geometry and
plays the scenario's steps in order, every rank the same steps at the same
`now` with its own windows: `register` (register_global_keys, phase 1 when
pending), `activate`, `tick` (engine.step, or step_stacked with the
scenario's stack), `refused` (routing_error of a request, which must not
be None).  Then a snapshot round trip: export_state to
state/snapshot.py's per-rank file, loaded into a fresh engine of the same
rank, every plane, table and pending key compared.  Then lockstep serving
(core/batcher.py): a WindowBatcher on a LockstepClock at the agreed epoch,
this rank's `serve` requests submitted, rank 0 ending the loop through
stop_lockstep and rank 1 waiting for its loop to end at the tick the two
agreed.  With `serve.snapshots`, the tick loop's snapshot hook saves the
rank's file at a tick both ranks share (`agreed`) and at a tick of its own
(`skewed`), and after the stop each file set is restored into a fresh
engine through state/snapshot.py restore_mesh_engine, as is a set where
rank 1's file is missing.  Writes every response, the arenas and the
figures to OUT.npz.  Imports only the port (no JAX).
"""

import asyncio
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gubernator_tpu_torch.api.types import RateLimitReq  # noqa: E402
from gubernator_tpu_torch.config import BehaviorConfig  # noqa: E402
from gubernator_tpu_torch.core.batcher import WindowBatcher  # noqa: E402
from gubernator_tpu_torch.core.engine import RateLimitEngine  # noqa: E402
from gubernator_tpu_torch.parallel import distributed  # noqa: E402
from gubernator_tpu_torch.state import snapshot as snapmod  # noqa: E402


def req(r):
    name, key, hits, limit, duration, algo, behavior = r
    return RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                        duration=duration, algorithm=algo, behavior=behavior)


def engine(sc, mesh):
    g = sc["geometry"]
    return RateLimitEngine(
        capacity_per_shard=g["C"], batch_per_shard=g["B"],
        num_shards=mesh.local_shards, global_capacity=g["G"],
        global_batch_per_shard=g["Bg"], max_global_updates=g["Kg"],
        device="cpu", use_native="on" if sc["native"] else False, mesh=mesh)


def resp_rows(resps):
    return np.asarray([[r.status, r.limit, r.remaining, r.reset_time]
                       for r in resps], np.int64).reshape(-1, 4)


def serve(sc, eng, rank, out):
    """Lockstep serving, then the agreed stop."""
    spec = sc["serve"]
    clock = distributed.LockstepClock(distributed.agree_epoch_ms(eng.mesh),
                                      spec["interval"])
    b = WindowBatcher(eng, BehaviorConfig(batch_wait=spec["interval"],
                                          lockstep_stack=sc["stack"]),
                      lockstep_clock=clock)
    snaps = spec.get("snapshots")
    if snaps:
        def file(kind):
            return snapmod.snapshot_path(os.path.join(snaps["dir"], kind),
                                         eng.local_shard_offset, True)

        async def tick_snapshot(now):
            # the hook runs between a tick's dispatches and the next's
            for kind, tick in (("agreed", snaps["agreed_tick"]),
                               ("skewed", snaps["skewed_ticks"][rank])):
                if clock.tick == tick:
                    snap = await asyncio.get_running_loop().run_in_executor(
                        b._executor, lambda: eng.export_state(now=now))
                    os.makedirs(os.path.dirname(file(kind)), exist_ok=True)
                    snapmod.save(snap, file(kind))

        b.snapshot_every = 1
        b.on_tick_snapshot = tick_snapshot

    async def run():
        b.start_lockstep()
        reqs = [req(r) for r in spec["reqs"][rank]]
        resps = await asyncio.gather(*(b.submit(r) for r in reqs))
        if rank == 0:
            tick = await b.stop_lockstep(timeout=60)
        else:
            await asyncio.wait_for(b._tick_task, 60)
            tick = b.stop_at_tick
        return resps, tick

    try:
        resps, tick = asyncio.run(run())
    finally:
        b.close()
    assert not any(r.error for r in resps), [r.error for r in resps]
    out["serve_resps"] = resp_rows(resps)
    out["serve_stop_tick"] = np.int64(tick)
    out["serve_ticks"] = np.int64(clock.tick)
    out["serve_pipeline"] = np.int64(b.pipeline is not None)
    if snaps:
        restore_agreement(sc, eng.mesh, rank, file, clock, out)


def restore_agreement(sc, mesh, rank, file, clock, out):
    """The tick files restored through restore_mesh_engine: the agreed
    set restores on both ranks, the skewed set and the set missing rank
    1's file on neither (every rank stays cold)."""
    fresh = engine(sc, mesh)
    snap = snapmod.restore_mesh_engine(fresh, file("agreed"))
    out["restored_agreed"] = np.int64(snap is not None)
    out["restored_agreed_now"] = np.int64(-1 if snap is None else snap.now)
    out["agreed_tick_now"] = np.int64(
        clock.time_of(sc["serve"]["snapshots"]["agreed_tick"] - 1))
    for name, arr in fresh.export_arena().items():
        if name.startswith(("gstate.", "gcfg.")):
            out[f"restored.{name}"] = arr
    missing = os.path.join(sc["serve"]["snapshots"]["dir"], "none.snap")
    for kind, path in (("skewed", file("skewed")),
                       ("missing", missing if rank == 1 else file("agreed"))):
        cold = engine(sc, mesh)
        snap = snapmod.restore_mesh_engine(cold, path)
        out[f"restored_{kind}"] = np.int64(snap is not None)
        out[f"cold_{kind}"] = np.int64(all(
            not arr.any() for name, arr in cold.export_arena().items()))


def main(path, rank, out_path):
    with open(path) as f:
        sc = json.load(f)
    assert distributed.initialize_from_env("cpu")
    mesh = distributed.global_mesh(sc["local_shards"])
    assert mesh.rank == rank and mesh.backend == "gloo"
    eng = engine(sc, mesh)
    out = {}
    tick = 0
    for step in sc["steps"]:
        op = step["op"]
        if op == "register":
            eng.register_global_keys([tuple(s) for s in step["specs"]],
                                     now=step["now"],
                                     pending=step.get("pending", False))
        elif op == "activate":
            eng.activate_global_keys(step["keys"])
        elif op == "refused":
            assert eng.routing_error(req(step["req"][rank])) is not None
        elif op == "tick":
            wins = [[req(r) for r in w] for w in step["windows"][rank]]
            if sc["stack"] > 1:
                got = eng.step_stacked(wins, step["now"],
                                       k_stack=sc["stack"])
            else:
                got = [eng.step(wins[0], step["now"])]
            for k, rs in enumerate(got):
                out[f"tick{tick}_w{k}"] = resp_rows(rs)
            tick += 1
    for name, arr in eng.export_arena().items():
        out[f"plane.{name}"] = arr
    out["reductions"] = np.int64(mesh.reductions)
    out["per_op"] = np.int64(eng.per_op)
    if "snapshot_now" in sc:
        snapshot_round_trip(sc, eng, mesh, out)
    if "serve" in sc:
        serve(sc, eng, rank, out)
        for name, arr in eng.export_arena().items():
            if name.startswith(("gstate.", "gcfg.")):
                out[f"after_serve.{name}"] = arr
    np.savez(out_path, **out)
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)


def snapshot_round_trip(sc, eng, mesh, out):
    """export_state to the rank's file, GLOBAL keys pending registration
    included, and back into a fresh engine of the same rank."""
    eng.register_global_keys([tuple(s) for s in sc["pending_at_snapshot"]],
                             now=sc["snapshot_now"], pending=True)
    # a mesh snapshot's stamp must be an agreed tick's time, as a
    # window's `now` must (the JAX engine's refusal)
    try:
        eng.export_state()
    except ValueError:
        pass
    else:
        raise AssertionError("a mesh export without `now` was accepted")
    assert (eng.export_state(now=sc["snapshot_now"]).gpending
            == sorted(eng._gpending))
    with tempfile.TemporaryDirectory() as tmp:
        file = snapmod.snapshot_path(tmp, eng.local_shard_offset,
                                     eng.multiprocess)
        out["snapshot_name"] = np.array(os.path.basename(file))
        snapmod.save(eng.export_state(now=sc["snapshot_now"]), file)
        fresh = engine(sc, mesh)
        fresh.import_state(snapmod.load(file))
    a, b = eng.export_arena(), fresh.export_arena()
    assert all(np.array_equal(a[k], b[k]) for k in a), "restored planes"
    assert fresh._gpending == eng._gpending and eng._gpending
    assert all(not fresh.global_ready(s[0])
               for s in sc["pending_at_snapshot"])
    assert (fresh.export_state(now=sc["snapshot_now"]).gtable[0]
            == eng.export_state(now=sc["snapshot_now"]).gtable[0])
    out["snapshot_ok"] = np.int64(1)
    eng.activate_global_keys([s[0] for s in sc["pending_at_snapshot"]])


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
