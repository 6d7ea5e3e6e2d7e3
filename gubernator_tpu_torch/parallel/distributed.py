"""Mesh mode: several daemon processes serve one keyspace as one arena.

The port of `gubernator_tpu/parallel/distributed.py` with the layout of
`gubernator_tpu/parallel/mesh.py` folded in.  The JAX package joins every
host into one `jax.sharding.Mesh` and shards the arena over its devices;
here each process is one rank of a `torch.distributed` process group and
holds the shards [offset, offset + S_local) of S = world_size x S_local on
its device (`Mesh`).  Keys route to their shard's rank by
`crc32(key) % S` (parallel/router.py MeshShardPicker, core/engine.py
shard_of); windows dispatch on a clock every rank agrees on
(`LockstepClock`, `agree_epoch_ms`); and a GLOBAL key's hits from every
rank reconcile through one all-reduce of the window's per-slot sums, the
JAX engine's `lax.psum` (gubernator_tpu/core/engine.py:2679), between
global_stage_read and global_apply_rows (ops/global_kernel.py).  No
GlobalManager gRPC runs for them.

Lockstep is a hard requirement, as in the JAX package: every rank issues
the same sequence of collectives (an all-reduce a GLOBAL window, every
window, staged lanes or not), or the group hangs.  The serving layer keeps
it by ticking on the fixed clock even when a tick is empty
(core/batcher.py start_lockstep), and the graceful stop agrees on a final
tick (`WindowBatcher.stop_at_tick`).

Env surface (daemon wiring), as in the JAX package:
  GUBER_MESH_COORDINATOR   host:port of rank 0's store (enables mesh mode)
  GUBER_MESH_NUM_PROCESSES total process count
  GUBER_MESH_PROCESS_ID    this process's rank

The backend follows from where the ranks run: `nccl` when every rank has a
card of its own, `gloo` when ranks share a card or run on the CPU (NCCL
refuses two ranks on one device).  The ranks compare their device
identities through the group's store at init; one log line says which it
is.  Gloo stages a CUDA tensor's all-reduce through host memory itself.
Nothing here falls back: a group that cannot form, or an all-reduce that
fails, raises.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from datetime import timedelta
from typing import List, Optional

import torch

from gubernator_tpu_torch.api.types import millisecond_now

log = logging.getLogger("gubernator.mesh")

# how long a rank waits for the others at init and in a collective before
# the group fails (a dead peer ends a rank's serving, never hangs it)
GROUP_TIMEOUT_S = 120.0

# all-reduce wall times a Mesh keeps (the newest), in seconds
REDUCE_SAMPLES = 8192

# the group store's key of the agreed final tick (Mesh.propose_stop)
STOP_KEY = "guber/stop_tick"

# the process's group: backend and the device its ranks' tensors live on
_group: dict = {}


class Mesh:
    """The shard layout of a mesh, and its collectives.

    world_size ranks, this one `rank`, each holding `local_shards`
    consecutive shards of S = world_size x local_shards on its device:
    rank r owns the shards [r x local_shards, (r + 1) x local_shards).  A
    Mesh of one rank is a single process (no collective runs).  `backend`
    is the group's ("gloo" or "nccl"; "" for one rank), `device` where
    its collectives' tensors live."""

    def __init__(self, world_size: int = 1, rank: int = 0,
                 local_shards: int = 1, backend: str = "",
                 device=None, group=None, store=None):
        if world_size < 1 or not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a mesh of {world_size}")
        if local_shards < 1:
            raise ValueError("local_shards must be >= 1")
        self.world_size = world_size
        self.rank = rank
        self.local_shards = local_shards
        self.backend = backend
        self.device = torch.device("cpu" if device is None else device)
        self.group = group
        # the group's key-value store (the final tick's agreement,
        # exchange)
        self.store = store
        # exchanges made, so each one's store keys are its own
        self._exchanges = 0
        # all-reduces issued (counted before the collective, so one that
        # raised counts too), and the newest wall times (seconds)
        self.reductions = 0
        self.reduce_seconds: deque = deque(maxlen=REDUCE_SAMPLES)

    @property
    def num_shards(self) -> int:
        return self.world_size * self.local_shards

    @property
    def shard_offset(self) -> int:
        return self.rank * self.local_shards

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over every rank, in place (the JAX engine's psum over
        the shard axis); a no-op for one rank.  Every rank must call it at
        the same point of its collective sequence.  Raises when the group
        is gone or the collective fails."""
        if self.world_size == 1:
            return t
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("mesh all-reduce without a process group "
                               "(parallel/distributed.py "
                               "initialize_from_env)")
        t0 = time.perf_counter()
        self.reductions += 1
        dist.all_reduce(t, group=self.group)
        self.reduce_seconds.append(time.perf_counter() - t0)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank src's `t` on every rank, in place; a no-op for one rank."""
        if self.world_size == 1:
            return t
        import torch.distributed as dist
        dist.broadcast(t, src=src, group=self.group)
        return t

    def propose_stop(self, tick: int) -> int:
        """Agree on a final tick with the other ranks: the first proposal
        stored wins (the store's compare-and-set, no collective); returns
        the agreed tick.  Every rank's tick loop reads it (agreed_stop) and
        stops there, so none waits on an all-reduce another never
        issues."""
        if self.store is None:
            return tick
        return int(self.store.compare_set(STOP_KEY, "", str(tick)))

    def agreed_stop(self) -> Optional[int]:
        """The agreed final tick once a rank proposed one, else None."""
        if self.store is None or not self.store.check([STOP_KEY]):
            return None
        return int(self.store.get(STOP_KEY))

    def exchange(self, name: str, value: str) -> List[str]:
        """Every rank's `value`, in rank order, through the group's store
        (no collective): each rank posts its own and waits, at most the
        group's timeout, for the others'.  Every rank must make the same
        exchanges in the same order."""
        if self.world_size == 1:
            return [value]
        if self.store is None:
            raise RuntimeError("mesh exchange without the group's store")
        self._exchanges += 1
        prefix = f"guber/exchange/{self._exchanges}/{name}"
        self.store.set(f"{prefix}/{self.rank}", value)
        return [self.store.get(f"{prefix}/{r}").decode()
                for r in range(self.world_size)]

    def barrier(self) -> None:
        """Wait until every rank reaches this point (one collective; the
        host waits for it, whatever the backend queues it on)."""
        if self.world_size > 1:
            self.broadcast_(torch.zeros(1, dtype=torch.int64,
                                        device=self.device)).cpu()


def local_device_indices(mesh: Mesh) -> List[int]:
    """The global shard indices this rank holds."""
    return list(range(mesh.shard_offset, mesh.shard_offset
                      + mesh.local_shards))


def owning_process(shard: int, mesh: Mesh) -> int:
    """Which rank holds a global shard index (for host-side routing)."""
    if not 0 <= shard < mesh.num_shards:
        raise ValueError(f"shard {shard} outside a mesh of "
                         f"{mesh.num_shards}")
    return shard // mesh.local_shards


def rank_device(device=None, rank: int = 0) -> torch.device:
    """The device a rank runs on: `device` as given, except that a bare
    "cuda" on a host with several cards names card rank % count, so ranks
    spread over the cards and share one only when there are more ranks
    than cards."""
    dev = torch.device("cuda" if device is None else device)
    if (dev.type == "cuda" and dev.index is None
            and torch.cuda.is_available() and torch.cuda.device_count() > 1):
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _identity(dev: torch.device) -> str:
    if dev.type != "cuda":
        return dev.type
    return str(torch.cuda.get_device_properties(dev).uuid)


def initialize_from_env(device=None) -> bool:
    """Join the process group if GUBER_MESH_COORDINATOR (host:port of rank
    0's store) is set, as GUBER_MESH_PROCESS_ID of GUBER_MESH_NUM_PROCESSES,
    choosing the backend from where the ranks run.  Returns True when mesh
    mode is active.  `device`: the device the engine runs on
    (GUBER_TORCH_DEVICE; rank_device)."""
    coordinator = os.environ.get("GUBER_MESH_COORDINATOR", "")
    if not coordinator:
        return False
    world_size = int(os.environ["GUBER_MESH_NUM_PROCESSES"])
    rank = int(os.environ["GUBER_MESH_PROCESS_ID"])
    import torch.distributed as dist
    dev = rank_device(device, rank)
    host, _, port = coordinator.rpartition(":")
    timeout = timedelta(seconds=GROUP_TIMEOUT_S)
    store = dist.TCPStore(host or "127.0.0.1", int(port), world_size,
                          is_master=rank == 0, timeout=timeout)
    store.set(f"guber/device/{rank}", _identity(dev))
    idents = [store.get(f"guber/device/{r}").decode()
              for r in range(world_size)]
    own_cards = (all(i not in ("cpu", "") for i in idents)
                 and len(set(idents)) == world_size)
    backend = ("nccl" if own_cards and dev.type == "cuda"
               and dist.is_nccl_available() else "gloo")
    if backend == "nccl":
        # the rank's collectives run on its own card
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, world_size=world_size,
                            rank=rank, timeout=timeout)
    _group.update(backend=backend, device=dev, store=store)
    log.info("mesh mode: rank %d of %d on %s, torch.distributed backend %s "
             "(%s)", rank, world_size, dev, backend,
             "a card a rank" if backend == "nccl"
             else "ranks share a card" if dev.type == "cuda" else "cpu")
    return True


def global_mesh(local_shards: int) -> Mesh:
    """The mesh of the process group this process joined, each rank
    holding `local_shards` shards."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_from_env "
                           "first")
    backend = _group.get("backend", dist.get_backend())
    dev = _group.get("device", torch.device("cpu"))
    return Mesh(dist.get_world_size(), dist.get_rank(), local_shards,
                backend=backend,
                device=dev if backend == "nccl" else torch.device("cpu"),
                group=dist.group.WORLD, store=_group.get("store"))


def agree_epoch_ms(mesh: Mesh) -> int:
    """Every rank learns rank 0's wall clock through one broadcast.  The
    lockstep clock derives each tick's timestamp from this agreed epoch,
    because the window `now` must be equal on every rank
    (engine._resolve_now)."""
    t = torch.tensor([millisecond_now() if mesh.rank == 0 else 0],
                     dtype=torch.int64, device=mesh.device)
    return int(mesh.broadcast_(t).cpu()[0])


class LockstepClock:
    """Deterministic per-tick timestamps shared by every mesh process.

    Tick i's window timestamp is epoch + i*interval: equal everywhere by
    construction.  Hosts pace ticks with their local clocks; the
    collectives inside each window are the rendezvous, so skew shows up as
    backpressure, never as divergent state."""

    def __init__(self, epoch_ms: int, interval_s: float):
        self.epoch_ms = epoch_ms
        self.interval_s = interval_s
        self.tick = 0

    def time_of(self, tick: int) -> int:
        """Tick `tick`'s timestamp: rounded per tick from the exact float
        interval, so logical time never drifts from wall time even for
        sub-millisecond ticks."""
        return self.epoch_ms + round(tick * self.interval_s * 1000)

    def next_now(self) -> int:
        now = self.time_of(self.tick)
        self.tick += 1
        return now
