"""Configuration read by the one-node serving path.

The subset of `gubernator_tpu/config.py` the port needs so far: the RPC
item cap, the batching behaviors (reference config.go:43-66) and the
dimensions of the regular and GLOBAL arenas.
"""

from __future__ import annotations

from dataclasses import dataclass

# Hard cap on items per RPC (reference gubernator.go:34).
MAX_BATCH_SIZE = 1000


@dataclass
class BehaviorConfig:
    """Batching window (reference config.go:43-57, defaults :59-66).

    Durations are seconds (float); 0.0005 is the reference's 500us default.
    """

    batch_timeout: float = 0.5
    batch_wait: float = 0.0005
    batch_limit: int = MAX_BATCH_SIZE

    def validate(self) -> None:
        if self.batch_limit > MAX_BATCH_SIZE:
            raise ValueError(
                f"Behaviors.BatchLimit cannot exceed '{MAX_BATCH_SIZE}'")


@dataclass
class EngineConfig:
    """Dimensions of the device arena (replaces the reference's LRU cache
    size knob GUBER_CACHE_SIZE, cache/lru.go:50)."""

    capacity_per_shard: int = 65536
    batch_per_shard: int = 1024
    # shards of the regular arena on the one device (the JAX package's mesh
    # size); keys spread over them by crc32
    num_shards: int = 1
    # the replicated GLOBAL arena: slots, lanes per shard per window, and
    # distinct GLOBAL keys per window
    global_capacity: int = 4096
    global_batch_per_shard: int = 256
    max_global_updates: int = 256
    # Replay-bound guard: max lanes of a NON-uniform duplicate-key run per
    # window before the window is cut there; 0 disables.
    replay_cap: int = 128
