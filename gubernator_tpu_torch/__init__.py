"""gubernator-tpu on PyTorch and CUDA: the serving path and the peer ring.

A second implementation of the rate-limit engine beside `gubernator_tpu`
(the JAX package, which stays the reference).  The arenas live as int64
tensors in device memory: regular keys in [S, C] planes over S shards,
GLOBAL keys in one replicated [G] arena.  Each batching window is applied
by hand-written CUDA kernels: ops/csrc/window_drain.cu (one CTA per shard)
sorts a shard's lanes by slot, walks each slot's lanes in arrival order
through the five-algorithm transition ladder, and commits one write per
touched slot; ops/csrc/global_window.cu answers the GLOBAL lanes from the
replica and applies their hits, summed over the shards, once per slot.
ops/kernel.py holds the same math as plain tensor code: it is what the
kernels are tested against, and what runs for tensors on the CPU.  Nodes
form a cluster over a consistent-hash ring (parallel/router.py,
net/peers.py, core/global_sync.py): a key is decided by its owner, and
GLOBAL limits sync through the owners' broadcasts.

This package imports neither JAX nor `gubernator_tpu`.  Its serving core,
the RPC bodies of server.py and their raw-bytes lane need neither grpcio,
protobuf, aiohttp nor prometheus_client; the transport modules that do
(api/pb.py, api/grpc_api.py, api/http_gateway.py, client.py, daemon.py,
observability/metrics.py) import them, and importing this package loads
none of them.  Entry points default to the `cuda` device and raise when
none is present; pass `device="cpu"` to run the plain versions.
"""

from gubernator_tpu_torch.api.types import (
    Algorithm,
    Behavior,
    HealthCheckResp,
    Hour,
    Millisecond,
    Minute,
    RateLimitReq,
    RateLimitResp,
    Second,
    Status,
)

__version__ = "0.1.0"

__all__ = [
    "Algorithm",
    "Behavior",
    "Status",
    "RateLimitReq",
    "RateLimitResp",
    "HealthCheckResp",
    "Second",
    "Minute",
    "Hour",
    "Millisecond",
    "__version__",
]
