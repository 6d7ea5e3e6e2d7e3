"""Algorithm plane: the per-algorithm ladders layered over the fused drain.

The wire `algorithm` enum (api/types.py) carries five values; all of them
lower to the ONE shared transition ladder in ops/kernel.py, which every
lowering (int64 oracle, compact32-XLA, per-window Pallas, fused megakernel)
vmaps over.  This package holds what lives ABOVE the kernels:

  * oracles.py — pure-python serial references for all five algorithms,
    mirroring the device ladders branch for branch.  The differential test
    suites (tests/test_fold_fuzz.py, tests/test_algorithms.py) hold every
    lowering bit-exact against these.
  * leases.py — the host-side concurrency-lease book: who holds how many
    slots of which key, so stream-close and peer-death can release held
    slots and ring migration can re-register them.

Algorithm values (proto-compatible; 0/1 match the reference exactly):

  0 TOKEN_BUCKET    refill-on-expiry counter (algorithms.go:24-85)
  1 LEAKY_BUCKET    continuous leak (algorithms.go:88-186)
  2 GCRA            virtual-scheduling TAT arithmetic on the timestamp
                    column; emission interval = stored duration // request
                    limit (the same quirk as leaky's rate)
  3 SLIDING_WINDOW  weighted two-bucket interpolation; both counters pack
                    into the 15-bit halves of the remaining column
  4 CONCURRENCY     lease acquire/release; negative hits releases held
                    slots, remaining counts FREE slots

Out-of-range values degrade to TOKEN_BUCKET on-device, mirroring the
reference fallback (algorithms.go:100-104).
"""

from gubernator_tpu_torch.algorithms.leases import LeaseBook, LeaseGrant
from gubernator_tpu_torch.algorithms.oracles import ALGORITHM_NAMES, Row, apply

__all__ = ["ALGORITHM_NAMES", "LeaseBook", "LeaseGrant", "Row", "apply"]
