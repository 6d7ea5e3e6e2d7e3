"""Time the per-item serving path at saturation, as chip_smoke.py's phase 8
does, in the package of a given checkout: an Instance at phase 8's
geometry (8 x 2^21 slots, B = 1024, the router and the pipeline at their
defaults), warmed, then 64 clients sending 100-item RPCs of compact token
and leaky requests (Zipf keys over 2^20) through Instance.get_rate_limits
back to back, twice for SERVE_SECONDS each on the wall clock.  It lets a
commit and a checkout of an earlier one be timed in turns on one GPU,
each turn its own process:

    python3 compare_serving.py CHECKOUT [qos_off]

CHECKOUT is a directory holding a `gubernator_tpu_torch` package (`.` for
this tree).  `qos_off` builds the Instance with QoSConfig(enabled=False)
(a package with QoS only).  The measuring functions are this tree's
chip_smoke.py.  Prints one JSON line (decisions/s of each run, the
Instance's QoS sheds), then the card's nvidia-smi name and power limit.
"""

import asyncio
import json
import subprocess
import sys

import numpy as np

from compare_global_window import load_chip_smoke


def main():
    checkout = sys.argv[1]
    qos_off = sys.argv[2:] == ["qos_off"]
    cs = load_chip_smoke(checkout)
    kw = {}
    if qos_off:
        from gubernator_tpu_torch.config import QoSConfig
        kw["qos"] = QoSConfig(enabled=False)
    inst = cs.Instance(engine_config=cs.serving_engine_config(), **kw)
    inst.engine.warmup()
    rpcs = cs.serving_rpcs(np.random.default_rng(83), 512 * cs.SERVE_RPC,
                           "s", compact_only=True)
    rates = []

    async def run():
        cs.pin_clock(inst, None)
        await cs.saturate(inst.get_rate_limits, rpcs, 0.5)
        for _ in range(2):
            n, wall = await cs.saturate(inst.get_rate_limits, rpcs,
                                        cs.SERVE_SECONDS)
            rates.append(n / wall)

    try:
        asyncio.run(run())
    finally:
        inst.close()
    qos = getattr(inst, "qos", None)
    print(json.dumps(dict(
        checkout=checkout, qos=qos is not None, decisions_per_s=rates,
        sheds=dict(qos.admission.shed_counts) if qos is not None else {})))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())


if __name__ == "__main__":
    main()
