"""Time the GLOBAL window alone, as chip_smoke.py's phase 5e does, in the
package of a given checkout: G = 4096 and G = 2^20, 2048 lanes over 256
keys, device time (profiler, 100 launches) and CUDA-event time per call.
It lets a commit and a checkout of an earlier one be timed in turns in
one GPU session, each turn its own process:

    python3 compare_global_window.py CHECKOUT

CHECKOUT is a directory holding a `gubernator_tpu_torch` package (`.` for
this tree).  A package with `global_window` runs chip_smoke.py's
`phase_global_scaling`.  A package from before it (the G-row design,
which served a GLOBAL window through `global_combined`) runs the same
window through `global_combined`, with the config written and the sums
taken beforehand by its own torch ops, and is timed alike.  The measuring
functions are this tree's chip_smoke.py either way.  Prints one JSON line
per G, then the card's nvidia-smi name and power limit.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch


def load_chip_smoke(checkout):
    """This tree's chip_smoke.py, importing the package of `checkout`."""
    sys.path.insert(0, os.path.abspath(checkout))
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_measure", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def g_row_scaling(cs, seed=1717):
    """phase_global_scaling's windows through a G-row package's
    global_combined: the same generators, arenas and traffic."""
    from gubernator_tpu_torch.core.engine import apply_config
    gk, tk, DEV, T0 = cs.gk, cs.tk, cs.DEV, cs.T0
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    out = {}
    for G in (cs.G_FULL, 1 << 20):
        eng = cs.RateLimitEngine(capacity_per_shard=64, batch_per_shard=64,
                                 num_shards=cs.SHARDS, global_capacity=G)
        g = cs.random_arena(gen, G, T0, DEV)
        galgo = (torch.rand(G, generator=gen, device=DEV) < 0.3).to(
            torch.int32)
        st = tk.BucketState(*[t[0] for t in g[:5]], galgo)
        cfg = tk.GlobalConfig(st.limit.clone(), st.duration.clone(),
                              galgo.clone())
        for dst, src in zip((*eng.gstate, *eng.gcfg), (*st, *cfg)):
            dst.copy_(src)
        gbatch, gacc, upd = cs.global_traffic(rng, eng)
        del eng
        apply_config(st, cfg, tuple(torch.from_numpy(a).to(DEV)
                                    for a in upd))
        flat = tk.WindowBatch(*[torch.from_numpy(a).to(DEV).reshape(-1)
                                for a in gbatch])
        summed = tk.global_accumulate(
            torch.zeros(G, dtype=torch.int64, device=DEV),
            flat._replace(hits=torch.from_numpy(gacc).to(DEV).reshape(-1)))

        def fn():
            return gk.global_combined(st, cfg, flat, summed, T0)
        fn()
        out[G] = dict(ms=cs.device_ms(fn, 100, "global_combined_kernel"),
                      events_ms=cs.cuda_ms(fn, 100))
        del st, cfg
        torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("compare_global_window: no CUDA device")
    cs = load_chip_smoke(sys.argv[1] if len(sys.argv) > 1 else ".")
    if hasattr(cs.gk, "global_window"):
        kernel = "global_window"
        out = cs.phase_global_scaling()
    else:
        kernel = "global_combined"
        out = g_row_scaling(cs)
    for G, r in out.items():
        print(json.dumps(dict(kernel=kernel, G=G, ms=r["ms"],
                              events_ms=r["events_ms"])))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
