"""Time GLOBAL kernels as chip_smoke.py does, in the package of a given
checkout, so that a commit and a checkout of an earlier one can be timed
in turns on one card in one run, each turn its own process:

    python3 compare_global_window.py CHECKOUT [window|mesh]

CHECKOUT is a directory holding a `gubernator_tpu_torch` package (`.` for
this tree).  The measuring functions are this tree's chip_smoke.py; the
kernels are the checkout's, launched through its public wrappers.  Prints
one JSON line per window, then the card's nvidia-smi name and power
limit.

`window` (the default) times the GLOBAL window alone, as phase 5e does:
G = 4096 and G = 2^20, 2048 lanes over 256 keys, device time (profiler,
100 launches) and CUDA-event time per call.  A package with
`global_window` runs chip_smoke.py's `phase_global_scaling`.  A package
from before it (the G-row design, which served a GLOBAL window through
`global_combined`) runs the same window through `global_combined`, with
the config written and the sums taken beforehand by its own torch ops,
and is timed alike.

`mesh` times the mesh GLOBAL window's two kernels (global_stage_read and
global_apply_rows) on phase 16b's windows of a rank (256 keys; 1024
distinct keys; 256 keys with the engine's 256 pad config lanes) at
G = 4096 and G = 2^20, device time a launch (profiler, 200 launches
each).
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


def window_times(cs):
    """The GLOBAL window alone at each G, as phase 5e times it."""
    if hasattr(cs.gk, "global_window"):
        kernel = "global_window"
        out = cs.phase_global_scaling()
    else:
        kernel = "global_combined"
        out = g_row_scaling(cs)
    for G, r in out.items():
        print(json.dumps(dict(kernel=kernel, G=G, ms=r["ms"],
                              events_ms=r["events_ms"])))


def mesh_times(cs, seed=1607):
    """global_stage_read and global_apply_rows on phase 16b's windows."""
    gk = cs.gk
    cs.build.build((gk.SOURCE, gk.APPLY_SOURCE))
    rng = np.random.default_rng(seed)
    names = ("global_stage_read_kernel", "global_apply_rows_kernel")
    for G in (cs.G_FULL, 1 << 20):
        for kind in ("keys", "distinct", "padded"):
            st, cfg, ctl, summed, _, touched = cs.mesh_timing_inputs(
                rng, G, kind == "distinct",
                cs.KG_FULL if kind == "padded" else 1)
            scratch = torch.zeros(G, dtype=torch.int64, device=cs.DEV)

            def both():
                gk.global_stage_read(st, cfg, ctl, scratch, cs.T0)
                scratch.copy_(summed)
                gk.global_apply_rows(st, cfg, scratch, cs.T0)
            for _ in range(5):
                both()
            torch.cuda.synchronize()
            ms = cs.device_ms_each(both, cs.MESH_TIMED, names)
            print(json.dumps(dict(G=G, window=kind, touched=touched,
                                  stage_ms=ms[names[0]],
                                  apply_ms=ms[names[1]])))


def main():
    if not torch.cuda.is_available():
        sys.exit("compare_global_window: no CUDA device")
    which = sys.argv[2] if len(sys.argv) > 2 else "window"
    if which not in ("window", "mesh"):
        sys.exit(f"compare_global_window: unknown set {which!r}")
    cs = load_chip_smoke(sys.argv[1] if len(sys.argv) > 1 else ".")
    (mesh_times if which == "mesh" else window_times)(cs)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
