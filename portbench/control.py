"""The control and the planted faults: runs of a cell whose `correct` must
come out false.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 --mode control|state|half|answer

`control` puts the reference in the program's place, breaking the one
guarantee the configurations state (a key's requests apply one after
another): every request of an RPC is answered against the rows as they
stood before the RPC, each key keeping its last update.  The program still
serves each RPC (its clock and staging order stand), and the control's
answers replace its response.  The faults are planted under the timed
path, in the drain kernel's wrapper (ops/drain_kernel.drain_compact):
`state` restores the arena after every drain (a step that returns its
state unchanged), `half` makes every other lane of each drain a pad lane
(half of the batch left out), `answer` alters one answer of each drain
where the kernel produces it.  The benchmark's own runs run none of them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_wrap(serve, state):
    """serve() with the unserialized reference's answers in place of the
    program's."""
    from portbench import wire
    from portbench.reference import buckets
    rows = {}
    staged = state["slog"].staged
    groups = {}

    def group_of(data):
        """The key group of a pool's RPC (the probe pool is made after
        the window, so pools are looked up as they come)."""
        g = groups.get(id(data))
        if g is None:
            for pool in state["pools"].values():
                if pool is not None:
                    groups.update((id(d), pool.group[e])
                                  for e, d in enumerate(pool.datas))
            g = groups.get(id(data))
        return g

    async def control(data):
        out = await serve(data)
        # only the checked groups' answers are read: the others keep the
        # program's, which spares the reference most of the traffic
        if group_of(data) not in state["sample"]:
            return out
        now = next(t for d, t in reversed(staged) if d is data)
        before, answers = {}, []
        for r in wire.decode_list(data, wire.REQ_FIELDS):
            k = (r["name"], r["unique_key"])
            if k not in before:
                row = rows.get(k)
                before[k] = None if row is None else list(row)
            start = before[k]
            row, resp = buckets.apply(
                None if start is None else list(start), r["hits"],
                r["limit"], r["duration"], r["algorithm"], now)
            rows[k] = row
            answers.append(dict(zip(wire.RESP_COLUMNS, resp)))
        return wire.encode_list(answers, wire.RESP_FIELDS)

    return control


def plant(mode):
    """Wrap drain_kernel.drain_compact with the fault `mode`; returns a
    function that takes it out."""
    from gubernator_tpu_torch.ops import drain_kernel as dk
    orig = dk.drain_compact

    def state_unchanged(arena, packed, nows):
        saved = [p.clone() for p in arena]
        out = orig(arena, packed, nows)
        for p, s in zip(arena, saved):
            p.copy_(s)
        return out

    def half_left_out(arena, packed, nows):
        packed[:, :, 1::2, 0] = 0
        return orig(arena, packed, nows)

    def answer_altered(arena, packed, nows):
        words, limits, mism = orig(arena, packed, nows)
        live = (packed[..., 0] != 0).flatten().nonzero()
        if len(live):
            words.view(-1)[live[0, 0]] ^= 1
        return words, limits, mism

    dk.drain_compact = {"state": state_unchanged, "half": half_left_out,
                        "answer": answer_altered}[mode]

    def remove():
        dk.drain_compact = orig
    return remove


def run(cell, seed, seconds, mode, device="cuda", log=print):
    """One run of `cell` under `mode`; returns the result object."""
    from portbench import harness
    if mode == "control":
        return harness.run_cell(cell, seed, seconds, False, device,
                                wrap_serve=control_wrap, log=log)
    remove = plant(mode)
    try:
        return harness.run_cell(cell, seed, seconds, False, device, log=log)
    finally:
        remove()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--mode", default="control",
                   choices=("control", "state", "half", "answer"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import manifest
    cell = manifest.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run(cell, seed, args.seconds, args.mode)
        print(json.dumps(dict(workload=args.workload, mode=args.mode,
                              seed=seed, correct=res["correct"],
                              checks=res["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
