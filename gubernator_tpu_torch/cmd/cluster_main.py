"""Standalone dev cluster: six nodes on fixed ports, prints "Ready".

The port of `gubernator_tpu/cmd/cluster_main.py` (the reference's
cmd/gubernator-cluster, main.go:29-55), used by client development: the
client tests of the reference wait for the "Ready" line.  The nodes run
on GUBER_TORCH_DEVICE (default `cuda`; `cpu` runs the plain versions).

Run: python -m gubernator_tpu_torch.cmd.cluster_main
"""

from __future__ import annotations

import asyncio
import os

from gubernator_tpu_torch import cluster as cluster_mod

ADDRESSES = [f"127.0.0.1:{port}" for port in range(9090, 9096)]


async def serve(addresses=ADDRESSES, stop=None) -> None:
    """Run the cluster until `stop` (an asyncio.Event; default never) is
    set, printing "Ready" once every node serves."""
    c = await cluster_mod.start_with(
        addresses, device=os.environ.get("GUBER_TORCH_DEVICE") or "cuda")
    print("Ready", flush=True)
    try:
        await (stop if stop is not None else asyncio.Event()).wait()
    finally:
        await c.stop()


def main() -> None:
    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
