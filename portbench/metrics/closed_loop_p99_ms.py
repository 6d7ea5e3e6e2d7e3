"""The 99th percentile of RPC latency over every RPC of a closed loop's
window (host-paced and queueing-bound: a per-layer reading there)."""

import numpy as np


def read(run):
    if run.driver != "closed_loop" or not run.rpcs:
        return None
    return float(np.percentile(run.latencies_ms, 99))
