"""The mean number of drains in flight while any was, over the window:
the change in the pipeline's in-flight time integral over the change in
its active wall time (overlap_snapshot's mean_inflight, by difference)."""


def read(run):
    c = run.counters
    return c["mean_inflight"] if c["active_s"] > 0 else None
