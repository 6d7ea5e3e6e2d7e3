"""drain_compact's share of its roofline over the window, in percent; the
bytes bound (roofline.py).

The numerator is the least device time the served decisions need,
counted from the traffic sent (roofline.drain_bound_s): each distinct key
of each RPC answered is one lane in and out, its arena row read once, and
the planes its hits change written once.  In a closed loop each caller
owns its keys and has one RPC in flight, so no two RPCs of a drain share
a key, and a distinct key of an RPC is a distinct (key, drain): under
uniform keys and under Zipf keys alike the row count is exact there.  The
one excess is a token bucket's (key, drain) whose every hit is over its
limit, which changes nothing and is charged 8 bytes.  The denominator is
drain_compact_kernel's summed device time in the profiler's trace of the
window.  None without a trace."""

from portbench import roofline


def read(run):
    if run.trace is None or run.trace["drain_kernel_s"] <= 0:
        return None
    return 100.0 * roofline.drain_bound_s(run.drain_rows,
                                          run.drain_write_bytes) \
        / run.trace["drain_kernel_s"]
