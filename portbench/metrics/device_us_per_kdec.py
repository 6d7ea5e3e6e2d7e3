"""Device microseconds per 1000 decisions answered: the union of every
CUDA kernel, copy and memset interval in the profiler's trace of the
window (the card's busy seconds), over the decisions answered in it.  The
card time each decision costs, whatever pace the host sets.  None without
a trace."""


def read(run):
    if run.trace is None or run.decisions <= 0:
        return None
    return run.trace["busy_s"] / run.decisions * 1e3 * 1e6
