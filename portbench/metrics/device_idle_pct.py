"""The card's idle share of the traced window, in percent: 100 x (1 - the
union of every CUDA kernel, copy and memset interval in the profiler's
trace over the window's wall).  None without a trace."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
