"""Host microseconds the router's C parse (parse_stack_fast) and C encode
(fastpath_encode_w) took over the window, per 1000 decisions answered:
perf_counter around each call, placed from outside the program."""


def read(run):
    if run.decisions <= 0:
        return None
    return (run.parse_s + run.encode_s) / run.decisions * 1e3 * 1e6
