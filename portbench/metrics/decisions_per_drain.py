"""Decisions a pipeline drain staged over the window: the change in the
pipeline's decisions_staged over the change in its drains."""


def read(run):
    c = run.counters
    return c["decisions"] / c["drains"] if c["drains"] > 0 else None
