"""Decisions answered a second: every item of every RPC answered in the
window, over the seconds from the window's start to its last answer.  An
item of a failed RPC is no decision."""


def read(run):
    return run.decisions / run.window_s if run.window_s > 0 else None
