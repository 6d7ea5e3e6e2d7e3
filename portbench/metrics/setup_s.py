"""Seconds from the start of the process to the window's first RPC: the
port's import and build, the CUDA context, the Instance, the pools, the
warm-up and any fill."""


def read(run):
    return run.setup_s
