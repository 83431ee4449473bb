"""Seconds from the process's start to the window's: importing, making the
pool, building or loading the kernels, and the warm-up."""


def read(run):
    return run.setup_s
