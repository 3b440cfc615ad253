"""Seconds from the start of the process to the window's opening: the
weights, the engine and its kernels, the warm-up and the ramp."""


def read(run):
    return run.setup_s
