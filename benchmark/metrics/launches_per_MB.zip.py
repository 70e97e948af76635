"""Kernel launches in the window (the program's kernel_build.LAUNCHES,
summed) per 10^6 input bytes."""


def read(run):
    if not run.launches or not run.bytes_in:
        return None
    return run.launches / (run.bytes_in / 1e6)
