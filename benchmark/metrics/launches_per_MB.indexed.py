"""Kernel launches in the window (the program's kernel_build.LAUNCHES,
summed) per 10^6 output bytes."""


def read(run):
    if not run.launches or not run.bytes_out:
        return None
    return run.launches / (run.bytes_out / 1e6)
