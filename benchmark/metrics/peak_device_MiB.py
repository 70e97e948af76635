"""What the program takes on the card beyond the caller's own tensors: the
allocator's peak over the window (its statistics reset at the window's
start) less what was allocated at the start, in MiB."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2**20
