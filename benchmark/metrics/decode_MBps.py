"""Output bytes (10^6) of every call completed in the window, over the
window's wall seconds (host clock)."""

import reduce


def read(run):
    return reduce.rate_mb_s(run.bytes_out, run.window_s)
