"""The 95th percentile of the wall time of every call in the window (host
clock), in milliseconds."""

import reduce


def read(run):
    return reduce.percentile(run.call_s, 95) * 1e3
