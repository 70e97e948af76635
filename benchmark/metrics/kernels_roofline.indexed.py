"""The least time the traced calls take at the card's peak memory rate
(each call's indexed stream, sidecars included, read once and its output
written once, counted from their sizes), as a share of the kernels' summed
device time in the trace."""

import reduce


def read(run):
    if not run.trace or not run.trace["kernel_s"] or not run.peak_bytes_per_s:
        return None
    return reduce.roofline_pct(run.trace["least_bytes"], run.peak_bytes_per_s,
                               run.trace["kernel_s"])
