"""The least time the traced calls take at the card's peak memory rate
(each call's tables read once and its archive written once, counted from
their sizes), as a share of the kernels' summed device time in the trace,
the rows' gathers on the card included."""

import reduce


def read(run):
    if not run.trace or not run.trace["kernel_s"] or not run.peak_bytes_per_s:
        return None
    return reduce.roofline_pct(run.trace["least_bytes"], run.peak_bytes_per_s,
                               run.trace["kernel_s"])
