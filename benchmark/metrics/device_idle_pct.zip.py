"""Share of the traced window in which the card ran no operation: kernel,
copy or fill."""

import reduce


def read(run):
    if not run.trace:
        return None
    return reduce.idle_pct(run.trace["busy_s"], run.trace["window_s"])
