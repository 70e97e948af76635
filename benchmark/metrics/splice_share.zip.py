"""Share of the window in which the host spliced encoded rows onto the
entries' streams: the total time of the program's `splice` spans, summed
over the window's call records (zippy_tpu_torch.profiling, on for the
traced run). The archive writer joins its rows on the card, so this reads 0
while the host splice stays off its path."""

try:
    from zippy_tpu_torch import profiling
    _SINCE = profiling.enable()
except (ImportError, AttributeError):   # a program without call records
    profiling = None


def read(run):
    totals = profiling and profiling.window(len(run.call_s), _SINCE)
    if totals is None:
        return None
    spans, counters = totals
    return 100.0 * spans.get("splice", (0, 0, 0))[2] / 1e9 / run.window_s
