"""Share of the window in which the host waited on the card: the self time
of the program's `*.wait` spans (each encode group's fetch event, the
checksum's read), summed over the window's call records
(zippy_tpu_torch.profiling, on for the traced run)."""

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
    return 100.0 * sum(v[1] for name, v in spans.items()
                       if name.endswith(".wait")) / 1e9 / run.window_s
