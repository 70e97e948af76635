"""Share of the window spent in the api and framing layer: the self time of
the program's `framing` spans (the gzip header and trailer, the stream's
bytes and the member's concatenation), summed over the window's call
records (zippy_tpu_torch.profiling, on for the traced run)."""

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
    return 100.0 * spans.get("framing", (0, 0, 0))[1] / 1e9 / run.window_s
