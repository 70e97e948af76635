"""Share of the window spent building the dynamic blocks' headers in the
host splice: the self time of the program's `splice.header` span
(make_dynamic_header, timed a block at a time), summed over the window's
call records (zippy_tpu_torch.profiling, on for the traced run)."""

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
    return 100.0 * spans.get("splice.header", (0, 0, 0))[1] / 1e9 \
        / run.window_s
