"""The rate of the output's fetch to the host: the program's `fetch.bytes`
over the total time of its `fetch` spans (the copy to pageable memory and
the bytes made of it), summed over the window's call records
(zippy_tpu_torch.profiling, on for the traced run), in 10^9 bytes a
second."""

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
    seconds = spans.get("fetch", (0, 0, 0))[2] / 1e9
    if not seconds:
        return None
    return counters.get("fetch.bytes", 0) / seconds / 1e9
