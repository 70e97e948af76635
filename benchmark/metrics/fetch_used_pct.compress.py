"""The bytes of the encoded streams in the bytes the host fetched from the
card: the program's `fetch.used_bytes` (each block's ceil(bits / 8))
over its `fetch.bytes` (each group's metadata and whole word rows),
summed over the window's call records (zippy_tpu_torch.profiling, on for
the traced run), in percent."""

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
    if not counters.get("fetch.bytes"):
        return None
    return 100.0 * counters.get("fetch.used_bytes", 0) \
        / counters["fetch.bytes"]
