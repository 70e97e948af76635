"""Bytes the host uploaded to the card (the tiles' packs, the program's
`upload.bytes` counter, summed over the window's call records of
zippy_tpu_torch.profiling, on for the traced run) per output byte."""

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
    if not run.bytes_out:
        return None
    return counters.get("upload.bytes", 0) / run.bytes_out
