"""Passes of the host scan (calls of zt_inflate_scan, the program's
`scan.passes` counter) per call, over the window's call records
(zippy_tpu_torch.profiling, on for the traced run): 0 where every member
is decoded from its sidecar index."""

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
    return counters.get("scan.passes", 0) / len(run.call_s)
