"""Share of the window spent on the entries' CRC-32s: the self time of the
program's `checksums` spans (crc32_many's issue of K2 + K3) and
`checksum.wait` spans (its one fetch of the raw CRCs), summed over the
window's call records (zippy_tpu_torch.profiling, on for the traced run)."""

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
    return 100.0 * sum(spans.get(name, (0, 0, 0))[1] for name in
                       ("checksums", "checksum.wait")) / 1e9 / run.window_s
