"""The benchmark's arithmetic, from host-clock calls, span totals and device
trace events to numbers: pure Python, so that it can be held to synthetic
inputs on any machine.
"""

from __future__ import annotations

import statistics

MEMCOPY_PREFIXES = ("Memcpy", "Memset")


def rate_mb_s(nbytes: int, window_s: float) -> float:
    """10^6 bytes a second over the whole window."""
    return nbytes / window_s / 1e6


def percentile(values: list, q: int) -> float:
    """The q-th percentile (1-99) of `values`, as statistics.quantiles'
    inclusive method gives it; a single value is its own percentile."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def merge(intervals: list) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: list = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(iv) for iv in out]


def clip(events: list, lo: float, hi: float) -> list:
    """(name, start, end) events cut to [lo, hi]; those outside dropped."""
    return [(name, max(s, lo), min(e, hi)) for name, s, e in events
            if e > lo and s < hi]


def device_summary(device_events: list, host_spans: list, window: tuple,
                   top: int = 10) -> dict:
    """What a trace says of the window (start, end), in seconds:

    * busy_s: the union of every device operation (kernel, copy, fill);
    * kernel_s: the summed time of the kernels alone;
    * device_ops: [name, seconds] of the `top` operations with most time;
    * idle_gaps: [label, seconds] of the `top` longest stretches in which the
      card ran nothing, each labelled by the host span (name, start, end)
      that overlaps it most, or "other".
    """
    lo, hi = window
    ops = clip(device_events, lo, hi)
    busy = merge([(s, e) for _, s, e in ops])
    by_name: dict = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps, at = [], lo
    for s, e in busy + [(hi, hi)]:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    spans = clip(host_spans, lo, hi)
    labelled = []
    for gs, ge in gaps:
        best, label = 0.0, "other"
        for name, s, e in spans:
            overlap = min(e, ge) - max(s, gs)
            if overlap > best:
                best, label = overlap, name
        labelled.append([label, ge - gs])
    return {
        "busy_s": sum(e - s for s, e in busy),
        "kernel_s": sum(e - s for name, s, e in ops
                        if not name.startswith(MEMCOPY_PREFIXES)),
        "window_s": hi - lo,
        "device_ops": [[name, sec] for name, sec in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": sorted(labelled, key=lambda g: -g[1])[:top],
    }


def idle_pct(busy_s: float, window_s: float) -> float:
    return 100.0 * (1.0 - busy_s / window_s)


def roofline_pct(least_bytes: int, bytes_per_s: float,
                 kernel_s: float) -> float:
    """The least time the bytes take at the peak rate, as a share of the
    kernels' summed time."""
    return 100.0 * least_bytes / bytes_per_s / kernel_s
