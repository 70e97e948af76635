"""Share of the window spent in the decode's host planner and pack
(inflate_device._plan_tiles and each batch's _tile_pack calls, once for
each member of the indexed stream): the self time of the program's
`plan_pack` spans, summed over the window's call records
(zippy_tpu_torch.profiling, on for the traced run). It reads no wrapper of
benchmark/tracing.py: a call of this cell makes about 650 of them, and the
traced run's labelling of idle gaps grows as their count times the card's
operations."""

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
    return 100.0 * spans.get("plan_pack", (0, 0, 0))[1] / 1e9 / run.window_s
