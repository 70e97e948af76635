"""Profiling hooks for the device codec paths: the port of
zippy_tpu/profiling.py.

`trace` is torch.profiler around a block (the card's kernels, copies and
fills when there is a card), written as a Chrome trace; `annotate` labels a
region in it. StageRecorder and stage_timer are the reference's wall-clock
recorder, copied (the port imports nothing of zippy_tpu).

Usage:
    with zippy_tpu_torch.profiling.trace("/tmp/zt_trace"):
        zippy_tpu_torch.uncompress(blob)
    # -> /tmp/zt_trace/trace_<pid>_<ns>.json, for chrome://tracing or
    #    Perfetto, with every kernel the decode launched (K4 as
    #    inflate_extract_kernel).

    with zippy_tpu_torch.profiling.stage_timer() as rec:
        zippy_tpu_torch.uncompress(blob)
    print(rec.report())
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch


@functools.cache
def _start_cuda_tracing() -> None:
    """One short CUDA profiler session, once a process, before its first
    trace: the first session of a process on the H100 has come back once
    without any device event (PERF.md, open questions), so that session is
    not a caller's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block: host operations, and the card's
    device operations when CUDA is available (the card synchronized before
    the profiler stops, so that no kernel of the block is left out). On
    exit the trace is written to `logdir` (created if needed) as
    trace_<pid>_<ns>.json. Yields the profiler, whose events() and
    key_averages() hold the same trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        _start_cuda_tracing()
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Label a region so its operations group under `name` in the trace (a
    context manager: torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


class StageRecorder:
    """Wall-clock stage recorder for environments without a trace viewer:
    call mark() between stages; report() formats the deltas. Device work is
    asynchronous: synchronize the card before a mark that should count
    it."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._marks: list[tuple[str, float]] = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self._marks.append((name, now - self._t0))
        self._t0 = now

    def report(self) -> str:
        total = sum(dt for _, dt in self._marks)
        lines = [f"{name:20s} {dt * 1e3:9.3f} ms ({dt / total:5.1%})"
                 for name, dt in self._marks] if total else []
        lines.append(f"{'total':20s} {total * 1e3:9.3f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def stage_timer():
    rec = StageRecorder()
    try:
        yield rec
    finally:
        rec.mark("(exit)")
