"""Profiling hooks for the device codec paths: the port of
zippy_tpu/profiling.py, and the port's own spans and counters.

`trace` is torch.profiler around a block (the card's kernels, copies and
fills when there is a card), written as a Chrome trace; `annotate` labels a
region in it. StageRecorder and stage_timer are the reference's wall-clock
recorder, copied (the port imports nothing of zippy_tpu).

Spans and counters. The codec's host work is cut into named spans (`span`)
and counted (`count`), and each public call (`call`: `compress`,
`uncompress`) keeps one record of them: for each span its count, its self
time (its duration less that of the spans inside it) and its total time,
in host-clock nanoseconds; each counter's sum; the kernel launches in the
call; whether the call raised. Tracing is off by default, and then a span
or a count costs one check of a module-level flag. `enable()` turns it on;
`recent(n)` returns the last n records, of the last 4,096 kept in memory
(nothing is written to disk), and `window(n, since)` sums them. With tracing on, under a profiler (`trace`
enables tracing for its block) each span also labels its region
"zt.<name>" with record_function, on the same clock as the card's
operations. No span synchronizes the card, except in stage mode.

Stage mode: `span(name, stages, device)` with a `stages` dict adds the
block's seconds under `name`, the card synchronized before and after it,
whether tracing is on or not, so that a stage's kernels count in its own
time (`stages=` of deflate_array, inflate_device and their callers).

Usage:
    with zippy_tpu_torch.profiling.trace("/tmp/zt_trace"):
        zippy_tpu_torch.uncompress(blob)
    # -> /tmp/zt_trace/trace_<pid>_<ns>.json, for chrome://tracing or
    #    Perfetto, with every kernel the decode launched (K4 as
    #    inflate_extract_kernel) under the program's zt.* spans.

    zippy_tpu_torch.profiling.enable()
    zippy_tpu_torch.uncompress(blob)
    rec = zippy_tpu_torch.profiling.recent(1)[0]
    rec.spans["scan"]        # [count, self ns, total ns]

    with zippy_tpu_torch.profiling.stage_timer() as rec:
        zippy_tpu_torch.uncompress(blob)
    print(rec.report())
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import os
import threading
import time

import torch

KEPT = 4096                     # records held by recent()
LABEL_PREFIX = "zt."

_on = False
_records: collections.deque = collections.deque(maxlen=KEPT)
_seq = itertools.count()
_clock = time.perf_counter_ns
_profiler_enabled = getattr(torch._C._autograd, "_profiler_enabled",
                            lambda: True)


class _Thread(threading.local):
    rec = None                  # the open call record
    top = None                  # the innermost open span or call


_local = _Thread()


@dataclasses.dataclass(slots=True)
class Record:
    """One public call's spans and counters."""

    seq: int
    name: str
    start_ns: int = 0
    end_ns: int = 0
    failed: bool = False
    self_ns: int = 0            # the call's time under none of its spans
    spans: dict = dataclasses.field(default_factory=dict)  # [n, self, total]
    counters: dict = dataclasses.field(default_factory=dict)
    launches: int = 0           # kernel launches (kernel_build.LAUNCHES)


def enable() -> int:
    """Turn tracing on: spans and counts reach the open call record.
    Returns the newest record's sequence id (-1 if none), for `window`."""
    global _on
    _on = True
    return _records[-1].seq if _records else -1


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    """Whether tracing is on: guards counts whose value costs work."""
    return _on


def recent(n: int) -> list:
    """The last `n` call records, oldest first."""
    records = list(_records)
    return records[max(len(records) - n, 0):] if n > 0 else []


def window(n: int, since: int):
    """The last `n` records summed: ({span: [count, self ns, total ns]},
    {counter: sum}). None unless `n` records are kept and all came after
    the record with sequence id `since` (as `enable` returned it)."""
    records = recent(n)
    if n <= 0 or len(records) < n or records[0].seq <= since:
        return None
    spans: dict = {}
    counters: dict = {}
    for rec in records:
        for name, (k, self_ns, total_ns) in rec.spans.items():
            _add(spans, name, k, self_ns, total_ns)
        for name, value in rec.counters.items():
            counters[name] = counters.get(name, 0) + value
    return spans, counters


class _Off:
    """What span and call return with tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, stages: dict | None = None, device=None):
    """A context manager: the block as span `name` of the open call record
    while tracing is on; with a `stages` dict, also a synchronized stage
    (see the module's docstring). A span directly inside a span of the same
    name adds nothing to the record."""
    if not _on and stages is None:
        return _OFF
    return _Span(name, stages, device)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of the open call record."""
    if not _on:
        return
    rec = _local.rec
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def call(name: str):
    """A context manager around a public entry point: opens this thread's
    call record, kept once the block ends, whether or not it raised. An
    entry point inside another's block adds to the outer record."""
    if not _on or _local.rec is not None:
        return _OFF
    return _Call(name)


def laps():
    """Clock-only timing of the steps of a loop, for work done once a block
    or so: `lap = laps()`, then `if lap: lap(name)` after each step charges
    the time since the previous lap (or since `laps()`) to span `name`, and
    `if lap: lap.close()` after the loop adds the steps to the record at
    once, inside the innermost open span, with no profiler label. None with
    tracing off, so that a step costs one test."""
    if not _on:
        return None
    return _Laps()


def _launches() -> int:
    from .ops import kernel_build

    return sum(kernel_build.LAUNCHES.values())


def _sync(stages, device) -> None:
    if (stages is not None and device is not None
            and torch.device(device).type == "cuda"):
        torch.cuda.synchronize(device)


def _label(name: str):
    """record_function("zt." + name), entered, under an active profiler."""
    if not _profiler_enabled():
        return None
    label = torch.profiler.record_function(LABEL_PREFIX + name)
    label.__enter__()
    return label


def _add(spans: dict, name: str, k: int, self_ns: int,
         total_ns: int) -> None:
    entry = spans.get(name)
    if entry is None:
        spans[name] = [k, self_ns, total_ns]
    else:
        entry[0] += k
        entry[1] += self_ns
        entry[2] += total_ns


class _Span:
    __slots__ = ("name", "stages", "device", "rec", "parent", "label",
                 "child", "t0")

    def __init__(self, name: str, stages, device):
        self.name, self.stages, self.device = name, stages, device
        self.rec = self.parent = self.label = None

    def __enter__(self):
        _sync(self.stages, self.device)
        top = _local.top
        if _on and (top is None or top.name != self.name):
            self.rec = _local.rec
            self.parent, _local.top = top, self
            self.label = _label(self.name)
        self.child = 0
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        _sync(self.stages, self.device)
        total = _clock() - self.t0
        if self.stages is not None:
            self.stages[self.name] = (self.stages.get(self.name, 0.0)
                                      + total / 1e9)
        if self.label is not None:
            self.label.__exit__(None, None, None)
        if _local.top is self:
            _local.top = self.parent
            if self.parent is not None:
                self.parent.child += total
            if self.rec is not None:
                _add(self.rec.spans, self.name, 1, total - self.child,
                     total)
        return False


class _Call:
    __slots__ = ("name", "rec", "parent", "label", "child", "launches0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = _local.rec = Record(next(_seq), self.name)
        self.parent, _local.top = _local.top, self
        self.label = _label(self.name)
        self.launches0 = _launches()
        self.child = 0
        self.rec.start_ns = _clock()
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        rec = self.rec
        rec.end_ns = _clock()
        total = rec.end_ns - rec.start_ns
        rec.self_ns = total - self.child
        rec.failed = exc_type is not None
        rec.launches = _launches() - self.launches0
        if self.label is not None:
            self.label.__exit__(None, None, None)
        _local.rec, _local.top = None, self.parent
        if self.parent is not None:
            self.parent.child += total
        _records.append(rec)
        return False


class _Laps:
    __slots__ = ("t", "steps")

    def __init__(self):
        self.t = _clock()
        self.steps: dict = {}       # name: [count, ns]

    def __call__(self, name: str) -> None:
        now = _clock()
        step = self.steps.get(name)
        if step is None:
            self.steps[name] = [1, now - self.t]
        else:
            step[0] += 1
            step[1] += now - self.t
        self.t = now

    def close(self) -> None:
        top, rec = _local.top, _local.rec
        for name, (k, ns) in self.steps.items():
            if top is not None:
                top.child += ns
            if rec is not None:
                _add(rec.spans, name, k, ns, ns)
        self.steps = {}


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
    the profiler stops, so that no kernel of the block is left out), with
    tracing on for the block, so that the program's zt.* spans stand
    beside them. On exit the trace is written to `logdir` (created if
    needed) as trace_<pid>_<ns>.json. Yields the profiler, whose events()
    and key_averages() hold the same trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        _start_cuda_tracing()
    os.makedirs(logdir, exist_ok=True)
    was_on = _on
    enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize()
    finally:
        if not was_on:
            disable()
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
