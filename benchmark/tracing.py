"""What the traced run (--trace 1) adds around the window, all from the
benchmark's own files:

* Spans: thin wrappers around the program's functions that the per-layer
  metrics name (each metric file's SPANS, {label: ["module:function", ...]}).
  A wrapper counts its calls and their host-clock seconds, adds no device
  synchronisation, and labels its region with record_function so that the
  device trace can say what the host was doing in an idle gap. A function
  that is not there leaves its label out, and the metrics that read it
  report nothing.
* The profiler: torch.profiler over the window's first calls, the card's
  operations with the host's labels, kept in memory. One throw-away
  session runs first, since the first session of a process has lost its
  first device activity.
"""

from __future__ import annotations

import functools
import importlib
import time

LABEL_PREFIX = "bench."
WINDOW_LABEL = LABEL_PREFIX + "window"


class Spans:
    """Wrappers installed over the program's functions for one window."""

    def __init__(self, targets: dict):
        self.targets = targets          # {label: ["module:function", ...]}
        self.stats: dict = {}           # {label: [calls, seconds]}
        self._undo: list = []

    def install(self) -> None:
        import torch

        for label, paths in self.targets.items():
            for path in paths:
                modname, _, attr = path.partition(":")
                try:
                    module = importlib.import_module(modname)
                    orig = getattr(module, attr)
                except (ImportError, AttributeError):
                    continue
                stat = self.stats.setdefault(label, [0, 0.0])
                setattr(module, attr, _wrap(orig, stat, LABEL_PREFIX + label,
                                            torch.profiler.record_function))
                self._undo.append((module, attr, orig))

    def uninstall(self) -> None:
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()


def _wrap(orig, stat: list, label: str, record_function):
    @functools.wraps(orig)
    def span(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            with record_function(label):
                return orig(*args, **kwargs)
        finally:
            stat[0] += 1
            stat[1] += time.perf_counter() - t0
    return span


def warm_profiler(cuda: bool) -> None:
    """The throw-away session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not cuda:
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()


class Session:
    """torch.profiler from here until `stop`, with the window's label
    around what it records; the card is synchronised before it stops."""

    def __init__(self, cuda: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = cuda
        activities = [ProfilerActivity.CPU]
        if cuda:
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.label = torch.profiler.record_function(WINDOW_LABEL)
        self.label.__enter__()
        self.open = True

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.label.__exit__(None, None, None)
        self.prof.stop()
        self.open = False

    def events(self) -> tuple[list, list]:
        return events(self.prof)


def events(prof) -> tuple[list, list]:
    """(device events, host spans) of a finished profile, as (name, start
    seconds, end seconds) on the profiler's clock: every device operation
    but the mirrors of host labels, and the host regions this module
    labelled (their prefix stripped; the window keeps its own label)."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns() / 1e9
        end = start + ev.duration_ns() / 1e9
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation() and not name.startswith(
                    LABEL_PREFIX):
                device.append((name, start, end))
        elif name.startswith(LABEL_PREFIX):
            host.append((name if name == WINDOW_LABEL
                         else name[len(LABEL_PREFIX):], start, end))
    return device, host
