"""One run of one cell: set-up, a closed-loop window of the cell's call, the
check of what the window produced against the configuration's plain
reference, and the result line.

Everything that belongs to one configuration, traffic mix, kind of call or
metric sits in a file of its own, found by name:

* BENCHMARK.json's `configs` entry gives the configuration's file (the
  generator of its input, data/<payload>.py, and its sizes; level, format,
  the reference it is judged by: reference/<name>.py);
* traffic/<traffic>.json is the mix: which call (calls/<call>.py) and its
  parameters;
* metrics/<metric>.py reads one metric from the run (`read(run)`, None where
  there is nothing to read) and, for a per-layer metric, may name the
  program's functions it needs spans around (`SPANS`).

The program is reached only through the call modules and the span targets.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import random
import sys
import time
from dataclasses import dataclass, field

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zippy_tpu")
NAME_CHARS = 120        # a kernel's name in the breakdown, cut to this


class NoDevice(RuntimeError):
    """The cell's cards are not there."""


def load(path: pathlib.Path, prefix: str):
    """The Python file at `path` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    name = prefix + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one the benchmark may not
    load, compared whole (zippy_tpu_torch is not zippy_tpu)."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


class Bench:
    """BENCHMARK.json at `root` and the files under `home` it names."""

    def __init__(self, root: pathlib.Path = HERE.parent,
                 home: pathlib.Path = HERE):
        self.root, self.home = pathlib.Path(root), pathlib.Path(home)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for cfg in self.spec["configs"]:
            if cfg["name"] == cell["config"]:
                return json.loads((self.root / cfg["file"]).read_text())
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def mix(self, cell: dict) -> dict:
        path = self.home / "traffic" / f"{cell['traffic']}.json"
        return json.loads(path.read_text())

    def payload(self, cfg: dict, seed: int):
        """The configuration's input for `seed`, made by data/<payload>.py."""
        return load(self.home / "data" / f"{cfg['payload']}.py",
                    "bench_data_").make(cfg, seed)

    def calls(self, mix: dict):
        return load(self.home / "calls" / f"{mix['call']}.py", "bench_call_")

    def reference(self, cfg: dict):
        return load(self.home / "reference" / f"{cfg['reference']}.py",
                    "bench_ref_")

    def metrics(self, cell: dict, kind: str) -> list:
        """The `kind` ("end_to_end" or "per_layer") metrics the cell
        reports, each with its reader."""
        out = []
        for metric in self.spec[kind]:
            if cell["name"] in metric.get("workloads", [cell["name"]]):
                out.append((metric, load(
                    self.home / "metrics" / f"{metric['name']}.py",
                    "bench_metric_")))
        return out

    def peaks(self, kind: str) -> dict:
        table = json.loads((self.home / "peaks.json").read_text())
        return table.get(kind, {})


@dataclass
class Context:
    """What a call module is given in set-up."""
    cfg: dict
    payload: object
    seed: int
    device: str
    ref: object


@dataclass
class Run:
    """What a metric's reader reads."""
    setup_s: float
    window_s: float
    call_s: list
    bytes_in: int
    bytes_out: int
    peak_bytes: int | None = None
    spans: dict = field(default_factory=dict)
    launches: int | None = None
    trace: dict | None = None
    peak_bytes_per_s: float | None = None


def _launches() -> int | None:
    """The program's own count of kernel launches so far."""
    try:
        from zippy_tpu_torch.ops import kernel_build
    except ImportError:
        return None
    return sum(kernel_build.LAUNCHES.values())


TRACED_SECONDS = 10     # the profiler covers the window's first calls


class _GcClock:
    """Collections of the cyclic garbage collector and their seconds."""

    def __init__(self):
        self.count, self.seconds, self._t = 0, 0.0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.count += 1
            self.seconds += time.perf_counter() - self._t


def _holds(check: dict) -> bool:
    value = check["value"]
    if value is None:
        return False
    return (value <= check.get("at_most", value)
            and value >= check.get("at_least", value))


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, *, t0: float, device: str = "cuda",
             overrides: dict | None = None, impl: str = "program",
             log=sys.stderr) -> tuple[dict, list]:
    """One run. Returns the result (the last line's object) and the check
    lines that end standard error. `device="cpu"` and `overrides` (keys of
    the configuration) are for the tests' rehearsal at a tiny size;
    `impl="control"` puts the reference's control in the program's
    place."""
    import gc

    import torch

    import reduce
    import tracing

    cell = bench.cell(workload)
    importlib.import_module("zippy_tpu_torch")   # the program is beside us
    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell["chips"]):
        raise NoDevice(f"{workload} needs {cell['chips']} CUDA card(s); "
                       f"torch sees {torch.cuda.device_count()}")
    cfg = {**bench.config(cell), **(overrides or {})}
    mix = bench.mix(cell)
    kind = "per_layer" if trace else "end_to_end"
    metrics = bench.metrics(cell, kind)
    ctx = Context(cfg, bench.payload(cfg, seed), seed, device,
                  bench.reference(cfg))
    call = bench.calls(mix).Call(ctx)
    fn = call.control() if impl == "control" else call
    fn()                                        # the warm-up call
    spans = tracing.Spans({
        label: paths for metric, reader in metrics
        for label, paths in getattr(reader, "SPANS", {}).items()})
    if trace:
        tracing.warm_profiler(cuda)
    setup_peak = start_alloc = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        start_alloc = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    launches0 = _launches()
    if trace:
        spans.install()
    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    setup_s = time.perf_counter() - t0
    # A call's output is kept for the check if its index is in the mix's
    # seeded share (`check_every`), or if it is the last; another is
    # dropped once the next call has finished.
    every = mix.get("check_every", 1)
    offset = random.Random(seed).randrange(every)
    outs, sizes, times, cpu, errors = [], [], [], [], []
    session = tracing.Session(cuda) if trace else None
    traced_calls = None
    begin = time.perf_counter()
    deadline = begin + seconds
    while True:
        start = time.perf_counter()
        if times and start >= deadline:
            break
        cpu0 = time.process_time()
        try:
            out = fn()
        except Exception as exc:                # a failed call counts
            out = None
            errors.append(f"{type(exc).__name__}: {exc}")
        times.append((start, time.perf_counter()))
        cpu.append(time.process_time() - cpu0)
        sizes.append(call.sizes(out) if out is not None else (0, 0))
        if outs and (len(outs) - 1 + offset) % every:
            outs[-1] = None
        outs.append(out)
        if (session and session.open
                and times[-1][1] >= begin + TRACED_SECONDS):
            session.stop()
            traced_calls = len(times)
    if session and session.open:
        session.stop()
        traced_calls = len(times)
    end = times[-1][1]
    gc.callbacks.remove(gc_clock)
    spans.uninstall()
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    launches1 = _launches()
    run = Run(
        setup_s=setup_s, window_s=end - begin,
        call_s=[b - a for a, b in times],
        bytes_in=sum(s[0] for s in sizes),
        bytes_out=sum(s[1] for s in sizes),
        peak_bytes=None if peak is None else peak - start_alloc,
        spans={k: tuple(v) for k, v in spans.stats.items()},
        launches=(None if launches0 is None else launches1 - launches0),
    )
    if trace:
        t_read = time.perf_counter()
        dev_events, host_spans = session.events()
        print(f"trace: the first {traced_calls} calls, {len(dev_events)} "
              f"device operations, {len(host_spans)} host spans, read in "
              f"{time.perf_counter() - t_read:.2f} s", file=log)
        window = next(((s, e) for label, s, e in host_spans
                       if label == tracing.WINDOW_LABEL), None)
        if window is not None:
            summary = reduce.device_summary(
                dev_events,
                [h for h in host_spans if h[0] != tracing.WINDOW_LABEL],
                window)
            summary["least_bytes"] = sum(a + b for a, b in
                                         sizes[:traced_calls])
            if cuda and summary["busy_s"] > 0:
                run.trace = summary
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    run.peak_bytes_per_s = bench.peaks(name).get("hbm_bytes_per_s")
    call.close()                                # the program's state
    if cuda:
        torch.cuda.empty_cache()
    # The check, once the window has closed and the peak is read.
    checked = [out for out in outs if out is not None]
    outs.clear()
    problems, numbers = call.judge(checked)
    checked_n = len(checked)
    del checked

    values = {}
    for metric, reader in metrics:
        value = reader.read(run)
        if value is not None:
            values[metric["name"]] = {"value": value, "unit": metric["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": cell["chips"],
           "memory_peak_bytes": max(setup_peak, peak or 0)}
    if trace:
        dev["busy_s"] = run.trace["busy_s"] if run.trace else 0.0
        dev["window_s"] = (run.trace["window_s"] if run.trace
                           else run.window_s)
    checks = {
        "failed_calls": {"value": len(errors), "at_most": 0},
        "bad_outputs": {"value": len(problems), "at_most": 0},
        "checked_outputs": {"value": checked_n, "at_least": 1},
        **numbers,
    }
    correct = all(_holds(c) for c in checks.values())
    result = {"correct": correct, "attempted": len(times),
              "failed": len(errors), "metrics": values, "device": dev}
    if run.trace:
        result["breakdown"] = {
            "device_ops": [[op[:NAME_CHARS], sec]
                           for op, sec in run.trace["device_ops"]],
            "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = checks
    print(f"{workload} seed {seed}: {len(times)} calls in "
          f"{run.window_s:.3f} s, {len(errors)} failed, {checked_n} "
          f"checked; call seconds " + " ".join(
              f"{t:.4f}" for t in run.call_s), file=log)
    print("  the process's CPU seconds a call " + " ".join(
        f"{t:.4f}" for t in cpu), file=log)
    print(f"  in the window: {gc_clock.count} garbage collections in "
          f"{gc_clock.seconds:.4f} s", file=log)
    for text in (errors[:3] + problems[:3]):
        print(f"  {text}", file=log)
    lines = [f"check {key} {c['value']} "
             + " ".join(f"{k.replace('_', ' ')} {v}" for k, v in c.items()
                        if k != "value")
             for key, c in checks.items()]
    return result, lines
