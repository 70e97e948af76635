"""zippy_tpu_torch.profiling and zippy_tpu_torch.warmup on the CPU: the trace
is written, annotations reach the profiler, the stage recorder formats as
zippy_tpu.profiling's does for the same marks, and warmup runs on an explicit
CPU device."""

import itertools
import json
import os

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_thread  # noqa: E402,F401
import zippy_tpu_torch as zt  # noqa: E402
from zippy_tpu import profiling as jprof  # noqa: E402
from zippy_tpu_torch import profiling  # noqa: E402

PAYLOAD = b"the quick brown fox jumps over the lazy dog\n" * 400


def test_trace_writes_a_chrome_trace(tmp_path, one_thread):
    blob = zt.compress(PAYLOAD, 6, device="cpu")
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        assert zt.uncompress(blob, device="cpu") == PAYLOAD
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((logdir / files[0]).read_text())["traceEvents"]
    assert events


def test_annotate_names_reach_the_profiler(tmp_path, one_thread):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("zt-decode-region"):
            zt.uncompress(zt.compress(PAYLOAD, 1, device="cpu"),
                          device="cpu")
    assert "zt-decode-region" in {e.name for e in prof.events()}
    (path,) = tmp_path.iterdir()
    assert "zt-decode-region" in path.read_text()


@pytest.mark.parametrize("marks", [[], [("scan", 0.25), ("decode", 1.5)],
                                   [("a", 0.0), ("b", 0.0)]])
def test_stage_report_matches_reference(monkeypatch, marks):
    """The same clock readings through both recorders give the same
    report, the exit mark included."""
    reports = []
    for mod in (profiling, jprof):
        clock = itertools.chain(
            [0.0] + [sum(dt for _, dt in marks[:i + 1])
                     for i in range(len(marks))], itertools.repeat(10.0))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        with mod.stage_timer() as rec:
            for name, _ in marks:
                rec.mark(name)
        reports.append(rec.report())
        monkeypatch.undo()
    assert reports[0] == reports[1]


def test_warmup_runs_on_the_cpu(one_thread):
    assert zt.warmup(max_bytes=1 << 14, levels=(1, -1),
                     devices=["cpu"]) == 3
    assert zt.warmup(max_bytes=1 << 12, levels=(6,), decode=False,
                     devices=["cpu", "cpu"]) == 2


def test_warmup_default_devices_need_cuda():
    if torch.cuda.is_available():
        return
    with pytest.raises(zt.ZippyError):
        zt.warmup()
