"""A configuration, a traffic mix and a per-layer metric dropped in as new
files, with new entries in BENCHMARK.json, run with no other edit."""

import json
import shutil
import time

import harness
from conftest import HOME

NEW_METRIC = '''"""Output bytes per input byte, in percent."""


def read(run):
    if not run.bytes_in:
        return None
    return 100.0 * run.bytes_out / run.bytes_in
'''


def test_files_dropped_in_are_found_by_name(tmp_path):
    home = tmp_path / "benchmark"
    for sub in ("calls", "data", "reference", "metrics", "traffic"):
        shutil.copytree(HOME / sub, home / sub)
    shutil.copy(HOME / "peaks.json", home / "peaks.json")
    (home / "configs").mkdir()
    cfg = json.loads((HOME / "configs" / "tpch-lineitem-gzip6.json")
                     .read_text())
    cfg.update(name="tiny-lineitem-gzip1", level=1, control_level=0,
               scale_factor=0.001, text_pool_bytes=1 << 16)
    (home / "configs" / "tiny-lineitem-gzip1.json").write_text(
        json.dumps(cfg))
    (home / "traffic" / "compress-every-call.json").write_text(json.dumps({
        "call": "compress", "check_every": 1}))
    (home / "metrics" / "stream_share.compress.py").write_text(NEW_METRIC)
    spec = json.loads((HOME.parent / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "tiny-lineitem-gzip1", "source": cfg["source"],
        "file": "benchmark/configs/tiny-lineitem-gzip1.json", "reduced": [],
        "why": "a drop-in"})
    cell = "tiny-lineitem-gzip1.compress-every-call"
    spec["workloads"].append({
        "name": cell, "config": "tiny-lineitem-gzip1",
        "traffic": "compress-every-call", "chips": 1, "why": "a drop-in"})
    for metric in spec["end_to_end"]:
        if metric["name"] == "compress_MBps":
            metric["workloads"].append(cell)
    spec["per_layer"].append({
        "name": "stream_share.compress", "unit": "%", "better": "lower",
        "source": "program_counter", "layer": "api",
        "moves": "compress_MBps", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = harness.Bench(root=tmp_path, home=home)
    for trace, names in ((False, {"compress_MBps", "setup_s"}),
                         (True, {"stream_share.compress"})):
        result, _ = harness.run_cell(bench, cell, 3, 0.2, trace,
                                     t0=time.perf_counter(), device="cpu")
        assert result["correct"], result
        assert set(result["metrics"]) == names
        assert result["checks"]["checked_outputs"]["value"] == \
            result["attempted"]
    share = result["metrics"]["stream_share.compress"]["value"]
    assert share > 0
