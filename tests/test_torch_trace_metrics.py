"""The benchmark's readers of zippy_tpu_torch.profiling's call records
(benchmark/metrics/*.py whose source is inside the program), on the CPU:
each file loaded as the harness loads it, a warm-up call and a window of
calls, and its reading against the same sums worked out from
profiling.recent(); and the cases where a reader has nothing to read."""

import functools
import gzip
import importlib.util
import io
import itertools
import json
import pathlib
import types
import zipfile

import pytest

torch = pytest.importorskip("torch")

import zippy_tpu_torch as zt  # noqa: E402
from zippy_tpu_torch import profiling  # noqa: E402
from _torch_parity import mixed_payload, one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

METRICS = pathlib.Path(__file__).resolve().parents[1] / "benchmark" / "metrics"
TEXT = mixed_payload(40_000, 61) + mixed_payload(30_000, 62)
CALLS = 2                       # the window's calls, after one warm-up
_loads = itertools.count()


def _self_s(records, match):
    return sum(v[1] for r in records for name, v in r.spans.items()
               if match(name)) / 1e9


def _sum(records, counter):
    return sum(r.counters.get(counter, 0) for r in records)


# Each reader's number, from the window's records and the run.
EXPECTED = {
    "splice_header_share.compress": lambda rs, run: 100 * _self_s(
        rs, lambda n: n == "splice.header") / run.window_s,
    "host_wait_share.compress": lambda rs, run: 100 * _self_s(
        rs, lambda n: n.endswith(".wait")) / run.window_s,
    "fetch_used_pct.compress": lambda rs, run: 100 * _sum(
        rs, "fetch.used_bytes") / _sum(rs, "fetch.bytes"),
    "framing_share.compress": lambda rs, run: 100 * _self_s(
        rs, lambda n: n == "framing") / run.window_s,
    "scan_passes_per_call.decode": lambda rs, run: _sum(
        rs, "scan.passes") / len(rs),
    "upload_MB_per_MB.decode": lambda rs, run: _sum(
        rs, "upload.bytes") / run.bytes_out,
    "fetch_GBps.decode": lambda rs, run: _sum(rs, "fetch.bytes") / (
        sum(r.spans["fetch"][2] for r in rs) / 1e9) / 1e9,
    "host_wait_share.decode": lambda rs, run: 100 * _self_s(
        rs, lambda n: n.endswith(".wait")) / run.window_s,
    "framing_share.decode": lambda rs, run: 100 * _self_s(
        rs, lambda n: n == "framing") / run.window_s,
    "index_share.indexed": lambda rs, run: 100 * _self_s(
        rs, lambda n: n == "index") / run.window_s,
    "plan_pack_share.indexed": lambda rs, run: 100 * _self_s(
        rs, lambda n: n == "plan_pack") / run.window_s,
    "scan_passes_per_call.indexed": lambda rs, run: _sum(
        rs, "scan.passes") / len(rs),
    "upload_MB_per_MB.indexed": lambda rs, run: _sum(
        rs, "upload.bytes") / run.bytes_out,
    "splice_share.zip": lambda rs, run: 100 * sum(
        r.spans.get("splice", (0, 0, 0))[2] for r in rs) / 1e9
    / run.window_s,
    "framing_share.zip": lambda rs, run: 100 * _self_s(
        rs, lambda n: n == "framing") / run.window_s,
    "crc_share.zip": lambda rs, run: 100 * _self_s(
        rs, lambda n: n in ("checksums", "checksum.wait")) / run.window_s,
    "host_wait_share.zip": lambda rs, run: 100 * _self_s(
        rs, lambda n: n.endswith(".wait")) / run.window_s,
    "upload_MB_per_MB.zip": lambda rs, run: _sum(
        rs, "upload.bytes") / run.bytes_in,
    "fetch_used_pct.zip": lambda rs, run: 100 * _sum(
        rs, "fetch.used_bytes") / _sum(rs, "fetch.bytes"),
}
# Readers whose reading is 0 in their own cell: the indexed decode scans no
# member.
# Since the compress joins its rows on the card, its host splice builds no
# header: splice_header_share.compress reads 0 there. The archive writer
# joins its rows on the card too: splice_share.zip reads 0.
ZERO = {"scan_passes_per_call.indexed", "splice_header_share.compress",
        "splice_share.zip"}


@pytest.fixture(autouse=True)
def tracing_restored():
    """Loading a reader turns tracing on: each test leaves it as it found
    it."""
    was = profiling.enabled()
    yield
    (profiling.enable if was else profiling.disable)()


def _load(name: str):
    """benchmark/metrics/<name>.py as a fresh module, as the harness loads
    a per-layer metric."""
    spec = importlib.util.spec_from_file_location(
        f"_zt_metric_{next(_loads)}", METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.cache
def _indexed_stream() -> bytes:
    return zt.compress_device_indexed(TEXT, 6, member_size=1 << 14,
                                      device="cpu")


def _call(name: str):
    """One call of the reader's cell, on the CPU: (bytes in, bytes out)."""
    if name.endswith(".compress"):
        blob = zt.compress(TEXT, 6, device="cpu")
        assert gzip.decompress(blob) == TEXT
        return len(TEXT), len(blob)
    if name.endswith(".zip"):
        # The tables as the caller's tensors, as the zip cell holds them.
        tables = {"a.tbl": TEXT, "b.tbl": TEXT[:5000]}
        blob = zt.create_zip_archive({
            k: torch.frombuffer(bytearray(v), dtype=torch.uint8)
            for k, v in tables.items()}, device="cpu")
        with zipfile.ZipFile(io.BytesIO(blob)) as zf:
            assert {k: zf.read(k) for k in tables} == tables
        return sum(map(len, tables.values())), len(blob)
    if name.endswith(".indexed"):
        blob = _indexed_stream()
        parts = zt.uncompress_device(blob, array=True, device="cpu")
        assert b"".join(buf.numpy().tobytes() for buf, _ in parts) == TEXT
        return len(blob), len(TEXT)
    blob = gzip.compress(TEXT, 6)
    assert zt.uncompress(blob, device="cpu") == TEXT
    return len(blob), len(TEXT)


def _run(window_s: float, call_s: list, sizes: list):
    return types.SimpleNamespace(
        setup_s=1.0, window_s=window_s, call_s=call_s,
        bytes_in=sum(s[0] for s in sizes),
        bytes_out=sum(s[1] for s in sizes))


def test_these_are_the_readers_of_the_call_records():
    spec = json.loads((METRICS.parents[1] / "BENCHMARK.json").read_text())
    inside = {m["name"] for m in spec["per_layer"]
              if "profiling.window" in (METRICS / f"{m['name']}.py")
              .read_text()}
    assert inside == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_sums_the_window_of_calls(name):
    profiling.disable()
    metric = _load(name)
    assert profiling.enabled()                # loading it turns tracing on
    _call(name)                               # the warm-up
    sizes, call_s = [], []
    t0 = profiling._clock()
    for _ in range(CALLS):
        sizes.append(_call(name))
        call_s.append(0.5)
    run = _run((profiling._clock() - t0) / 1e9, call_s, sizes)
    records = profiling.recent(CALLS)
    kind = "compress" if name.endswith((".compress", ".zip")) \
        else "uncompress"
    assert [r.name for r in records] == [kind] * CALLS
    want = EXPECTED[name](records, run)
    if name in ZERO:
        assert want == 0
    else:
        assert want > 0
    assert metric.read(run) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("case", ["more_calls_than_records",
                                  "records_from_before_loading",
                                  "no_calls_in_the_window",
                                  "program_without_records"])
@pytest.mark.parametrize("name", ["splice_header_share.compress",
                                  "scan_passes_per_call.decode"])
def test_a_reader_reports_nothing_where_there_is_nothing_to_read(
        monkeypatch, name, case):
    profiling.enable()
    _call(name)                               # a record before loading
    if case == "program_without_records":
        monkeypatch.delattr(profiling, "enable")
    metric = _load(name)
    call_s = [0.5]
    if case == "more_calls_than_records":
        _call(name)
        call_s = [0.5] * (profiling.KEPT + 1)
    elif case == "no_calls_in_the_window":
        _call(name)
        call_s = []
    elif case == "program_without_records":
        assert metric.profiling is None
        _call(name)
    assert metric.read(_run(1.0, call_s, [(1, 1)])) is None


def test_window_sums_the_last_records_made_since():
    profiling.disable()
    since = profiling.enable()
    for k in range(3):
        with profiling.call("c"):
            with profiling.span("s"):
                profiling.count("n", k + 1)
    profiling.disable()
    spans, counters = profiling.window(2, since)
    assert counters == {"n": 2 + 3}
    assert spans["s"][0] == 2 and 0 <= spans["s"][1] <= spans["s"][2]
    assert profiling.window(3, since) is not None
    assert profiling.window(4, since) is None
    assert profiling.window(0, since) is None
    assert profiling.window(1, profiling.recent(1)[0].seq) is None
