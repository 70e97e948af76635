"""The indexed-gzip cell, driven through the harness on the CPU at a tiny size
(150 orders of the lineitem chunk in 16 KiB members, so that the stream has
several): correct as the program, traced and untraced; not correct as the
control, with a stream written without sidecars (decoded by the scanned
path), or with one output byte changed. The plain reference's walker on
streams that are not sound. On a machine with a CUDA card, the cell briefly
on the card."""

import gzip
import json
import struct
import subprocess
import sys
import time

import pytest

import harness
from conftest import HOME

CELL = "tpch-lineitem-gzip6-indexed1m.decode-device"
TINY = {"scale_factor": 0.001, "text_pool_bytes": 1 << 16,
        "member_bytes": 1 << 14}


@pytest.fixture(autouse=True)
def tracing_restored():
    """Loading a per-layer reader turns the program's tracing on: each test
    leaves it as it found it."""
    from zippy_tpu_torch import profiling

    was = profiling.enabled()
    yield
    (profiling.enable if was else profiling.disable)()


def rehearse(bench, *, trace=False, impl="program", seed=2**31 + 2211):
    return harness.run_cell(bench, CELL, seed, 0.3, trace,
                            t0=time.perf_counter(), device="cpu",
                            overrides=TINY, impl=impl)


@pytest.fixture(scope="module")
def ref(bench):
    return bench.reference(bench.config(bench.cell(CELL)))


@pytest.fixture(scope="module")
def stream():
    """A stream of the program's indexed format, and its payload."""
    import zippy_tpu_torch as zt

    data = b"".join(b"%d|%d|regular deposits haggle|\n" % (i, i * i % 977)
                    for i in range(4000))
    return zt.compress_device_indexed(data, 6, member_size=1 << 13,
                                      device="cpu"), data


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_is_correct_as_the_program(bench, trace):
    result, lines = rehearse(bench, trace=trace)
    assert result["correct"], result
    assert result["failed"] == 0 and result["attempted"] >= 1
    checks = result["checks"]
    assert checks["checked_outputs"]["value"] == result["attempted"]
    assert checks["sidecar_members"]["value"] >= \
        checks["sidecar_members"]["at_least"] > 1
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in bench.spec[kind]
               if CELL in m.get("workloads", [CELL])}
    assert set(result["metrics"]) <= set(allowed)
    if trace:
        # No card here: the device trace's metrics are absent.
        assert set(result["metrics"]) == {
            "index_share.indexed", "plan_pack_share.indexed",
            "scan_passes_per_call.indexed", "upload_MB_per_MB.indexed"}
        assert result["metrics"]["scan_passes_per_call.indexed"][
            "value"] == 0
        assert result["metrics"]["index_share.indexed"]["value"] > 0
    else:
        assert {"decode_MBps", "call_p95_ms", "setup_s"} <= set(
            result["metrics"])
    assert [line.split()[1] for line in lines] == list(checks)


def test_the_control_is_not_correct(bench):
    result, _ = rehearse(bench, impl="control")
    assert not result["correct"]
    assert result["checks"]["bad_outputs"]["value"] == result["attempted"]


def test_a_stream_without_sidecars_is_not_correct(bench, monkeypatch):
    # The members' ZT lengths alone: every member is scanned, its bytes are
    # right, and only the count of members with a sidecar gives it away.
    import zippy_tpu_torch as zt

    monkeypatch.setattr(zt, "compress_device_indexed", zt.compress_indexed)
    result, _ = rehearse(bench)
    assert result["checks"]["bad_outputs"]["value"] == 0
    assert result["checks"]["sidecar_members"]["value"] == 0
    assert not result["correct"]


def test_one_output_byte_changed_is_not_correct(bench, monkeypatch):
    import zippy_tpu_torch as zt

    real = zt.uncompress_device

    def flipped(*args, **kwargs):
        parts = real(*args, **kwargs)
        buf, _ = parts[len(parts) // 2]
        buf[len(buf) // 3] ^= 0x40
        return parts

    monkeypatch.setattr(zt, "uncompress_device", flipped)
    result, _ = rehearse(bench)
    assert result["checks"]["bad_outputs"]["value"] == result["attempted"]
    assert not result["correct"]


def _spans(blob: bytes) -> list:
    """[(offset, ZT length)] of each member, read as plainly as the
    reference does."""
    out, pos = [], 0
    while pos < len(blob):
        (mlen,) = struct.unpack_from("<I", blob, pos + 16)
        out.append((pos, mlen))
        pos += mlen
    return out


def test_the_walker_counts_each_data_member_with_a_sidecar(ref, stream):
    import zippy_tpu_torch as zt

    blob, data = stream
    members = -(-len(data) // (1 << 13))
    assert members > 2
    assert ref.decode(blob) == data
    assert ref.sidecar_members(blob) == members
    plain = zt.compress_indexed(data, 6, member_size=1 << 13, device="cpu")
    assert ref.sidecar_members(plain) == 0
    assert ref.decode(plain) == data


@pytest.mark.parametrize("where", ["first", "after_a_members_sidecars"])
def test_the_walker_refuses_a_stray_sidecar(ref, stream, where):
    blob, data = stream
    spans = _spans(blob)
    pos, mlen = spans[1]                      # the first member's sidecar
    sidecar = blob[pos:pos + mlen]
    if where == "first":
        bad = sidecar + blob
    else:
        at = spans[2][0]                      # before the second member
        bad = blob[:at] + sidecar + blob[at:]
    assert gzip.decompress(bad) == data       # any gzip reader is content
    with pytest.raises(ValueError):
        ref.sidecar_members(bad)


@pytest.mark.parametrize("cut", [1, 8, 100])
def test_the_walker_refuses_a_truncated_stream(ref, stream, cut):
    blob, _ = stream
    with pytest.raises(ValueError):
        ref.sidecar_members(blob[:-cut])


REHEARSAL = """
import sys, time
sys.path[:0] = [{home!r}, {root!r}]
import harness
bench = harness.Bench()
for trace in (False, True):
    harness.run_cell(bench, {cell!r}, 5, 0.2, trace, t0=time.perf_counter(),
                     device="cpu", overrides={tiny!r})
print(harness.forbidden_modules())
"""


def test_a_rehearsal_of_the_cell_loads_no_jax():
    code = REHEARSAL.format(home=str(HOME), root=str(HOME.parent), cell=CELL,
                            tiny=TINY)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=HOME / "tests", capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/readings.py", "--workload", CELL,
         "--seeds", str(2**31 + 2213), "--seconds", "1", "--impl", "both"],
        cwd=HOME.parent, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert [(line["impl"], line["correct"]) for line in lines] == [
        ("program", True), ("control", False)], lines
