"""The call records of zippy_tpu_torch's indexed gzip entry points on the
CPU: uncompress_device keeps one `uncompress` record (or adds to
api.uncompress's), with an `index` span and the `index.members` and
`index.bytes` counters for each data member read from its sidecars, no scan
where every member has one, and a scan a member where none has; outputs are
the same with tracing off, and the decoded members are CPython's reading of
a seeded TPC-H lineitem payload. uncompress_parallel, compress_indexed and
compress_device_indexed keep their own records."""

import functools
import gzip
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

import zippy_tpu_torch as zt  # noqa: E402
from zippy_tpu_torch import gzip_format as gf  # noqa: E402
from zippy_tpu_torch import profiling  # noqa: E402
from _torch_parity import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

GENERATOR = (pathlib.Path(__file__).resolve().parents[1] / "benchmark"
             / "data" / "tpch_lineitem.py")
MEMBER = 1 << 14
# 150 orders of the chunk (about 600 rows, 75 KB) from a 64 KiB text pool.
LINEITEM = {"scale_factor": 0.001, "chunks": 10, "chunk": 1,
            "comment_chars": [10, 43], "text_pool_bytes": 1 << 16}


@functools.cache
def payload() -> bytes:
    spec = importlib.util.spec_from_file_location("_lineitem", GENERATOR)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.make(LINEITEM, 2**31 + 2203)


@functools.cache
def sidecar_stream() -> bytes:
    return gf.compress_device_indexed(payload(), 6, member_size=MEMBER,
                                      device="cpu")


@functools.cache
def zt_stream() -> bytes:
    return gf.compress_indexed(payload(), 6, member_size=MEMBER,
                               device="cpu")


def _members() -> int:
    return -(-len(payload()) // MEMBER)


def _zx_payloads(blob: bytes) -> list:
    """Every sidecar's ZX payload, walked by the ZT lengths."""
    found = [gf._member_zx(blob, pos) for pos, _ in gf._zt_spans(blob)]
    return [zx for zx in found if zx is not None]


def _joined(parts) -> bytes:
    return b"".join(buf.numpy().tobytes() for buf, _ in parts)


@pytest.fixture(autouse=True)
def tracing_restored():
    """Each test starts with tracing off and leaves it as it found it."""
    was = profiling.enabled()
    profiling.disable()
    yield
    (profiling.enable if was else profiling.disable)()


def _traced(fn, *args, **kwargs):
    """fn's result and the one record the call kept, with tracing on."""
    last = profiling.recent(1)
    profiling.enable()
    try:
        out = fn(*args, **kwargs)
    finally:
        profiling.disable()
    records = [r for r in profiling.recent(8)
               if not last or r.seq > last[0].seq]
    assert len(records) == 1, [r.name for r in records]
    return out, records[0]


@pytest.mark.parametrize("array", [True, False])
def test_one_uncompress_record_a_call(array):
    out, rec = _traced(gf.uncompress_device, sidecar_stream(), array=array,
                       device="cpu")
    assert rec.name == "uncompress" and not rec.failed
    assert (_joined(out) if array else out) == payload()
    assert {"framing", "index", "plan_pack", "checksum.wait"} <= set(
        rec.spans)
    if array:
        assert "fetch" not in rec.spans
    else:
        assert rec.counters["fetch.bytes"] == len(payload())
        assert rec.counters["fetch.used_bytes"] == len(payload())
        assert rec.spans["fetch"][0] == _members()


def test_index_once_a_data_member_with_its_zx_payloads_counted():
    blob = sidecar_stream()
    zx = _zx_payloads(blob)
    assert len(zx) >= _members() > 1
    _, rec = _traced(gf.uncompress_device, blob, array=True, device="cpu")
    assert rec.spans["index"][0] == _members()
    assert rec.counters["index.members"] == _members()
    assert rec.counters["index.bytes"] == sum(len(z) for z in zx)


@pytest.mark.parametrize("stream", ["sidecars", "zt_only"])
def test_scan_passes_only_where_a_member_has_no_sidecar(stream):
    blob = sidecar_stream() if stream == "sidecars" else zt_stream()
    out, rec = _traced(gf.uncompress_device, blob, device="cpu")
    assert out == payload()
    if stream == "sidecars":
        assert rec.counters.get("scan.passes", 0) == 0
        assert "scan" not in rec.spans
    else:
        assert _zx_payloads(blob) == []
        assert rec.counters["scan.passes"] == _members()
        assert "index.members" not in rec.counters


def test_api_uncompress_of_a_sidecar_stream_keeps_one_record():
    out, rec = _traced(zt.uncompress, sidecar_stream(), device="cpu")
    assert out == payload()
    assert rec.name == "uncompress"
    assert rec.counters["index.members"] == _members()
    assert rec.counters.get("scan.passes", 0) == 0


@pytest.mark.parametrize("array", [True, False])
def test_tracing_off_keeps_no_record_and_the_same_outputs(array):
    blob = sidecar_stream()
    last = profiling.recent(1)
    off = gf.uncompress_device(blob, array=array, device="cpu")
    assert profiling.recent(1) == last
    on, _ = _traced(gf.uncompress_device, blob, array=array, device="cpu")
    if array:
        assert [t for _, t in on] == [t for _, t in off]
        assert all(torch.equal(a, b) for (a, _), (b, _) in zip(on, off))
    else:
        assert on == off


def test_a_bad_sidecar_raises_the_same_error_traced_and_leaves_a_record():
    blob = bytearray(sidecar_stream())
    pos, mlen = gf._zt_spans(bytes(blob))[1]       # the first sidecar
    blob[pos + mlen - 1] ^= 0x01                   # its empty ISIZE
    with pytest.raises(zt.ZippyError) as off:
        gf.uncompress_device(bytes(blob), device="cpu")
    profiling.enable()
    with pytest.raises(zt.ZippyError) as on:
        gf.uncompress_device(bytes(blob), device="cpu")
    profiling.disable()
    assert str(on.value) == str(off.value)
    rec = profiling.recent(1)[0]
    assert rec.name == "uncompress" and rec.failed


def test_array_members_are_cpythons_reading_of_lineitem():
    blob = sidecar_stream()
    parts = gf.uncompress_device(blob, array=True, device="cpu")
    want = gzip.decompress(blob)
    assert want == payload()
    assert [t for _, t in parts] == [
        len(want[i:i + MEMBER]) for i in range(0, len(want), MEMBER)]
    for i, (buf, total) in enumerate(parts):
        assert buf.dtype == torch.uint8 and buf.shape == (total,)
        assert buf.numpy().tobytes() == want[i * MEMBER:(i + 1) * MEMBER]


@pytest.mark.parametrize("entry", ["uncompress_parallel", "compress_indexed",
                                   "compress_device_indexed"])
def test_the_other_indexed_entry_points_keep_a_record(entry):
    if entry == "uncompress_parallel":
        out, rec = _traced(gf.uncompress_parallel, zt_stream(), device="cpu")
        assert out == payload() and rec.name == "uncompress"
        assert rec.counters["scan.passes"] == _members()
    else:
        blob, rec = _traced(getattr(gf, entry), payload(), 6,
                            member_size=MEMBER, device="cpu")
        assert gzip.decompress(blob) == payload() and rec.name == "compress"
