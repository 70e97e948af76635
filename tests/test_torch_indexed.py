"""zippy_tpu_torch's indexed gzip formats on the CPU: the ZT member lengths
(compress_indexed, uncompress_parallel) and the ZX decode-index sidecars
(compress_device_indexed, uncompress_device), held against zippy_tpu's and
CPython's readings of the same streams, and the checks that an untrusted
sidecar or ZT length must pass."""

import functools
import gzip
import struct
import threading
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zippy_tpu  # noqa: E402
from zippy_tpu import gzip_format as rgf  # noqa: E402
from zippy_tpu.ops import inflate_device as ridev  # noqa: E402
import zippy_tpu_torch as zt  # noqa: E402
from zippy_tpu_torch import gzip_format as gf  # noqa: E402
from zippy_tpu_torch.ops import checksums as tc  # noqa: E402
from zippy_tpu_torch.ops import inflate_device as idev  # noqa: E402
from _torch_parity import (  # noqa: E402,F401
    mixed_payload, one_thread, random_bytes, raw_deflate)

pytestmark = pytest.mark.usefixtures("one_thread")

DATA = mixed_payload(300_000, 61)
MEMBER = 1 << 17
HELLO = b"hello hello hello"


@functools.cache
def reference_stream() -> bytes:
    return rgf.compress_device_indexed(DATA, 6, member_size=MEMBER)


@functools.cache
def port_stream() -> bytes:
    return gf.compress_device_indexed(DATA, 6, member_size=MEMBER,
                                      device="cpu")


def _forbid_scan(monkeypatch):
    """The port's scan raises from here on: a decode that scans fails."""
    def scanned(*args, **kwargs):
        raise AssertionError("the decode scanned")

    monkeypatch.setattr(idev, "build_decode_index", scanned)


@pytest.fixture
def no_scan(monkeypatch):
    _forbid_scan(monkeypatch)


def _walk(blob: bytes) -> list:
    """[(offset, ZT length, is a sidecar)] of every member."""
    return [(pos, mlen, gf._member_zx(blob, pos) is not None)
            for pos, mlen in gf._zt_spans(blob)]


def _joined(parts) -> bytes:
    return b"".join(buf.numpy().tobytes() for buf, _ in parts)


@pytest.mark.parametrize("route", ["bytes", "array", "uncompress"])
def test_port_decodes_reference_stream_without_scan(route, no_scan):
    blob = reference_stream()
    if route == "bytes":
        assert gf.uncompress_device(blob, device="cpu") == DATA
    elif route == "array":
        parts = gf.uncompress_device(blob, array=True, device="cpu")
        assert [t for _, t in parts] == [MEMBER, MEMBER,
                                         len(DATA) - 2 * MEMBER]
        assert all(buf.shape == (t,) and buf.dtype == torch.uint8
                   for buf, t in parts)
        assert _joined(parts) == DATA
    else:
        assert zt.uncompress(blob, device="cpu") == DATA


@pytest.mark.parametrize("route", ["uncompress_device", "uncompress_parallel",
                                   "uncompress"])
def test_reference_decodes_port_stream(route):
    blob = port_stream()
    if route == "uncompress_device":
        assert rgf.uncompress_device(blob) == DATA
    elif route == "uncompress_parallel":
        assert rgf.uncompress_parallel(blob) == DATA
    else:
        assert zippy_tpu.uncompress(blob, engine_name="device") == DATA


def test_cpython_decodes_port_stream(monkeypatch):
    blob = port_stream()            # its encode scans each body
    _forbid_scan(monkeypatch)
    assert gzip.decompress(blob) == DATA
    members = _walk(blob)
    assert sum(not m[2] for m in members) == 3 and not members[0][2]
    # Every member's ZT length is its own, sidecars are a few percent.
    assert sum(m[1] for m in members) == len(blob)
    share = sum(m[1] for m in members if m[2]) / len(blob)
    assert 0 < share < 0.25
    assert gf.uncompress_device(blob, device="cpu") == DATA


def _indexes():
    """Scans (the reference's) of streams that exercise every column:
    dynamic blocks, many small blocks, stored spans, fixed blocks, empty."""
    text = DATA[:120_000]
    return {
        "dynamic": raw_deflate(text, 6),
        "small_blocks": raw_deflate(text, 9, mem_level=1),
        "stored": raw_deflate(random_bytes(70_000, 62) + text[:9000], 6),
        "fixed": raw_deflate(text[:50_000], 6, strategy=zlib.Z_FIXED),
        "empty": raw_deflate(b""),
    }


@pytest.mark.parametrize("name", sorted(_indexes()))
def test_serialize_index_raw_equals_reference(name):
    index = ridev.build_decode_index(_indexes()[name])
    port = zlib.decompress(gf.serialize_index(index), -15)
    assert port == zlib.decompress(rgf.serialize_index(index), -15)


@pytest.mark.parametrize("name", sorted(_indexes()))
def test_deserialize_index_equals_reference(name):
    blob = rgf.serialize_index(ridev.build_decode_index(_indexes()[name]))
    want, got = rgf.deserialize_index(blob), gf.deserialize_index(blob)
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.array_equal(np.asarray(got[key]), np.asarray(value)), key
        assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key
    # The port's own scan gives the same index.
    assert gf.serialize_index(idev.build_decode_index(_indexes()[name])) \
        == gf.serialize_index(want)


def test_sidecar_chunks_reassemble(monkeypatch):
    monkeypatch.setattr(gf, "_ZX_CHUNK", 700)
    data = DATA[:150_000]
    blob = gf.compress_device_indexed(data, 6, member_size=MEMBER,
                                      device="cpu")
    members = _walk(blob)
    assert [m[2] for m in members[:3]] == [False, True, True]
    assert gzip.decompress(blob) == data
    assert rgf.uncompress_parallel(blob) == data
    _forbid_scan(monkeypatch)
    assert gf.uncompress_device(blob, device="cpu") == data
    assert _joined(gf.uncompress_device(blob, array=True,
                                        device="cpu")) == data


def test_stray_sidecars_padding_and_empty_members(monkeypatch):
    blob = port_stream()
    members = _walk(blob)
    stray = blob[members[1][0]:members[1][0] + members[1][1]]
    assert members[1][2]
    empty = gf.compress_device_indexed(b"", 6, device="cpu")
    _forbid_scan(monkeypatch)
    assert gzip.decompress(empty) == b""
    # A sidecar before any data member belongs to none: it is skipped.
    # (After a data member it would be read as part of that one's index.)
    stream = stray + empty + blob
    assert gzip.decompress(stream) == DATA
    stream += bytes(3000)
    assert gf.uncompress_device(stream, device="cpu") == DATA
    assert zt.uncompress(stream, device="cpu") == DATA
    parts = gf.uncompress_device(stream, array=True, device="cpu")
    assert parts[0][1] == 0 and parts[0][0].shape == (0,)
    assert parts[0][0].dtype == torch.uint8
    assert _joined(parts) == DATA
    assert gf.uncompress_device(b"", device="cpu") == b""


def test_compress_indexed_and_uncompress_parallel():
    data = DATA[:200_000]
    blob = gf.compress_indexed(data, 6, member_size=1 << 16, device="cpu")
    members = _walk(blob)
    assert len(members) == 4 and not any(m[2] for m in members)
    assert gzip.decompress(blob) == data
    assert gf.uncompress_parallel(blob, device="cpu") == data
    assert rgf.uncompress_parallel(blob) == data
    # No sidecars: uncompress_device scans each member, as the reference.
    assert gf.uncompress_device(blob, device="cpu") == data
    # Member 0's ZT length swallows member 1: the walk still chains, but
    # the decode of member 0 ends before its ZT length.
    bad = bytearray(blob)
    struct.pack_into("<I", bad, 16, members[0][1] + members[1][1])
    assert gf._zt_spans(bytes(bad)) is not None
    for fn in (gf.uncompress_parallel, gf.uncompress_device):
        with pytest.raises(zt.ZippyError, match="ZT"):
            fn(bytes(bad), device="cpu")
    for fn in (gf.compress_indexed, gf.compress_device_indexed):
        with pytest.raises(zt.ZippyError, match="member_size"):
            fn(HELLO, 6, member_size=0, device="cpu")
    # No ZT index at all: the scanned decode of every member.
    plain = gzip.compress(data[:70_000]) + gzip.compress(data[70_000:])
    assert gf.uncompress_parallel(plain, device="cpu") == data


def _member_bodies(blob: bytes) -> list:
    """The raw DEFLATE body of every data member (sidecars left out)."""
    out = []
    for pos, n, side in _walk(blob):
        if not side:
            out.append(blob[gf.parse_header(blob, pos)["data_offset"]:
                            pos + n - 8])
    return out


@pytest.mark.parametrize("fn", ["compress_indexed",
                                "compress_device_indexed"])
def test_default_level_members_run_the_callers_matcher(fn):
    """At level -1 each member of host bytes runs level 6's matcher, as
    compress() of its slice does (the reference's native route); a
    tensor's members keep level 1's."""
    words = [b"alpha", b"beta", b"gamma", b"delta", b"epsilon", b"zeta",
             b"eta", b"theta", b"iota", b"kappa", b"lambda", b"mu"]
    rng = np.random.default_rng(62)
    data = b" ".join(words[i] for i in (rng.zipf(1.3, 6000) - 1) % 12)
    member = 1 << 14
    slices = [data[i:i + member] for i in range(0, len(data), member)]
    assert len(slices) >= 3
    raw = [zt.compress(s, -1, zt.dfDeflate, device="cpu") for s in slices]
    assert raw != [zt.compress(s, 1, zt.dfDeflate, device="cpu")
                   for s in slices]
    write = getattr(gf, fn)
    assert _member_bodies(write(data, -1, member_size=member,
                                device="cpu")) == raw
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    assert _member_bodies(write(x, -1, member_size=member)) == [
        zt.compress(x[i:i + member], 1, zt.dfDeflate)
        for i in range(0, len(data), member)]


def test_write_member_extra():
    extra = b"AB\x03\x00xyz"
    port = gf.write_member(HELLO, 6, extra=extra, device="cpu")
    ref = rgf.write_member(HELLO, 6, extra=extra, engine_name="native")
    hdr = gf.parse_header(port)
    assert hdr["extra"] == extra and hdr["name"] is not None
    assert port[:12 + len(extra)] == ref[:12 + len(extra)]
    assert gzip.decompress(port) == HELLO
    with pytest.raises(zt.ZippyError):
        gf.write_member(b"x", 6, extra=bytes(0x10000), device="cpu")


def test_inflate_device_array_acc():
    """The sums asked for stay tensors: adler32 as int64, the crc as K3's
    raw int32, finished on the host; those not asked for are None."""
    blob = raw_deflate(DATA[:90_000], 6)
    index = idev.build_decode_index(blob)
    buf, total, adler_t, crc_t, keep = idev.inflate_device_array_acc(
        blob, index, "cpu")
    assert total == 90_000 and buf.shape == (total,)
    assert buf.numpy().tobytes() == DATA[:90_000]
    assert adler_t.shape == crc_t.shape == (1,)
    assert (adler_t.dtype, crc_t.dtype) == (torch.int64, torch.int32)
    assert int(adler_t) == zlib.adler32(DATA[:90_000])
    assert tc.crc32_finish(int(crc_t), total) == zlib.crc32(DATA[:90_000])
    assert isinstance(keep, list)
    _, _, adler_t, crc_t, _ = idev.inflate_device_array_acc(
        blob, index, "cpu", adler=False, crc=False)
    assert adler_t is None and crc_t is None
    empty = raw_deflate(b"")
    buf, total, adler_t, crc_t, _ = idev.inflate_device_array_acc(
        empty, idev.build_decode_index(empty), "cpu")
    assert total == 0 and buf.shape == (0,) and buf.dtype == torch.uint8
    assert (int(adler_t), tc.crc32_finish(int(crc_t), 0)) == (1, 0)


def _data_member(blob: bytes, i: int):
    """(offset, ZT length) of the i-th data member."""
    return [m[:2] for m in _walk(blob) if not m[2]][i]


def test_flipped_member_crc_raises():
    blob = port_stream()
    pos, mlen = _data_member(blob, 1)
    bad = bytearray(blob)
    bad[pos + mlen - 5] ^= 0xFF
    for array in (False, True):
        with pytest.raises(zt.ZippyError, match="Checksum"):
            gf.uncompress_device(bytes(bad), array=array, device="cpu")


def _with_index(blob: bytes, i: int, edit) -> bytes:
    """blob with the i-th data member's sidecars rebuilt from its index
    after edit(index) (edit may return raw bytes to deflate instead)."""
    members = _walk(blob)
    data = [j for j, m in enumerate(members) if not m[2]]
    j = data[i]
    k = j + 1
    while k < len(members) and members[k][2]:
        k += 1
    pos, mlen, _ = members[j]
    index = gf.deserialize_index(b"".join(
        gf._member_zx(blob, members[m][0]) for m in range(j + 1, k)))
    out = edit(index)
    if isinstance(out, bytes):
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        side = c.compress(out) + c.flush()
    else:
        side = gf.serialize_index(index)
    end = members[k][0] if k < len(members) else len(blob)
    return (blob[:pos + mlen] + gf._sidecar_members(side, "cpu")
            + blob[end:])


def _set(key, value):
    def edit(index):
        index[key] = value
    return edit


def _edit_rows(key, col, fn):
    def edit(index):
        index[key][:, col] = fn(index[key][:, col])
    return edit


TAMPERED = {
    "adler": lambda index: index.update(adler=index["adler"] ^ 1),
    "total_out_isize": lambda index: index.update(
        total_out=index["total_out"] + 1),
    "total_out_huge": lambda index: index.update(
        total_out=index["total_out"] + (1 << 40)),
    "end_bit": lambda index: index.update(end_bit=index["end_bit"] - 64),
    "every_zero": _set("every", 0),
    "every_large": _set("every", 2048),
    "bits_past_body": _edit_rows("segments", 0, lambda c: c + (1 << 24)),
    "outs_past_total": _edit_rows("segments", 1, lambda c: c + (1 << 24)),
    "block_past_count": _edit_rows("segments", 2, lambda c: c + 200),
}


@pytest.mark.parametrize("name", sorted(TAMPERED))
def test_tampered_sidecar_raises(name):
    bad = _with_index(port_stream(), 0, TAMPERED[name])
    why = "verification" if name == "adler" else "inconsistent"
    for array in (False, True):
        with pytest.raises(zt.ZippyError, match=why):
            gf.uncompress_device(bad, array=array, device="cpu")


def test_untampered_rebuild_decodes():
    """_with_index itself keeps a stream valid when nothing is edited."""
    blob = _with_index(port_stream(), 2, lambda index: None)
    assert gf.uncompress_device(blob, device="cpu") == DATA


# ---------------------------------------------------------------------------
# C1: a ZT length of 0 (the reference never advances past it and hangs)
# ---------------------------------------------------------------------------


def _zt0_sidecar() -> bytes:
    """37 bytes: an empty-payload member whose FEXTRA holds ZT 0 and ZX
    'abc'."""
    extra = struct.pack("<2sHI", b"ZT", 4, 0) + b"ZX\x03\x00abc"
    return (struct.pack("<2sBBIBB", gf.GZIP_MAGIC, 8, gf.FEXTRA, 0, 0, 0)
            + struct.pack("<H", len(extra)) + extra + b"\x03\x00" + bytes(8))


def _ends_within(fn, seconds: float = 20.0):
    """fn() in a daemon thread; asserts it ends in time. Returns what it
    returned or raised."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except Exception as e:  # noqa: BLE001 - handed to the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), "the decode did not end"
    return box


@pytest.mark.parametrize("lead", ["alone", "after_data_member"])
def test_zt_zero_length_raises(lead):
    side = _zt0_sidecar()
    assert len(side) == 37 and gzip.decompress(side) == b""
    stream = side
    if lead == "after_data_member":
        stream = gf.compress_indexed(HELLO, 6, device="cpu") + side
        assert gzip.decompress(stream) == HELLO
    for array in (False, True):
        box = _ends_within(lambda: gf.uncompress_device(
            stream, array=array, device="cpu"))
        assert isinstance(box.get("error"), zt.ZippyError), box
    if lead == "after_data_member":
        box = _ends_within(lambda: zt.uncompress(stream, device="cpu"))
        assert box.get("value") == HELLO, box


def test_sidecar_with_a_payload_raises():
    blob = port_stream()
    pos, mlen, side = _walk(blob)[1]
    assert side
    bad = bytearray(blob)
    bad[pos + mlen - 4] = 1                      # the sidecar's ISIZE
    with pytest.raises(zt.ZippyError, match="payload"):
        gf.uncompress_device(bytes(bad), device="cpu")


# ---------------------------------------------------------------------------
# C2: deserialize_index raises ZippyError on a malformed blob
# ---------------------------------------------------------------------------


def _raw_deflate_bytes(raw: bytes) -> bytes:
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    return c.compress(raw) + c.flush()


@pytest.mark.parametrize("case", ["magic_only", "counts_too_large",
                                  "not_deflate", "trailing_bytes"])
def test_deserialize_malformed_raises(case):
    good = gf.serialize_index(idev.build_decode_index(raw_deflate(HELLO)))
    if case == "magic_only":
        blob = _raw_deflate_bytes(b"ZTI1")
    elif case == "counts_too_large":
        raw = bytearray(zlib.decompress(good, -15))
        struct.pack_into("<I", raw, 6, 1 << 30)          # nseg
        blob = _raw_deflate_bytes(bytes(raw))
    elif case == "not_deflate":
        blob = b"\xff" * 40
    else:
        blob = good + b"junk"
    with pytest.raises(zt.ZippyError):
        gf.deserialize_index(blob)


# ---------------------------------------------------------------------------
# C3: serialize_index range-checks each column before it narrows it
# ---------------------------------------------------------------------------


def _small_index():
    return dict(idev.build_decode_index(raw_deflate(DATA[:40_000], 6)))


@pytest.mark.parametrize("column", ["block_step", "ntok", "bit_backwards",
                                    "stored_len"])
def test_serialize_index_rejects_values_out_of_range(column):
    index = _small_index()
    seg = index["segments"].copy()
    assert seg.shape[0] > 1
    if column == "block_step":
        seg[1:, 2] += 256           # a block-id step of 256 does not fit u1
    elif column == "ntok":
        seg[0, 3] = 1 << 16
    elif column == "bit_backwards":
        seg[1, 0] = seg[0, 0] - 1
    else:
        index["stored"] = np.array([[0, 0, 1 << 32]], np.int64)
    index["segments"] = seg
    with pytest.raises(zt.ZippyError):
        gf.serialize_index(index)
    # The reference narrows the block step without a check: it wraps.
    if column == "block_step":
        back = rgf.deserialize_index(rgf.serialize_index(index))
        assert not np.array_equal(back["segments"][:, 2], seg[:, 2])
