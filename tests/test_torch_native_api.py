"""The host engine behind the port's public surface, held against zippy_tpu
in one process: compress()/uncompress(engine_name="native"), the engine's
routes, gzip_format's read_member, uncompress_gzip and concat_members, the
index sidecar, and streams of each engine decoded by the other."""

import functools
import gzip
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zippy_tpu  # noqa: E402
from zippy_tpu import engine as reng  # noqa: E402
from zippy_tpu import gzip_format as rgf  # noqa: E402
from zippy_tpu.ops import inflate_device as ridev  # noqa: E402
import zippy_tpu_torch as zt  # noqa: E402
from zippy_tpu_torch import engine, native  # noqa: E402
from zippy_tpu_torch import gzip_format as gf  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402
from zippy_tpu_torch.ops import inflate_device as idev  # noqa: E402
from _torch_parity import (  # noqa: E402,F401
    mixed_payload, one_thread, random_bytes, raw_deflate)

pytestmark = pytest.mark.usefixtures("one_thread")

FORMATS = ["dfGzip", "dfZlib", "dfDeflate"]


@functools.cache
def _data() -> bytes:
    return mixed_payload(120_000, 81)


@pytest.fixture
def fixed_padding(monkeypatch):
    """The same FNAME padding on both sides (it is os.urandom's)."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes([11]) * n)


def _same_error(port_call, ref_call) -> str:
    with pytest.raises(zt.ZippyError) as got:
        port_call()
    with pytest.raises(zippy_tpu.ZippyError) as want:
        ref_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("fmt", FORMATS)
def test_compress_native_equals_the_reference(fmt, fixed_padding):
    data = _data()
    for level in range(-2, 10):
        got = zt.compress(data, level, getattr(zt, fmt),
                          engine_name="native")
        want = zippy_tpu.compress(data, level, getattr(zippy_tpu, fmt),
                                  engine_name="native")
        assert got == want, level
        assert zt.uncompress(got, getattr(zt, fmt),
                             engine_name="native") == data
    text = "host engine text " * 500
    for src in (text, bytearray(text.encode()), memoryview(text.encode())):
        assert zt.compress(src, 6, getattr(zt, fmt), engine_name="native") \
            == zippy_tpu.compress(text.encode(), 6, getattr(zippy_tpu, fmt),
                                  engine_name="native")


def _streams():
    data, more = _data(), mixed_payload(50_000, 82)
    return {
        "gzip": (gzip.compress(data, 6), zt.dfGzip, data),
        "gzip two members": (gzip.compress(data) + native.gzip_compress(
            more, 1), zt.dfGzip, data + more),
        "gzip zero padding": (gzip.compress(data) + bytes(700), zt.dfGzip,
                              data),
        "gzip empty member": (gzip.compress(b"") + gzip.compress(more),
                              zt.dfGzip, more),
        "zlib": (zlib.compress(data, 9), zt.dfZlib, data),
        "zlib stored": (zlib.compress(random_bytes(70_000, 83), 0),
                        zt.dfZlib, random_bytes(70_000, 83)),
        "raw": (raw_deflate(data, 6), zt.dfDeflate, data),
        "raw fixed": (raw_deflate(data, 6, strategy=zlib.Z_FIXED),
                      zt.dfDeflate, data),
    }


def test_uncompress_native_equals_the_reference():
    for name, (blob, fmt, want) in _streams().items():
        ref_fmt = zippy_tpu.CompressedDataFormat(fmt.value)
        got = zt.uncompress(blob, fmt, engine_name="native")
        assert got == want, name
        assert got == zippy_tpu.uncompress(blob, ref_fmt,
                                           engine_name="native"), name
        if fmt is not zt.dfDeflate:
            assert zt.uncompress(blob, engine_name="native") == want, name
            assert zt.uncompress(bytearray(blob),
                                 engine_name="native") == want, name
    x = torch.from_numpy(np.frombuffer(zlib.compress(_data()),
                                       np.uint8).copy())
    assert zt.uncompress(x, engine_name="native") == _data()


def _corrupt():
    data = _data()
    g = gzip.compress(data)
    z = zlib.compress(data)
    crc = bytearray(g)
    crc[-5] ^= 0xFF
    isize = bytearray(g)
    isize[-1] ^= 0x01
    adler = bytearray(z)
    adler[-1] ^= 0x01
    return [
        (bytes(crc), zt.dfDetect, "Checksum verification failed"),
        (bytes(isize), zt.dfGzip, "Size verification failed"),
        (bytes(adler), zt.dfDetect, "Checksum verification failed"),
        (g + b"garbage!" * 4, zt.dfDetect,
         "Invalid gzip data (trailing garbage)"),
        (g[:-4], zt.dfGzip, None),
        (g[:len(g) // 2], zt.dfDetect, None),
        (z[:-2], zt.dfZlib, None),
        (b"\x78\xda" + b"\xff" * 30, zt.dfZlib, None),
        (b"\x78\x9c\x00", zt.dfDetect,
         "Unable to detect compressed data format"),
        (b"\x79\x9c" + b"\x00" * 10, zt.dfZlib,
         "Unsupported compression method"),
        (b"\x78\xbb" + b"\x00" * 10, zt.dfZlib,
         "Preset dictionary is not yet supported"),
        (b"not compressed at all, not at all", zt.dfDetect, None),
        (raw_deflate(data)[:-30], zt.dfDeflate, "Invalid compressed data"),
    ]


def test_corrupt_input_raises_as_the_reference_does():
    for blob, fmt, want in _corrupt():
        ref_fmt = zippy_tpu.CompressedDataFormat(fmt.value)
        msg = _same_error(
            lambda: zt.uncompress(blob, fmt, engine_name="native"),
            lambda: zippy_tpu.uncompress(blob, ref_fmt,
                                         engine_name="native"))
        if want is not None:
            assert msg == want, blob[:8]


def test_a_preset_dictionary_under_detection():
    """Detected as zlib, a stream with FDICT set raises on both sides: the
    port's message is the reference's explicit-zlib one, while the
    reference's one-call extension reports it as invalid data."""
    blob = b"\x78\xbb" + b"\x00" * 10
    with pytest.raises(zt.ZippyError,
                       match="Preset dictionary is not yet supported"):
        zt.uncompress(blob, engine_name="native")
    with pytest.raises(zippy_tpu.ZippyError):
        zippy_tpu.uncompress(blob, engine_name="native")


def test_read_member_uncompress_gzip_and_concat_members():
    data, more = _data(), mixed_payload(50_000, 84)
    first = gzip.compress(data, 6)
    second = native.gzip_compress(more, 9, 4)
    for tail in (b"", bytes(300)):
        blob = first + second + tail
        for trust in (False, True):
            assert gf.read_member(blob, 0, trust) \
                == rgf.read_member(blob, 0, trust) == (data, len(first))
            assert gf.read_member(blob, len(first), trust) \
                == rgf.read_member(blob, len(first), trust) \
                == (more, len(first) + len(second))
            assert gf.uncompress_gzip(blob, trust) \
                == rgf.uncompress_gzip(blob, trust) == data + more
        assert gf.concat_members(blob, [b"x"], len(first)) \
            == rgf.concat_members(blob, [b"x"], len(first)) == b"x" + more
        assert gf.concat_members(blob, [data], len(blob)) == data
    blob = first + second + b"trailing garbage bytes"
    for call in (lambda m: m.uncompress_gzip(blob),
                 lambda m: m.concat_members(blob, [], len(first))):
        assert _same_error(lambda: call(gf), lambda: call(rgf)) \
            == "Invalid gzip data (trailing garbage)"
    bad = bytearray(first)
    bad[-8] ^= 0xFF
    for call in (lambda m: m.read_member(bytes(bad)),
                 lambda m: m.uncompress_gzip(bytes(bad)),
                 lambda m: m.concat_members(second + bytes(bad), [],
                                            len(second))):
        assert _same_error(lambda: call(gf), lambda: call(rgf)) \
            == "Checksum verification failed"
    bad = bytearray(first)
    bad[-1] ^= 0x01
    assert _same_error(lambda: gf.read_member(bytes(bad)),
                       lambda: rgf.read_member(bytes(bad))) \
        == "Size verification failed"
    _same_error(lambda: gf.read_member(first[:-20]),
                lambda: rgf.read_member(first[:-20]))
    _same_error(lambda: gf.uncompress_gzip(b"\x1f\x8b"),
                lambda: rgf.uncompress_gzip(b"\x1f\x8b"))


def test_write_member_native(fixed_padding):
    data = _data()
    for kw in ({}, {"random_name_padding": False},
               {"extra": b"AB\x02\x00xy"},
               {"extra": b"", "random_name_padding": False}):
        got = gf.write_member(data, 6, engine_name="native", **kw)
        assert got == rgf.write_member(data, 6, engine_name="native", **kw)
        assert gzip.decompress(got) == data


def test_engine_routes():
    data = _data()[:30_000]
    blob = raw_deflate(data, 6) + b"after the stream"
    for hint in (None, len(data), 100):
        assert engine.inflate(blob, 0, hint, "native") \
            == reng.inflate(blob, 0, size_hint=hint, engine="native")
    assert engine.deflate(data, 6, "native") == reng.deflate(data, 6,
                                                             "native")
    assert engine.crc32(data, "native") == reng.crc32(data, "native") \
        == zlib.crc32(data)
    assert engine.adler32(data, "native") == reng.adler32(data, "native") \
        == zlib.adler32(data)
    with pytest.raises(zt.ZippyError, match="unknown engine"):
        engine.deflate(data, 6, "nativ")


def test_a_tensor_takes_the_device_path_under_native():
    data = _data()[:20_000]
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    want = td.deflate_array(x, 6)
    assert want != native.deflate(data, 6)
    assert engine.deflate(x, 6, "native") == want
    assert zt.compress(x, 6, zt.dfDeflate, engine_name="native") == want
    assert zt.compress(x, 6, zt.dfZlib, engine_name="native")[2:-4] == want
    assert engine.crc32(x, "native") == zlib.crc32(data)
    assert engine.adler32(x, "native") == zlib.adler32(data)
    g = gf.write_member(x, 6, engine_name="native",
                        random_name_padding=False)
    assert g[gf.parse_header(g)["data_offset"]:-8] == want


def test_device_available_and_is_device_array():
    assert engine.device_available() == torch.cuda.is_available()
    for host in (b"abc", bytearray(b"abc"), memoryview(b"abc"), "abc",
                 np.zeros(3, np.uint8)):
        assert engine.is_device_array(host) is False
        assert reng.is_device_array(host) is False
    assert engine.is_device_array(torch.zeros(3, dtype=torch.uint8))


def test_each_engine_decodes_the_others_streams():
    data = _data()[:40_000]
    for level in (-2, 0, 1, 6, 9):
        dev_raw = td.deflate(data, level, 4096, device="cpu")
        assert native.inflate(dev_raw)[0] == data, level
        assert zt.uncompress(dev_raw, zt.dfDeflate,
                             engine_name="native") == data
        host_raw = native.deflate(data, level)
        assert zt.uncompress(host_raw, zt.dfDeflate, device="cpu") == data
    dev_gz = zt.compress(data[:10_000], 6, device="cpu")
    assert zt.uncompress(dev_gz, engine_name="native") == data[:10_000]
    for fmt in (zt.dfGzip, zt.dfZlib):
        host = zt.compress(data, 6, fmt, engine_name="native")
        assert zt.uncompress(host, device="cpu") == data
        assert zt.uncompress(host, engine_name="device",
                             device="cpu") == data


def _indexes():
    text = _data()
    return {
        "dynamic": raw_deflate(text, 6),
        "small_blocks": raw_deflate(text, 9, mem_level=1),
        "stored": raw_deflate(random_bytes(70_000, 85) + text[:9000], 6),
        "host engine": native.deflate(text, 6),
        "empty": raw_deflate(b""),
    }


@pytest.mark.parametrize("name", sorted(_indexes()))
def test_index_sidecar_is_the_references(name):
    body = _indexes()[name]
    index = idev.build_decode_index(body)
    blob = gf.serialize_index(index)
    assert blob == rgf.serialize_index(ridev.build_decode_index(body))
    back = gf.deserialize_index(blob)
    for key, value in rgf.deserialize_index(blob).items():
        assert np.array_equal(np.asarray(back[key]), np.asarray(value)), key
    assert gf._sidecar_members(blob, "cpu") == rgf._sidecar_members(blob)
    for bad in (blob[:-3], blob + b"\x00"):
        with pytest.raises(zt.ZippyError, match="Invalid device index"):
            gf.deserialize_index(bad)


def test_indexed_streams_differ_only_in_their_data_members():
    """The reference writes compress_device_indexed's data members with its
    host codec, the port with the device encoder; each data member's
    sidecars are the same bytes given the same body."""
    data = _data()
    ref = rgf.compress_device_indexed(data, 6, member_size=50_000)
    pos, n_data = 0, 0
    while pos < len(ref):
        mlen = gf._indexed_member_length(ref, pos)
        member = ref[pos:pos + mlen]
        pos += mlen
        if gf._member_zx(member, 0) is not None:
            continue
        n_data += 1
        body = member[gf.parse_header(member)["data_offset"]:]
        side = gf._sidecar_members(gf.serialize_index(
            idev.build_decode_index(body)), "cpu")
        assert ref[pos:pos + len(side)] == side
    assert n_data == 3
    assert gf.uncompress_device(ref, device="cpu") == data
    assert gzip.decompress(ref) == data
