"""zippy_tpu_torch's public uncompress() on the CPU: byte for byte against
CPython and zippy_tpu.uncompress(engine_name="device"), and the same
ZippyError on corrupt input."""

import gzip
import random
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zippy_tpu  # noqa: E402
from zippy_tpu import native  # noqa: E402
import zippy_tpu_torch as zt  # noqa: E402
from zippy_tpu_torch.ops import inflate_device as port  # noqa: E402
from _torch_parity import (  # noqa: E402,F401
    DEEP_CHAINS, mixed_payload, one_thread, random_bytes, raw_deflate)

pytestmark = pytest.mark.usefixtures("one_thread")

TEXT = mixed_payload(60_000, 51)
MORE = mixed_payload(45_000, 52)
BIG = mixed_payload(3 * port.CFG_S.tile_out + 999, 53)

CASES = {
    # name: (blob, format, what CPython decodes it to)
    "gzip_two_members": lambda: (
        gzip.compress(TEXT, 6) + gzip.compress(MORE, 9), zt.dfGzip,
        TEXT + MORE),
    "gzip_zero_padding": lambda: (gzip.compress(TEXT) + bytes(1000),
                                  zt.dfGzip, TEXT),
    "gzip_empty_member": lambda: (gzip.compress(b"") + gzip.compress(MORE),
                                  zt.dfGzip, MORE),
    "gzip_port_member": lambda: (zt.compress(MORE, 6, zt.dfGzip,
                                             device="cpu"), zt.dfGzip, MORE),
    "zlib": lambda: (zlib.compress(TEXT, 6), zt.dfZlib, TEXT),
    "raw": lambda: (raw_deflate(TEXT, 9), zt.dfDeflate, TEXT),
    "stored": lambda: (zlib.compress(random_bytes(200_000, 54) + TEXT, 0),
                       zt.dfZlib, random_bytes(200_000, 54) + TEXT),
    "three_tiles": lambda: (gzip.compress(BIG, 6), zt.dfGzip, BIG),
    "deep_chains": lambda: (zlib.compress(DEEP_CHAINS, 1), zt.dfZlib,
                            DEEP_CHAINS),
    "fixed": lambda: (raw_deflate(TEXT, 6, strategy=zlib.Z_FIXED),
                      zt.dfDeflate, TEXT),
}


def _ref_format(fmt):
    """The reference's own enum member for one of the port's formats."""
    return zippy_tpu.CompressedDataFormat(fmt.value)


@pytest.mark.parametrize("name", sorted(CASES))
def test_uncompress_equals_cpython_and_reference(name):
    blob, fmt, want = CASES[name]()
    got = zt.uncompress(blob, fmt, device="cpu")
    assert got == want
    assert got == zippy_tpu.uncompress(blob, _ref_format(fmt),
                                       engine_name="device")
    if fmt is not zt.dfDeflate:
        assert zt.uncompress(blob, device="cpu") == want        # dfDetect
    if name == "three_tiles":
        index = port.build_decode_index(blob, 80)
        assert len(port._plan_tiles(index, port.CFG_S)) >= 3


def test_index_used_twice():
    blob = raw_deflate(BIG, 6)
    index = port.build_decode_index(blob)
    assert port.inflate_device(blob, index, device="cpu") == BIG
    assert port.inflate_device(blob, index, device="cpu") == BIG
    buf, total = port.inflate_device_array(blob, index, device="cpu")
    assert total == len(BIG) and buf.dtype == torch.uint8
    assert buf.numpy().tobytes() == BIG


def test_stages_and_empty_stream():
    stages = {}
    blob = raw_deflate(TEXT, 6)
    assert port.inflate_device(blob, device="cpu", stages=stages) == TEXT
    assert set(stages) == {"scan", "plan_pack", "upload", "tables", "extract",
                           "resolve", "checksums", "fetch"}
    buf, total = port.inflate_device_array(raw_deflate(b""), device="cpu")
    assert total == 0 and buf.shape == (0,) and buf.dtype == torch.uint8
    assert zt.uncompress(gzip.compress(b""), device="cpu") == b""
    assert zt.uncompress(zlib.compress(b""), device="cpu") == b""


def test_inputs_and_engines():
    blob = zlib.compress(TEXT)
    x = torch.from_numpy(np.frombuffer(blob, np.uint8).copy())
    assert zt.uncompress(x, device="cpu") == TEXT
    assert zt.uncompress(bytearray(blob), device="cpu") == TEXT
    assert zt.uncompress(memoryview(blob), engine_name="device",
                         device="cpu") == TEXT
    assert zt.uncompress(blob, engine_name="native", device="cpu") == TEXT
    with pytest.raises(zt.ZippyError):
        zt.uncompress(blob, engine_name="devcie", device="cpu")
    with pytest.raises(TypeError):
        zt.uncompress(12345, device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(zt.ZippyError):
        zt.uncompress(zlib.compress(b"abc"))


def _both_raise(blob, fmt=zt.dfDetect):
    with pytest.raises(zt.ZippyError):
        zt.uncompress(blob, fmt, device="cpu")
    with pytest.raises(zippy_tpu.ZippyError):
        zippy_tpu.uncompress(blob, _ref_format(fmt), engine_name="device")


def test_malformed_input_raises_as_the_reference_does():
    g = bytearray(gzip.compress(TEXT))
    g[-5] ^= 0xFF                                   # the crc32 trailer
    _both_raise(bytes(g))
    g = bytearray(gzip.compress(TEXT))
    g[-1] ^= 0x01                                   # ISIZE
    _both_raise(bytes(g))
    z = bytearray(zlib.compress(TEXT))
    z[-1] ^= 0x01                                   # the adler32 trailer
    _both_raise(bytes(z))
    _both_raise(gzip.compress(TEXT) + b"garbage!" * 4)
    _both_raise(gzip.compress(TEXT)[:-4], zt.dfGzip)
    _both_raise(zlib.compress(TEXT)[:-2], zt.dfZlib)
    _both_raise(b"\x78\xda" + b"\xff" * 30, zt.dfZlib)  # zlib header, bad body
    _both_raise(b"\x78\x9c\x00")                     # too short to detect
    _both_raise(b"\x79\x9c" + b"\x00" * 10, zt.dfZlib)  # method 9
    _both_raise(b"\x78\xbb" + b"\x00" * 10, zt.dfZlib)  # preset dictionary
    _both_raise(b"not compressed at all, not at all")


def _early_member() -> bytes:
    """One gzip member whose DEFLATE body ends after 20,000 of the 45,000
    bytes its trailer counts; the bytes after that trailer parse as a next
    member's header, whose body holds a reserved block type."""
    hdr = bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 0, 0xFF])
    return (hdr + raw_deflate(MORE[:20_000], 6)
            + struct.pack("<II", zlib.crc32(MORE), len(MORE))
            + hdr + b"\x07" + bytes(24))


def _bad_crc_then_bad_magic() -> bytes:
    """Two members: the first's CRC flipped, the second's magic broken."""
    a = gzip.compress(TEXT)
    blob = bytearray(a + gzip.compress(MORE))
    blob[len(a) - 8] ^= 0xFF
    blob[len(a) + 1] ^= 0xFF
    return bytes(blob)


@pytest.mark.parametrize("make", [_bad_crc_then_bad_magic, _early_member])
def test_an_earlier_members_error_wins(make):
    """As the reference decodes and verifies a member before it parses the
    next, an earlier member's checksum failure is reported before a later
    member's header or scan error."""
    blob = make()
    with pytest.raises(zippy_tpu.ZippyError) as ref_err:
        zippy_tpu.uncompress(blob, engine_name="device")
    with pytest.raises(zt.ZippyError) as err:
        zt.uncompress(blob, device="cpu")
    assert str(ref_err.value) == "Checksum verification failed"
    assert str(err.value) == str(ref_err.value)
    with pytest.raises(gzip.BadGzipFile, match="CRC check failed"):
        gzip.decompress(blob)


def test_tampered_index_adler_trips_the_gate():
    blob = raw_deflate(TEXT, 6)
    index = dict(port.build_decode_index(blob))
    index["adler"] ^= 0x1234
    with pytest.raises(zt.ZippyError):
        port.inflate_device(blob, index, device="cpu")
    # Without the gate the bytes still come back.
    assert port.inflate_device(blob, index, verify=False,
                               device="cpu") == TEXT


def test_corrupt_streams_raise_or_decode_as_the_serial_decode():
    """Bit flips and truncations over several tiles: ZippyError, or the
    bytes of the serial decode (and of CPython where it accepts the
    stream); never another exception, never other bytes."""
    rng = random.Random(13)
    data = mixed_payload(2 * port.CFG_S.tile_out + 5000, 55)
    blob = raw_deflate(data, 6)
    decoded = 0
    for i in range(24):
        b = bytearray(blob)
        if i % 3 == 2:
            b = b[:rng.randrange(len(b) // 2, len(b))]
        else:
            b[rng.randrange(16, len(b))] ^= 1 << rng.randrange(8)
        b = bytes(b)
        try:
            out = port.inflate_device(b, device="cpu")
        except zt.ZippyError:
            continue
        host, _ = native.inflate(b)
        assert out == host
        try:
            assert out == zlib.decompress(b, wbits=-15)
        except zlib.error:
            pass
        decoded += 1
    assert decoded > 0
