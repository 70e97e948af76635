"""zippy_tpu_torch.native, the port's copy of the C++ host codec, held
against zippy_tpu.native in one process: the same streams byte for byte at
every level, the same payloads and end bits on decode, the same ZippyError
messages on corrupt input, the same checksums; the intents of
tests/test_native_paths.py on synthetic data; and the library's build."""

import functools
import gzip
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import zippy_tpu.native as rn  # noqa: E402
from zippy_tpu.common import ZippyError as RefError  # noqa: E402
from zippy_tpu.native import build as rbuild  # noqa: E402
from zippy_tpu_torch import native as pn  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import kernel_build as kb  # noqa: E402
from _torch_parity import mixed_payload, random_bytes  # noqa: E402

LEVELS = list(range(-2, 10))


@functools.cache
def _mixed() -> bytes:
    return mixed_payload(1 << 20, 71)


@functools.cache
def _text_and_noise() -> bytes:
    """test_mt_multipart_stored_alignment's case: 5 MiB of text, then
    5 MiB of noise (the encoder's multi-part path)."""
    text = (b"compressible text payload " * 300000)[:5 << 20]
    return text + random_bytes(5 << 20, 0)


@functools.cache
def _urls(n: int) -> bytes:
    """URL lines from a seeded vocabulary, the shape of the corpus's
    urls.10K."""
    rng = np.random.default_rng(72)
    hosts = [f"www.{w}.{t}".encode() for w, t in zip(
        ("example", "zippy", "deflate", "archive", "mirror", "static",
         "cdn", "news"), ("com", "org", "net", "io", "com", "org", "net",
                          "de"))]
    words = [bytes(rng.integers(97, 123, int(k)).astype(np.uint8))
             for k in rng.integers(3, 12, 400)]
    lines, size = [], 0
    while size < n:
        path = b"/".join(words[int(i)] for i in rng.integers(
            0, len(words), int(rng.integers(1, 6))))
        line = b"http://" + hosts[int(rng.integers(0, len(hosts)))] + b"/" \
            + path + b".html\n"
        lines.append(line)
        size += len(line)
    return b"".join(lines)[:n]


def _sizes():
    mixed = _mixed()
    return {"0 B": b"", "1 B": mixed[:1], "64 KiB": mixed[:1 << 16],
            "1 MiB": mixed, "text then noise": _text_and_noise()}


def _same_error(port_call, ref_call) -> str:
    with pytest.raises(ZippyError) as got:
        port_call()
    with pytest.raises(RefError) as want:
        ref_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("level", LEVELS)
def test_deflate_is_byte_identical(level):
    for name, data in _sizes().items():
        got = pn.deflate(data, level)
        assert got == rn.deflate(data, level), name
        assert zlib.decompress(got, -15) == data, name


@pytest.mark.parametrize("name_pad", [-1, 0, 7, 25])
def test_gzip_compress_is_byte_identical(name_pad):
    data = _mixed()[:300_000]
    for level in (-2, -1, 0, 1, 6, 9):
        got = pn.gzip_compress(data, level, name_pad)
        assert got == rn.gzip_compress(data, level, name_pad), level
        assert gzip.decompress(got) == data
    assert pn.gzip_compress(data, 6) == rn.gzip_compress(data, 6)


@pytest.mark.parametrize("level", LEVELS)
def test_zlib_compress_is_byte_identical(level):
    data = _mixed()[:200_000]
    got = pn.zlib_compress(data, level)
    assert got == rn.zlib_compress(data, level)
    assert zlib.decompress(got) == data
    assert pn.zlib_compress(b"", level) == rn.zlib_compress(b"", level)


def _shifted(raw: bytes, lead_bits: int, prefix: bytes,
             trailer: bytes) -> bytes:
    """`raw` starting `lead_bits` bits into the byte after `prefix`, the
    bits before it set, and `trailer` after its last byte."""
    val = (int.from_bytes(raw, "little") << lead_bits) | ((1 << lead_bits) - 1)
    body = val.to_bytes(len(raw) + 1, "little")
    return prefix + body + trailer


def test_inflate_start_bit_and_trailing_bytes():
    data = _mixed()[:150_000]
    raw = pn.deflate(data, 6)
    for lead in (0, 3, 7):
        blob = _shifted(raw, lead, b"\xa5" * 5, b"trailing bytes" * 3)
        start = 5 * 8 + lead
        got = pn.inflate(blob, start)
        assert got == rn.inflate(blob, start)
        assert got[0] == data
        assert (got[1] - start + 7) // 8 == len(raw)
        for hint in (len(data), 10, 0):      # exact, too small: growth
            assert pn.inflate(blob, start, size_hint=hint) == got
            assert rn.inflate(blob, start, size_hint=hint) == got
    msg = _same_error(lambda: pn.inflate(raw, 0, max_output=1000),
                      lambda: rn.inflate(raw, 0, max_output=1000))
    assert msg == "Uncompressed data too large"
    assert pn.inflate(raw, 0, max_output=len(data)) == rn.inflate(
        raw, 0, max_output=len(data))
    _same_error(lambda: pn.inflate(raw[:-40]), lambda: rn.inflate(raw[:-40]))
    _same_error(lambda: pn.inflate(b""), lambda: rn.inflate(b""))


def test_gzip_uncompress_at_a_later_member():
    a, b = _mixed()[:70_000], _mixed()[70_000:150_000]
    first = rn.gzip_compress(a, 6, 3)
    blob = first + pn.gzip_compress(b, 9) + bytes(16)
    assert pn.gzip_uncompress(blob) == rn.gzip_uncompress(blob) \
        == (a, len(first))
    got = pn.gzip_uncompress(bytearray(blob), len(first))
    assert got == rn.gzip_uncompress(blob, len(first))
    assert got[0] == b and got[1] == len(blob) - len(first) - 16
    for pos in (len(blob) - 10, len(blob) + 1, -1):
        assert _same_error(lambda: pn.gzip_uncompress(blob, pos),
                           lambda: rn.gzip_uncompress(blob, pos)) \
            == "Invalid gzip data"


def test_corrupt_input_gives_the_same_errors():
    data = _mixed()[:90_000]
    g = bytearray(pn.gzip_compress(data, 6))
    z = bytearray(pn.zlib_compress(data, 6))
    cases = []
    crc = bytearray(g)
    crc[-6] ^= 0xFF
    cases.append(("gzip", bytes(crc), "Checksum verification failed"))
    isize = bytearray(g)
    isize[-1] ^= 0x01
    cases.append(("gzip", bytes(isize), "Size verification failed"))
    cases.append(("gzip", bytes(g[:len(g) // 2]), None))
    cases.append(("gzip", b"\x1f\x8b\x09" + bytes(g[3:]), None))
    adler = bytearray(z)
    adler[-1] ^= 0xFF
    cases.append(("zlib", bytes(adler), "Checksum verification failed"))
    cases.append(("zlib", bytes(z[:len(z) // 2]), None))
    cases.append(("zlib", b"\x78\xbb" + bytes(z[2:]), None))   # FDICT
    cases.append(("zlib", b"\x78\x9c", "Invalid compressed data"))
    for fmt, blob, want in cases:
        if fmt == "gzip":
            msg = _same_error(lambda: pn.gzip_uncompress(blob),
                              lambda: rn.gzip_uncompress(blob))
        else:
            msg = _same_error(lambda: pn.zlib_uncompress(blob),
                              lambda: rn.zlib_uncompress(blob))
        if want is not None:
            assert msg == want
    assert pn.zlib_uncompress(bytes(z)) == rn.zlib_uncompress(bytes(z)) \
        == data
    assert pn.zlib_uncompress(zlib.compress(data, 9)) == data


def test_checksums():
    data = _mixed()[:200_000]
    for chunk in (b"", data[:1], data[:4095], data[:4096], data):
        for fn, ref, lib, init in ((pn.crc32, rn.crc32, zlib.crc32, 0),
                                   (pn.adler32, rn.adler32, zlib.adler32,
                                    1)):
            assert fn(chunk) == ref(chunk) == lib(chunk)
            for value in (init, 12345, 0xFFF0FFF0):
                assert fn(chunk, value) == ref(chunk, value) \
                    == lib(chunk, value)
            assert fn(memoryview(chunk)) == fn(bytearray(chunk)) \
                == lib(chunk)
    assert pn.deflate_bound(12345) == rn._lib().zt_deflate_bound(12345)


@pytest.mark.parametrize("level", [-3, 10, 11])
def test_encoders_refuse_a_level_outside_the_table(level):
    """The library's table of levels holds -2..9: the port's wrappers refuse
    any other level before the call (zippy_tpu.native passes it on)."""
    data = _mixed()[:100_000]
    for encode in (pn.deflate, pn.zlib_compress, pn.gzip_compress):
        with pytest.raises(ZippyError, match="Invalid compression level"):
            encode(data, level)


@pytest.mark.parametrize("level", [-2, -1, 1, 6, 9])
def test_spliced_stream_has_no_slack_bytes(level):
    """test_native_paths::test_mt_deflate_splice on synthetic URL lines:
    the stream decodes and ends with no bytes after its final block, at
    1 MiB (shared planning) and 6 MiB (parts spliced)."""
    for n in (1 << 20, 6 << 20):
        data = _urls(n)
        blob = pn.deflate(data, level)
        assert blob == rn.deflate(data, level)
        d = zlib.decompressobj(-15)
        assert d.decompress(blob) == data
        assert d.eof and d.unused_data == b""


def test_isize_trailer_alignment():
    """test_native_paths::test_mt_deflate_isize_trailer_alignment on
    synthetic URL lines: CPython reads the trailer of a spliced member."""
    data = _urls(6 << 20)
    for level in (-1, 6):
        blob = pn.gzip_compress(data, level)
        assert blob == rn.gzip_compress(data, level)
        assert gzip.decompress(blob) == data


def test_deflate_bound_covers_huffman_only():
    data = random_bytes(1 << 20, 73)
    blob = pn.deflate(data, -2)
    assert len(blob) <= pn.deflate_bound(len(data))
    assert zlib.decompress(blob, -15) == data


def test_stride2_structured_data_compresses():
    """Random high bytes and alphabetic low bytes must compress below
    stored and within 2% of zlib level 6 at levels 1, 6 and 9."""
    rng = np.random.default_rng(42)
    n = 1 << 20
    buf = np.empty(n, dtype=np.uint8)
    buf[0::2] = rng.integers(0, 256, n // 2, dtype=np.uint8)
    buf[1::2] = rng.integers(97, 97 + 26, n // 2, dtype=np.uint8)
    data = buf.tobytes()
    zref = len(zlib.compress(data, 6))
    for level in (1, 6, 9):
        out = pn.deflate(data, level)
        assert out == rn.deflate(data, level)
        assert len(out) < n and len(out) <= zref * 1.02, (level, len(out))
        assert pn.inflate(out)[0] == data


def test_calls_run_on_threads():
    """The engine releases the GIL: calls on a pool give the serial
    results."""
    data = _mixed()
    pieces = [data[i:i + (1 << 17)] for i in range(0, len(data), 1 << 17)]
    with ThreadPoolExecutor(4) as ex:
        blobs = list(ex.map(lambda p: pn.deflate(p, 6), pieces))
        back = list(ex.map(lambda b: pn.inflate(b)[0], blobs))
    assert blobs == [rn.deflate(p, 6) for p in pieces]
    assert back == pieces


def test_build_takes_the_reference_flags_and_keys_by_them(monkeypatch,
                                                          tmp_path):
    src = kb.CSRC / "zippy_native.cpp"
    cmd = kb._command(src, tmp_path / "lib.so")
    for flag in rbuild.CXXFLAGS:
        assert flag in cmd, flag
    assert kb.HOST_SOURCES == ("zippy_native.cpp",)
    lib = kb.library_path("zippy_native.cpp")
    assert lib.parent == kb.BUILD_DIR
    monkeypatch.setattr(kb, "cpu_identity", lambda: "another cpu")
    assert kb.library_path("zippy_native.cpp") != lib
    monkeypatch.undo()
    monkeypatch.setattr(kb, "HOST_FLAGS", tuple(
        f for f in kb.HOST_FLAGS if f != "-O3") + ("-O2",))
    assert kb.library_path("zippy_native.cpp") != lib
    assert kb.cpu_identity()


def _code(text: str) -> list[str]:
    """The lines of C++ `text` with comments and blank lines dropped."""
    lines = (line.split("//", 1)[0].rstrip() for line in text.splitlines())
    return [line for line in lines if line]


def _without_scan(text: str) -> str:
    """`text` less the scan's body, inflate_scan_impl."""
    at = text.index("int64_t inflate_scan_impl(")
    return text[:at] + text[text.index("\n}\n", at) + 3:]


def test_the_copy_keeps_the_reference_codec():
    """csrc/zippy_native.cpp's code is the reference's, line for line once
    comments are dropped, apart from the includes of <cstdio> and <memory>
    and the scan's body, inflate_scan_impl, whose outputs
    tests/test_torch_inflate_scan.py holds to the reference's scan; no
    module of the port binds a CPython extension."""
    port = (kb.CSRC / "zippy_native.cpp").read_text()
    ref = (rbuild._SRC).read_text()
    code = _code(_without_scan(port))
    assert code[:2] == ["#include <cstdio>", "#include <memory>"]
    assert code[2:] == _code(_without_scan(ref))
    assert "zt_inflate_scan(" in port and "inflate_scan_impl(" in port
    for path in list(kb.CSRC.iterdir()) + list(
            kb.CSRC.parent.rglob("*.py")):
        text = path.read_text()
        for word in ("Python.h", "PyInit_", "spec_from_file_location",
                     "_pyzt"):
            assert word not in text, (path, word)


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch,
                                                          tmp_path):
    """If the host engine does not build, "native" raises ZippyError with
    the compiler's output and never runs another engine instead."""
    import zippy_tpu_torch as zt

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "zippy_native.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(kb, "CSRC", csrc)
    monkeypatch.setattr(kb, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(pn, "_lib", functools.cache(pn._lib.__wrapped__))
    with pytest.raises(ZippyError, match="build failed") as err:
        pn.deflate(b"abc", 6)
    assert "zippy_native.cpp" in str(err.value)
    assert "error" in str(err.value)
    for call in (lambda: zt.compress(b"abc", 6, engine_name="native"),
                 lambda: zt.compress(b"abc", 6, zt.dfZlib,
                                     engine_name="native", device="cpu"),
                 lambda: zt.uncompress(gzip.compress(b"abc"),
                                       engine_name="native", device="cpu")):
        with pytest.raises(ZippyError, match="build failed"):
            call()
    assert not list((tmp_path / "kernels").glob("*.so"))
    assert os.path.exists(tmp_path / "kernels")
