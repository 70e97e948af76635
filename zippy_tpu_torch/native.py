"""The port's host engine: its own copy of zippy_tpu's C++ host codec
(csrc/zippy_native.cpp) through ctypes.

It encodes and decodes raw DEFLATE, whole gzip members and zlib streams, and
computes crc32 and adler32, on the host CPU; the same library holds the
device decode's host scan (ops/inflate_scan.py). The library is built with
the host C++ compiler at first use, with zippy_tpu's own flags
(ops/kernel_build.py), into build/kernels/. Its streams are byte-identical
to zippy_tpu.native's, and each call gives zippy_tpu.native's payloads and
ZippyError messages. A ctypes call releases the GIL, so callers may run the
engine on threads.

Inputs are bytes, bytearray, memoryview or anything else that exposes a
buffer of bytes; they are read in place, never copied. The encoders refuse
a level outside -2..9 with ZippyError, before the library reads its table
of levels (zippy_tpu.native passes such a level on, and the library reads
past that table). Above 4 MiB (and at
level -2 above 32 KiB) the encoder splits its input over the host's cores,
so its bytes depend on their number.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from .common import ZippyError, check_level
from .ops import kernel_build

_ERR_MALFORMED = -1
_ERR_DST_FULL = -2
_ERR_CHECKSUM = -3
_ERR_SIZE = -4

_ERR_MESSAGES = {
    _ERR_MALFORMED: "Invalid compressed data",
    _ERR_CHECKSUM: "Checksum verification failed",
    _ERR_SIZE: "Size verification failed",
}

# DEFLATE expands at most 1032:1; the ISIZE hint is capped by that bound so
# that a lying trailer cannot force a huge allocation.
_MAX_EXPANSION = 1032


@functools.cache
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(str(kernel_build.build("zippy_native.cpp")))
    except OSError as e:
        raise ZippyError(f"cannot load the host engine: {e}") from e
    p, sz, i32 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
    u32, i64 = ctypes.c_uint32, ctypes.c_int64
    psz = ctypes.POINTER(ctypes.c_size_t)
    for name, restype, argtypes in (
            ("zt_crc32_update", u32, [u32, p, sz]),
            ("zt_adler32_update", u32, [u32, p, sz]),
            ("zt_inflate", i64, [p, sz, sz, p, sz, psz]),
            ("zt_deflate", i64, [p, sz, i32, p, sz]),
            ("zt_deflate_bound", sz, [sz]),
            ("zt_gzip_uncompress", i64, [p, sz, p, sz, psz]),
            ("zt_gzip_compress", i64, [p, sz, i32, p, sz, i32]),
            ("zt_zlib_uncompress", i64, [p, sz, p, sz]),
            ("zt_zlib_compress", i64, [p, sz, i32, p, sz]),
            ("zt_inflate_scan", i64, [ctypes.c_char_p, sz, sz, u32, p, sz,
                                      p, sz, p, sz, p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _view(data) -> np.ndarray:
    """The input's bytes as a uint8 array over the same memory."""
    return np.frombuffer(data, dtype=np.uint8)


def _grow_capped(cap: int, max_out: int | None) -> int:
    """The next output size: double (at least 64 KiB), clamped to max_out;
    ZippyError once max_out is reached."""
    cap = max(cap * 2, 1 << 16)
    if max_out is not None and cap > max_out:
        if cap // 2 >= max_out:
            raise ZippyError("Uncompressed data too large")
        cap = max_out
    return cap


def crc32(data, value: int = 0) -> int:
    """CRC-32 of `data`, continuing from `value`."""
    src = _view(data)
    return _lib().zt_crc32_update(value & 0xFFFFFFFF, src.ctypes.data,
                                  src.size)


def adler32(data, value: int = 1) -> int:
    """Adler-32 of `data`, continuing from `value`."""
    src = _view(data)
    return _lib().zt_adler32_update(value & 0xFFFFFFFF, src.ctypes.data,
                                    src.size)


def deflate_bound(n: int) -> int:
    """The most bytes that deflate() of `n` bytes writes, at any level."""
    return int(_lib().zt_deflate_bound(n))


def inflate(
    data,
    start_bit: int = 0,
    size_hint: int | None = None,
    max_output: int | None = None,
) -> tuple[bytes, int]:
    """Decode the raw DEFLATE stream that starts at bit `start_bit` of
    `data`. Returns (payload, end_bit), end_bit being the bit just past its
    final block; bytes after it are not read.

    `size_hint` sizes the output exactly (the gzip ISIZE trust_size path);
    otherwise, or when it is wrong, the output grows by retry, up to
    `max_output` bytes."""
    lib = _lib()
    src = _view(data)
    if start_bit < 0:
        raise ZippyError("Invalid compressed data")
    cap = size_hint if size_hint is not None else max(4 * src.size, 1 << 16)
    end_bit = ctypes.c_size_t(0)
    while True:
        out = np.empty(cap, np.uint8)
        rc = lib.zt_inflate(src.ctypes.data, src.size, start_bit,
                            out.ctypes.data, cap, ctypes.byref(end_bit))
        if rc >= 0:
            return out[:rc].tobytes(), end_bit.value
        if rc != _ERR_DST_FULL:
            raise ZippyError("Invalid compressed data")
        cap = _grow_capped(cap, max_output)


def deflate(data, level: int) -> bytes:
    """`data` as one raw DEFLATE stream at `level`."""
    check_level(level)
    lib = _lib()
    src = _view(data)
    cap = lib.zt_deflate_bound(src.size)
    out = np.empty(cap, np.uint8)
    rc = lib.zt_deflate(src.ctypes.data, src.size, level, out.ctypes.data,
                        cap)
    if rc < 0:
        raise ZippyError("deflate failed")
    return out[:rc].tobytes()


def gzip_uncompress(data, pos: int = 0) -> tuple[bytes, int]:
    """Decode the one gzip member that starts at byte `pos` of `data`
    (header, inflate, crc32 and ISIZE checks in one call). Returns
    (payload, bytes of `data` the member took)."""
    lib = _lib()
    src = _view(data)
    if pos < 0 or pos > src.size:
        raise ZippyError("Invalid gzip data")
    src = src[pos:]
    n = src.size
    if n < 18:
        raise ZippyError("Invalid gzip data")
    # The last ISIZE of the stream sizes the output, within the expansion
    # bound (zippy's gzip.nim trustSize).
    isize = int.from_bytes(src[-4:].tobytes(), "little")
    max_out = n * _MAX_EXPANSION + 4096
    cap = min(max(isize + 64, 1 << 12), max_out)
    consumed = ctypes.c_size_t(0)
    while True:
        out = np.empty(cap, np.uint8)
        rc = lib.zt_gzip_uncompress(src.ctypes.data, n, out.ctypes.data, cap,
                                    ctypes.byref(consumed))
        if rc >= 0:
            return out[:rc].tobytes(), consumed.value
        if rc != _ERR_DST_FULL:
            raise ZippyError(_ERR_MESSAGES.get(rc, "Invalid gzip data"))
        cap = _grow_capped(cap, max_out)


def gzip_compress(data, level: int, name_pad: int = -1) -> bytes:
    """One whole gzip member of `data` at `level`. name_pad >= 0 adds an
    FNAME of that many filler characters (the anti-oracle padding); -1
    writes none."""
    check_level(level)
    lib = _lib()
    src = _view(data)
    cap = lib.zt_deflate_bound(src.size) + 64
    out = np.empty(cap, np.uint8)
    rc = lib.zt_gzip_compress(src.ctypes.data, src.size, level,
                              out.ctypes.data, cap, name_pad)
    if rc < 0:
        raise ZippyError("gzip compress failed")
    return out[:rc].tobytes()


def zlib_uncompress(data) -> bytes:
    """Decode one zlib stream (header checks, inflate and adler32 check in
    one call)."""
    lib = _lib()
    src = _view(data)
    n = src.size
    if n < 6:
        raise ZippyError("Invalid compressed data")
    max_out = n * _MAX_EXPANSION + 4096
    cap = min(max(8 * n, 1 << 16), max_out)
    while True:
        out = np.empty(cap, np.uint8)
        rc = lib.zt_zlib_uncompress(src.ctypes.data, n, out.ctypes.data, cap)
        if rc >= 0:
            return out[:rc].tobytes()
        if rc != _ERR_DST_FULL:
            raise ZippyError(_ERR_MESSAGES.get(rc, "Invalid compressed data"))
        cap = _grow_capped(cap, max_out)


def zlib_compress(data, level: int) -> bytes:
    """One zlib stream of `data` at `level`."""
    check_level(level)
    lib = _lib()
    src = _view(data)
    cap = lib.zt_deflate_bound(src.size) + 16
    out = np.empty(cap, np.uint8)
    rc = lib.zt_zlib_compress(src.ctypes.data, src.size, level,
                              out.ctypes.data, cap)
    if rc < 0:
        raise ZippyError("zlib compress failed")
    return out[:rc].tobytes()
