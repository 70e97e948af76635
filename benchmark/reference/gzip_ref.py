"""Plain reference for single gzip streams (RFC 1952, DEFLATE of RFC 1951),
on CPython's zlib alone: it makes the foreign streams a decode cell reads,
and judges the streams and bytes that the timed calls return. It imports
nothing of the program under test.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

FTEXT, FHCRC, FEXTRA, FNAME, FCOMMENT = 1, 2, 4, 8, 16


def compress(data: bytes, level: int) -> bytes:
    """One gzip member of `data` at zlib `level` (header MTIME 0)."""
    enc = zlib.compressobj(level, zlib.DEFLATED, 16 + 15)
    return enc.compress(data) + enc.flush()


def decode(blob: bytes) -> bytes:
    return zlib.decompress(blob, 16 + 15)


def _body_start(blob: bytes) -> int:
    """Where the DEFLATE body of a gzip member begins: the fixed header and
    the optional fields its FLG names. Raises ValueError on bad framing."""
    if len(blob) < 18:
        raise ValueError(f"{len(blob)} bytes is shorter than any gzip member")
    id1, id2, cm, flg = blob[0], blob[1], blob[2], blob[3]
    if (id1, id2) != (0x1F, 0x8B):
        raise ValueError("no gzip magic")
    if cm != 8:
        raise ValueError(f"compression method {cm}, not 8 (deflate)")
    if flg & 0xE0:
        raise ValueError("reserved FLG bits set")
    pos = 10
    if flg & FEXTRA:
        (xlen,) = struct.unpack_from("<H", blob, pos)
        pos += 2 + xlen
    for bit in (FNAME, FCOMMENT):
        if flg & bit:
            end = blob.index(b"\0", pos)
            pos = end + 1
    if flg & FHCRC:
        (hcrc,) = struct.unpack_from("<H", blob, pos)
        if hcrc != zlib.crc32(blob[:pos]) & 0xFFFF:
            raise ValueError("header crc16 does not match")
        pos += 2
    return pos


def member_problem(blob: bytes, data: bytes) -> str | None:
    """Why `blob` is not one whole gzip member of `data`, or None: framing,
    a DEFLATE body that inflates to exactly `data` and ends where the
    8-byte trailer begins, the trailer's CRC-32 and ISIZE."""
    try:
        pos = _body_start(blob)
    except ValueError as exc:
        return f"header: {exc}"
    dec = zlib.decompressobj(-15)
    try:
        out = dec.decompress(blob[pos:])
    except zlib.error as exc:
        return f"body: {exc}"
    if not dec.eof:
        return "body: the DEFLATE stream has no final block"
    if len(dec.unused_data) != 8:
        return f"trailer: {len(dec.unused_data)} bytes after the body, not 8"
    if len(out) != len(data) or out != data:
        return (f"body: inflates to {len(out)} bytes that are not the "
                f"{len(data)} compressed")
    crc, isize = struct.unpack("<II", dec.unused_data)
    if crc != zlib.crc32(data):
        return f"trailer: CRC-32 {crc:#010x}, not {zlib.crc32(data):#010x}"
    if isize != len(data) & 0xFFFFFFFF:
        return f"trailer: ISIZE {isize}, not {len(data) & 0xFFFFFFFF}"
    return None


def bytes_problem(out: bytes, data: bytes) -> str | None:
    """Why a decode's `out` is not `data`, or None."""
    if len(out) != len(data):
        return f"{len(out)} bytes, not {len(data)}"
    if out != data:
        diff = np.frombuffer(out, np.uint8) != np.frombuffer(data, np.uint8)
        return f"differs from byte {int(np.flatnonzero(diff)[0])}"
    return None
