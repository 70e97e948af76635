"""RFC 1952 gzip framing: the port of zippy_tpu.gzip_format's member writer,
header parser and device decode of every member.

Parity reference: zippy's src/zippy/gzip.nim and zippy.nim:22-58 (member
write with random-length FNAME anti-oracle padding,
https://github.com/guzba/zippy/issues/61). Like the reference, FEXTRA is
parsed and multi-member streams decode to the concatenation (CPython's
semantics).
"""

from __future__ import annotations

import os
import struct

from . import engine
from .common import ZippyError, as_u8_tensor

GZIP_MAGIC = b"\x1f\x8b"

FHCRC = 1 << 1
FEXTRA = 1 << 2
FNAME = 1 << 3
FCOMMENT = 1 << 4


def write_member(
    src,
    level: int,
    *,
    random_name_padding: bool = True,
    engine_name: str = "auto",
    device=None,
) -> bytes:
    """One gzip member: header + deflate stream + crc32/ISIZE trailer.

    The payload goes to the device once (a tensor stays where it is): the
    deflate body and the crc32 both run there; only the ~20 header and
    trailer bytes assemble on the host."""
    engine.check_engine(engine_name)
    x = as_u8_tensor(src, device)
    flg = 0
    fields = b""
    if random_name_padding:
        # Random-length (0-25 chars) FNAME defeats compressed-length oracles.
        flg |= FNAME
        npad = os.urandom(1)[0] % 26
        fields += bytes(97 + i for i in range(npad)) + b"\x00"
    header = struct.pack("<2sBBIBB", GZIP_MAGIC, 8, flg, 0, 0, 0)
    body = engine.deflate(x, level, engine_name)
    trailer = struct.pack("<II", engine.crc32(x, engine_name),
                          int(x.shape[0]) & 0xFFFFFFFF)
    return header + fields + body + trailer


def parse_header(src: bytes, pos: int = 0) -> dict:
    """Parse the member header at byte `pos`; "data_offset" is the absolute
    offset of its deflate stream."""
    if len(src) - pos < 18:
        raise ZippyError("Invalid gzip data")
    if src[pos : pos + 2] != GZIP_MAGIC:
        raise ZippyError("Failed gzip identification values check")
    cm = src[pos + 2]
    flg = src[pos + 3]
    if cm != 8:
        raise ZippyError("Unsupported compression method")
    if flg & 0b1110_0000:
        raise ZippyError("Reserved flag bits set")
    mtime = struct.unpack_from("<I", src, pos + 4)[0]
    p = pos + 10
    extra = None
    if flg & FEXTRA:
        if p + 2 > len(src):
            raise ZippyError("Invalid gzip data")
        xlen = struct.unpack_from("<H", src, p)[0]
        p += 2
        if p + xlen > len(src):
            raise ZippyError("Invalid gzip data")
        extra = src[p : p + xlen]
        p += xlen
    name = None
    if flg & FNAME:
        end = src.find(b"\x00", p)
        if end < 0:
            raise ZippyError("Invalid gzip data")
        name = src[p:end]
        p = end + 1
    comment = None
    if flg & FCOMMENT:
        end = src.find(b"\x00", p)
        if end < 0:
            raise ZippyError("Invalid gzip data")
        comment = src[p:end]
        p = end + 1
    if flg & FHCRC:
        if p + 2 >= len(src):
            raise ZippyError("Invalid gzip data")
        p += 2  # header crc not verified (reference gzip.nim:55-59 skips too)
    if p + 8 >= len(src):
        raise ZippyError("Invalid gzip data")
    return {
        "data_offset": p,
        "mtime": mtime,
        "extra": extra,
        "name": name,
        "comment": comment,
    }


def _is_zero_padding(src, pos: int) -> bool:
    """True if src[pos:] is empty or all NUL (tar tools pad archives),
    checked in chunks so the tail is never copied whole."""
    mv = memoryview(src)
    n = len(mv)
    zeros = bytes(4096)
    while pos < n:
        end = min(pos + 4096, n)
        if mv[pos:end] != zeros[: end - pos]:
            return False
        pos = end
    return True


def member_indexes(src: bytes) -> list:
    """[(byte offset, decode index)] of every member of a gzip stream, up to
    its end or to trailing zero padding. Each member is scanned in place, at
    its bit offset in `src`, so no member's tail is copied."""
    from .ops import inflate_device as idev

    out = []
    pos = 0
    while pos < len(src):
        if _is_zero_padding(src, pos):
            break
        hdr = parse_header(src, pos)
        index = idev.build_decode_index(src, hdr["data_offset"] * 8)
        out.append((pos, index))
        pos = (int(index["end_bit"]) + 7) // 8 + 8
    if not out:
        raise ZippyError("Invalid gzip data")
    return out


def uncompress_gzip_device_all(src: bytes, device=None,
                               indexes=None) -> bytes:
    """Decode every member of a gzip stream on the card and concatenate
    them. `indexes` is the result of member_indexes (walked here when
    omitted)."""
    from .ops import inflate_device as idev

    if indexes is None:
        indexes = member_indexes(src)
    return b"".join(idev.uncompress_gzip_device(src, index, device, pos)
                    for pos, index in indexes)
