"""Plain reference for indexed gzip streams: standard RFC 1952 members, each
carrying its total length in a 'ZT' FEXTRA subfield, each data member
followed by empty-payload sidecar members whose 'ZX' subfields carry its
decode index, raw-deflated. On CPython's gzip, zlib and struct alone: it
decodes such a stream as any gzip reader does (the sidecars decode to
nothing) and walks its framing with plain code. It imports nothing of the
program under test.
"""

from __future__ import annotations

import gzip
import struct
import zlib

FHCRC, FEXTRA, FNAME, FCOMMENT = 2, 4, 8, 16
ZT, ZX = b"ZT", b"ZX"
INDEX_MAGIC = b"ZTI1"
# After the magic: every (u2), segment, stored and block counts (u4 each),
# the member's output length (u8), ...
TOTAL_OUT_AT = len(INDEX_MAGIC) + 2 + 3 * 4


def decode(blob: bytes) -> bytes:
    """Every member's payload, concatenated (CPython's reading)."""
    return gzip.decompress(blob)


def _member(blob: bytes, pos: int) -> tuple[int, bytes | None]:
    """(ZT length, ZX payload or None) of the member at byte `pos`; raises
    ValueError where its header or its ZT length is not sound."""
    if len(blob) - pos < 18:
        raise ValueError(f"{len(blob) - pos} bytes at {pos}, less than a "
                         "gzip member")
    if blob[pos:pos + 2] != b"\x1f\x8b" or blob[pos + 2] != 8:
        raise ValueError(f"no gzip member (deflate) at byte {pos}")
    flg = blob[pos + 3]
    if flg & 0xE0 or not flg & FEXTRA:
        raise ValueError(f"member at byte {pos}: FLG {flg:#x} has reserved "
                         "bits or no FEXTRA")
    (xlen,) = struct.unpack_from("<H", blob, pos + 10)
    p, end = pos + 12, pos + 12 + xlen
    fields = {}
    while p < end:
        if p + 4 > end:
            raise ValueError(f"member at byte {pos}: a cut FEXTRA subfield")
        sid, slen = blob[p:p + 2], struct.unpack_from("<H", blob, p + 2)[0]
        if p + 4 + slen > end:
            raise ValueError(f"member at byte {pos}: a subfield past FEXTRA")
        fields.setdefault(sid, blob[p + 4:p + 4 + slen])
        p += 4 + slen
    if ZT not in fields or len(fields[ZT]) != 4:
        raise ValueError(f"member at byte {pos} has no ZT length")
    (mlen,) = struct.unpack("<I", fields[ZT])
    if mlen < end - pos + 8 or pos + mlen > len(blob):
        raise ValueError(f"member at byte {pos}: ZT length {mlen} does not "
                         f"fit the stream's {len(blob)} bytes")
    return mlen, fields.get(ZX)


def sidecar_members(blob: bytes) -> int:
    """The number of data members that carry a decode index. Raises
    ValueError unless the ZT lengths chain from the first byte to the last,
    every sidecar follows a data member or another sidecar and has an empty
    trailer (CRC-32 0, ISIZE 0), and each data member's ZX payloads, joined
    in order, raw-inflate to exactly one index that starts with 'ZTI1' and
    whose output length is the member's ISIZE. A data member with no
    sidecar is not counted."""
    walk = []
    pos = 0
    while pos < len(blob):
        mlen, zx = _member(blob, pos)
        walk.append((pos, mlen, zx))
        pos += mlen
    count, i = 0, 0
    while i < len(walk):
        pos, mlen, zx = walk[i]
        if zx is not None:
            raise ValueError(f"the sidecar at byte {pos} follows no data "
                             "member")
        (isize,) = struct.unpack_from("<I", blob, pos + mlen - 4)
        chunks = []
        i += 1
        while i < len(walk) and walk[i][2] is not None:
            spos, slen, szx = walk[i]
            if blob[spos + slen - 8:spos + slen] != bytes(8):
                raise ValueError(f"the sidecar at byte {spos} has a payload")
            chunks.append(szx)
            i += 1
        if not chunks:
            continue
        dec = zlib.decompressobj(-15)
        try:
            index = dec.decompress(b"".join(chunks))
        except zlib.error as exc:
            raise ValueError(f"member at byte {pos}: its index does not "
                             f"inflate ({exc})") from None
        if not dec.eof or dec.unused_data:
            raise ValueError(f"member at byte {pos}: its ZX payloads are not "
                             "one raw DEFLATE stream")
        if len(index) < TOTAL_OUT_AT + 8 or not index.startswith(INDEX_MAGIC):
            raise ValueError(f"member at byte {pos}: its index does not "
                             "start with ZTI1")
        (total,) = struct.unpack_from("<Q", index, TOTAL_OUT_AT)
        if total & 0xFFFFFFFF != isize:
            raise ValueError(f"member at byte {pos}: its index gives "
                             f"{total} bytes out, its ISIZE {isize}")
        count += 1
    return count
