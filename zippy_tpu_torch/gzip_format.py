"""RFC 1952 gzip framing: the port of zippy_tpu.gzip_format's member writer,
header parser, member reader, host and device decode of every member, and
the indexed formats.

Parity reference: zippy's src/zippy/gzip.nim and zippy.nim:22-58 (member
write with random-length FNAME anti-oracle padding,
https://github.com/guzba/zippy/issues/61). Like the reference, FEXTRA is
parsed and multi-member streams decode to the concatenation (CPython's
semantics).

Two indexed formats ride in FEXTRA subfields and stay standard gzip:

* 'ZT' carries each member's total byte length (`compress_indexed`,
  `uncompress_parallel`), as bgzip's BC subfield does.
* 'ZX' carries a member's device-decode index, deflated, in empty-payload
  sidecar members after it (`compress_device_indexed`), so that
  `uncompress_device` decodes with no host scan. Any RFC 1952 reader sees
  the sidecars as members that decode to nothing.

read_member, uncompress_gzip and concat_members decode on the host engine
(native.py), as the reference's do. The indexed formats' members are
written by the device encoder, and the index blob is deflated by the host
engine at level 6, as the reference's is: the sidecars of one index are the
reference's bytes, but the data members are not, so each side decodes the
other's indexed streams. A sidecar is untrusted input: its index is checked
(`_check_index`) before it plans a decode, and every ZT length is checked
against the member it frames.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np

from . import engine, native, profiling
from .common import ZippyError, as_u8_tensor, host_bytes
from .ops import inflate_device as idev

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
    extra: bytes | None = None,
    engine_name: str = "auto",
    device=None,
    matcher: int | None = None,
) -> bytes:
    """One gzip member: header + deflate stream + crc32/ISIZE trailer.
    `extra`, if given, is the FEXTRA field (at most 0xFFFF bytes), written
    before FNAME.

    The payload goes to the device once (a tensor stays where it is): the
    deflate body and the crc32 both run there; only the header and trailer
    bytes assemble on the host. Level -1 runs level 6's matcher on host
    bytes and level 1's on a tensor (engine.matcher_level); `matcher`, if
    given, is the level whose matcher runs, for a caller that uploaded
    host bytes itself.

    engine_name="native" writes host bytes with the host engine (native.py):
    with no `extra`, the whole member in one call, as the reference's
    write_member does; `device` is then unused. A tensor runs on its own
    device whatever the engine."""
    engine.check_engine(engine_name)
    if engine.on_host(src, engine_name):
        x = host_bytes(src)
        if extra is None:
            name_pad = os.urandom(1)[0] % 26 if random_name_padding else -1
            return native.gzip_compress(x, level, name_pad)
    else:
        x = as_u8_tensor(src, device)
    with profiling.span("framing"):
        flg = 0
        fields = b""
        if extra is not None:
            if len(extra) > 0xFFFF:
                raise ZippyError("gzip FEXTRA field too long")
            flg |= FEXTRA
            fields += struct.pack("<H", len(extra)) + extra
        if random_name_padding:
            # Random-length (0-25 chars) FNAME defeats compressed-length
            # oracles.
            flg |= FNAME
            npad = os.urandom(1)[0] % 26
            fields += bytes(97 + i for i in range(npad)) + b"\x00"
        header = struct.pack("<2sBBIBB", GZIP_MAGIC, 8, flg, 0, 0, 0)
    if matcher is None:
        matcher = engine.matcher_level(src, level)
    body = engine.deflate(x, level, engine_name, matcher)
    crc = engine.crc32(x, engine_name)
    with profiling.span("framing"):
        trailer = struct.pack("<II", crc, len(x) & 0xFFFFFFFF)
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


def read_member(src: bytes, pos: int = 0,
                trust_size: bool = False) -> tuple[bytes, int]:
    """Decode the member at byte `pos` on the host engine. Returns
    (payload, byte offset of the next member). `trust_size` sizes the
    output from the stream's last ISIZE (mod 2^32, so a hint: a wrong one
    falls back to growth)."""
    hdr = parse_header(src, pos)
    p = hdr["data_offset"]
    size_hint = None
    if trust_size:
        size_hint = struct.unpack_from("<I", src, len(src) - 4)[0] + 16
    payload, end_bit = native.inflate(src, p * 8, size_hint=size_hint)
    tpos = (end_bit + 7) // 8
    if tpos + 8 > len(src):
        raise ZippyError("Invalid gzip data")
    checksum, isize = struct.unpack_from("<II", src, tpos)
    if checksum != native.crc32(payload):
        raise ZippyError("Checksum verification failed")
    if isize != len(payload) & 0xFFFFFFFF:
        raise ZippyError("Size verification failed")
    return payload, tpos + 8


def uncompress_gzip(src: bytes, trust_size: bool = False) -> bytes:
    """Decode every member of a gzip stream on the host engine and
    concatenate them (CPython's semantics); trailing zero padding is
    allowed, other trailing bytes raise ZippyError. Each member is one
    host-engine call (header, inflate, crc32 and ISIZE checks), which always
    sizes its output from the ISIZE trailer within DEFLATE's expansion
    bound, so `trust_size` changes nothing."""
    del trust_size
    payload, consumed = native.gzip_uncompress(src, 0)
    if consumed == len(src):
        return payload
    return concat_members(src, [payload], consumed)


def concat_members(src: bytes, parts: list, pos: int) -> bytes:
    """Go on decoding members on the host engine from byte `pos`, the
    members before it already decoded into `parts`, and return all the
    payloads concatenated."""
    while not _is_zero_padding(src, pos):
        if len(src) - pos < 18 or bytes(src[pos:pos + 2]) != GZIP_MAGIC:
            raise ZippyError("Invalid gzip data (trailing garbage)")
        payload, consumed = native.gzip_uncompress(src, pos)
        parts.append(payload)
        pos += consumed
    return parts[0] if len(parts) == 1 else b"".join(parts)


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
    """[(byte offset, decode index)] of every data member of a gzip stream,
    up to its end or to trailing zero padding, as `_walk` reads them (each
    scanned in place unless it has sidecars, so no member's tail is
    copied)."""
    if _is_zero_padding(src, 0):
        raise ZippyError("Invalid gzip data")
    members, err = _walk(src)
    if err is not None:
        raise err
    return [(m.pos, m.index) for m in members]


def uncompress_gzip_device(blob: bytes, index=None, device=None,
                           pos: int = 0) -> bytes:
    """Decode the gzip member at byte `pos` of `blob` on the card, scanned
    first when `index` is omitted, and checked as `_decode` checks it."""
    if index is None:
        index = idev.build_decode_index(
            blob, parse_header(blob, pos)["data_offset"] * 8)
    return _fetched(blob, [_member(blob, pos, None, index)], None, device)


def uncompress_gzip_device_all(src: bytes, device=None,
                               indexes=None) -> bytes:
    """Decode every member of a gzip stream on the card and concatenate
    them. `indexes` is the result of member_indexes; without it the stream
    is walked here (`_walk`: compress_device_indexed output decodes with no
    host scan). ZT lengths are not checked. The members before the first
    one the walk failed on are decoded first, so that their own error wins,
    as in the reference's decode of one member after another."""
    if indexes is not None:
        members, err = [_member(src, pos, None, index)
                        for pos, index in indexes], None
    elif _is_zero_padding(src, 0):
        raise ZippyError("Invalid gzip data")
    else:
        members, err = _walk(src)
    return _fetched(src, members, err, device)


# ---------------------------------------------------------------------------
# The ZT member-length index
# ---------------------------------------------------------------------------

ZT_SUBFIELD_ID = b"ZT"
_INDEXED_MEMBER_SIZE = 4 * 1024 * 1024


def _zt_member(src, level: int, extra: bytes = b"", device=None,
               matcher: int | None = None) -> bytes:
    """One member (no FNAME) whose FEXTRA starts with the ZT subfield of
    its own total length, followed by `extra`: written with a zero length,
    which is then patched in. `matcher` as write_member takes it."""
    placeholder = struct.pack("<2sHI", ZT_SUBFIELD_ID, 4, 0)
    blob = write_member(src, level, random_name_padding=False,
                        extra=placeholder + extra, device=device,
                        matcher=matcher)
    return (blob[:12] + struct.pack("<2sHI", ZT_SUBFIELD_ID, 4, len(blob))
            + blob[12 + len(placeholder):])


def compress_indexed(
    src,
    level: int,
    *,
    member_size: int = _INDEXED_MEMBER_SIZE,
    device=None,
) -> bytes:
    """Multi-member gzip with a 'ZT' FEXTRA subfield carrying each member's
    total byte length: a standard gzip stream (CPython and any RFC 1952
    reader decode it) whose members uncompress_parallel finds without a
    scan. The payload is uploaded once to `device` (None: the CUDA card;
    "cpu" runs the plain versions); the device encoder writes the members
    one after another, with the matcher of `src` (engine.matcher_level:
    level -1 runs level 6's on host bytes)."""
    with profiling.call("compress"):
        _check_member_size(member_size)
        x = as_u8_tensor(src, device)
        n = int(x.shape[0])
        matcher = engine.matcher_level(src, level)
        return b"".join(_zt_member(x[i:i + member_size], level,
                                   matcher=matcher)
                        for i in range(0, max(n, 1), member_size))


def _check_member_size(member_size: int) -> None:
    if member_size < 1:
        raise ZippyError(f"member_size {member_size} is not positive")


def _indexed_member_length(src: bytes, pos: int) -> int | None:
    """Member length from the ZT subfield, or None if absent."""
    if len(src) - pos < 18 or src[pos : pos + 2] != GZIP_MAGIC:
        return None
    if not (src[pos + 3] & FEXTRA):
        return None
    xlen = struct.unpack_from("<H", src, pos + 10)[0]
    p, end = pos + 12, pos + 12 + xlen
    while p + 4 <= end:
        sid = src[p : p + 2]
        slen = struct.unpack_from("<H", src, p + 2)[0]
        p += 4
        if sid == ZT_SUBFIELD_ID and slen == 4 and p + 4 <= end:
            return struct.unpack_from("<I", src, p)[0]
        p += slen
    return None


def _zt_spans(src: bytes) -> list | None:
    """[(byte offset, ZT length)] of every member up to the stream's end or
    its trailing zero padding, or None unless every member has a ZT length
    of at least 18 bytes that stays inside the stream."""
    spans = []
    pos = 0
    while pos < len(src) and not _is_zero_padding(src, pos):
        mlen = _indexed_member_length(src, pos)
        if mlen is None or mlen < 18 or pos + mlen > len(src):
            return None
        spans.append((pos, mlen))
        pos += mlen
    return spans


def uncompress_parallel(src: bytes, device=None) -> bytes:
    """Decode a gzip stream whose members carry ZT lengths on the card, as
    uncompress_device does; a member whose decode ends anywhere but at its
    ZT length raises ZippyError. Without a usable ZT index (or with a
    single member) the whole stream decodes through
    uncompress_gzip_device_all."""
    with profiling.call("uncompress"):
        spans = _zt_spans(src)
        if not spans or len(spans) == 1:
            return uncompress_gzip_device_all(src, device)
        return _fetched(src, *_zt_checked(*_walk(src)), device)


# ---------------------------------------------------------------------------
# The ZX device-decode index (encode-time index, zero host scans on decode)
# ---------------------------------------------------------------------------

ZX_SUBFIELD_ID = b"ZX"
_ZX_CHUNK = 60000
_ZTI_MAGIC = b"ZTI1"
_ZTI_HEAD = "<HIIIQQII"
_ZTI_HEAD_BYTES = len(_ZTI_MAGIC) + struct.calcsize(_ZTI_HEAD)
# Bytes per segment row (bit, out deltas u4; block-id delta u1; ntok, match
# bytes, depth u2), per stored row (three u4) and per block (code lengths).
_SEG_ROW, _STO_ROW, _BLK_ROW = 15, 12, 318
_MAX_EVERY = 1024           # K4's limit on the tokens a lane decodes
_MAX_EXPANSION = 1032       # DEFLATE's largest output bytes per input byte


def _narrow(values: np.ndarray, dtype: str, what: str) -> bytes:
    """values in `dtype`'s range as its little-endian bytes; ZippyError
    where a value would not fit."""
    info = np.iinfo(np.dtype(dtype))
    if values.size and (values.min() < info.min or values.max() > info.max):
        raise ZippyError(f"device index column {what} does not fit {dtype}")
    return values.astype(dtype).tobytes()


def serialize_index(index) -> bytes:
    """Columnar little-endian serialization of a decode index (offsets
    relative to the start of the member's deflate body), raw-deflated by the
    host engine at level 6, as the reference's is. The columns are the
    reference's; each is range-checked before it is narrowed, and a value
    out of range raises ZippyError."""
    seg = np.asarray(index["segments"], dtype=np.int64).reshape(-1, 6)
    sto = np.asarray(index["stored"], dtype=np.int64).reshape(-1, 3)
    lens = np.asarray(index["block_lens"], dtype=np.uint8)
    nseg, nsto, nblk = seg.shape[0], sto.shape[0], lens.shape[0]
    scalars = [int(index[k]) for k in ("every", "total_out", "end_bit",
                                       "max_depth", "adler")]
    every, total_out, end_bit, max_depth, adler = scalars
    if not (0 <= every <= 0xFFFF and 0 <= total_out < 1 << 64
            and 0 <= end_bit < 1 << 64 and 0 <= max_depth <= 0xFFFFFFFF
            and 0 <= adler <= 0xFFFFFFFF):
        raise ZippyError("device index scalar out of range")
    head = _ZTI_MAGIC + struct.pack(_ZTI_HEAD, every, nseg, nsto, nblk,
                                    total_out, end_bit, max_depth, adler)
    cols = []
    if nseg:
        cols.append(_narrow(np.diff(seg[:, 0], prepend=0), "<u4", "bit"))
        cols.append(_narrow(np.diff(seg[:, 1], prepend=0), "<u4", "out"))
        cols.append(_narrow(np.diff(seg[:, 2], prepend=0), "<u1", "block"))
        cols.append(_narrow(seg[:, 3], "<u2", "ntok"))
        cols.append(_narrow(seg[:, 4], "<u2", "match bytes"))
        cols.append(_narrow(seg[:, 5], "<u2", "depth"))
    if nsto:
        cols.append(_narrow(np.diff(sto[:, 0], prepend=0), "<u4", "src"))
        cols.append(_narrow(np.diff(sto[:, 1], prepend=0), "<u4", "out"))
        cols.append(_narrow(sto[:, 2], "<u4", "len"))
    cols.append(lens.tobytes())
    return native.deflate(head + b"".join(cols), 6)


def deserialize_index(blob: bytes) -> dict:
    """Inverse of serialize_index; returns the dict build_decode_index
    produces (body-relative offsets). Every count is checked against the
    blob before it is read: a malformed blob raises ZippyError."""
    try:
        raw, stop = native.inflate(blob)
    except ZippyError as e:
        raise ZippyError(f"Invalid device index ({e})") from None
    if (stop + 7) // 8 != len(blob) or len(raw) < _ZTI_HEAD_BYTES \
            or raw[:4] != _ZTI_MAGIC:
        raise ZippyError("Invalid device index")
    (every, nseg, nsto, nblk, total_out, end_bit, max_depth,
     adler) = struct.unpack_from(_ZTI_HEAD, raw, 4)
    if len(raw) != (_ZTI_HEAD_BYTES + nseg * _SEG_ROW + nsto * _STO_ROW
                    + nblk * _BLK_ROW):
        raise ZippyError("Invalid device index (counts disagree with its "
                         "length)")
    p = _ZTI_HEAD_BYTES

    def col(dt, n):
        nonlocal p
        a = np.frombuffer(raw, dtype=dt, count=n, offset=p).astype(np.int64)
        p += n * np.dtype(dt).itemsize
        return a

    seg = np.zeros((nseg, 6), np.int64)
    if nseg:
        seg[:, 0] = np.cumsum(col("<u4", nseg))
        seg[:, 1] = np.cumsum(col("<u4", nseg))
        seg[:, 2] = np.cumsum(col("<u1", nseg))
        seg[:, 3] = col("<u2", nseg)
        seg[:, 4] = col("<u2", nseg)
        seg[:, 5] = col("<u2", nseg)
    sto = np.zeros((nsto, 3), np.int64)
    if nsto:
        sto[:, 0] = np.cumsum(col("<u4", nsto))
        sto[:, 1] = np.cumsum(col("<u4", nsto))
        sto[:, 2] = col("<u4", nsto)
    lens = np.frombuffer(raw, np.uint8, nblk * _BLK_ROW, p).reshape(
        nblk, _BLK_ROW).copy()
    return {
        "segments": seg, "stored": sto, "block_lens": lens,
        "total_out": int(total_out), "end_bit": int(end_bit),
        "max_depth": int(max_depth), "adler": int(adler),
        "every": int(every),
    }


def _check_index(index, body_len: int, isize: int) -> None:
    """Raise ZippyError unless a sidecar's index (body-relative offsets)
    can describe a member whose deflate body and 8-byte trailer take
    `body_len` bytes and whose trailer says `isize`: segment bit offsets and
    output offsets nondecreasing and inside the body and the output, block
    ids nondecreasing and below the block count, stored spans inside both,
    the body ending just before the trailer, `every` within K4's limit, the
    output length equal to ISIZE mod 2^32 and within DEFLATE's expansion of
    the body (so a hostile count cannot claim the card's memory)."""
    seg, sto = index["segments"], index["stored"]
    total, end_bit = int(index["total_out"]), int(index["end_bit"])
    body = (end_bit + 7) // 8
    nblk = index["block_lens"].shape[0]

    def ordered(col, hi):
        return not col.size or (col[0] >= 0 and col[-1] <= hi
                                and bool((np.diff(col) >= 0).all()))

    ok = (body + 8 == body_len
          and 1 <= int(index["every"]) <= _MAX_EVERY
          and total & 0xFFFFFFFF == isize
          and total <= _MAX_EXPANSION * body
          and ordered(seg[:, 0], end_bit) and ordered(seg[:, 1], total)
          and ordered(seg[:, 2], nblk - 1)
          and ordered(sto[:, 0], body) and ordered(sto[:, 1], total)
          and bool(((sto[:, 2] >= 0) & (sto[:, 2] < 1 << 16)
                    & (sto[:, 0] + sto[:, 2] <= body)
                    & (sto[:, 1] + sto[:, 2] <= total)).all()))
    if not ok:
        raise ZippyError("Invalid device index (inconsistent with its "
                         "member)")


def _sidecar_members(index_blob: bytes, device=None) -> bytes:
    """Empty-payload gzip members whose FEXTRA 'ZX' subfields carry the
    deflated index in <= _ZX_CHUNK chunks (they decode to b''). Each also
    carries the ZT length subfield, so member walkers skip them without
    parsing."""
    return b"".join(
        _zt_member(b"", 6, struct.pack("<2sH", ZX_SUBFIELD_ID, len(chunk))
                   + chunk, device)
        for chunk in (index_blob[i:i + _ZX_CHUNK]
                      for i in range(0, len(index_blob), _ZX_CHUNK)))


def compress_device_indexed(
    src,
    level: int,
    *,
    member_size: int = 1 << 20,
    device=None,
) -> bytes:
    """Gzip whose members each carry their full device-decode index in
    sidecar members after them: uncompress_device decodes it on the card
    with no host scan, and host readers see a normal gzip stream (the ZT
    lengths keep uncompress_parallel working too).

    The payload is uploaded once to `device` (None: the CUDA card; "cpu"
    runs the plain versions) and each member is a slice of it, written by
    the device encoder with the matcher of `src` (engine.matcher_level);
    each body is then scanned once on the host for its index. The index is the cost of the format: a checkpoint every 32
    tokens, whose deflated share of the stream depends on the data (about
    a tenth on chip_smoke.py's mixed payload)."""
    with profiling.call("compress"):
        _check_member_size(member_size)
        x = as_u8_tensor(src, device)
        matcher = engine.matcher_level(src, level)
        out = []
        for i in range(0, max(int(x.shape[0]), 1), member_size):
            blob = _zt_member(x[i:i + member_size], level, matcher=matcher)
            body = blob[parse_header(blob)["data_offset"]:]
            out.append(blob)
            out.append(_sidecar_members(
                serialize_index(idev.build_decode_index(body)), x.device))
        return b"".join(out)


def _zx(extra: bytes | None) -> bytes | None:
    """The 'ZX' subfield payload of a FEXTRA field, if any."""
    p, end = 0, len(extra or b"")
    while p + 4 <= end:
        sid = extra[p : p + 2]
        slen = struct.unpack_from("<H", extra, p + 2)[0]
        p += 4
        if sid == ZX_SUBFIELD_ID and p + slen <= end:
            return extra[p : p + slen]
        p += slen
    return None


def _member_zx(src: bytes, pos: int) -> bytes | None:
    """The 'ZX' subfield payload of the member at `pos`, if any."""
    return _zx(parse_header(src, pos)["extra"])


# ---------------------------------------------------------------------------
# The member walk and the decode
# ---------------------------------------------------------------------------


class _Member(NamedTuple):
    pos: int            # byte offset of its header
    zt: int | None      # its ZT length, where it has one
    index: dict         # its decode index, offsets absolute in the stream
    end: int            # byte offset past its trailer
    crc: int            # the trailer's crc32
    isize: int          # the trailer's ISIZE


def _member(src: bytes, pos: int, zt, index) -> _Member:
    """The member at `pos` whose body `index` describes, and its trailer."""
    end = (int(index["end_bit"]) + 7) // 8 + 8
    if end > len(src):
        raise ZippyError("Invalid gzip data")
    return _Member(pos, zt, index, end,
                   *struct.unpack_from("<II", src, end - 8))


def _framing(src: bytes, pos: int):
    """(body offset, ZT length or None, whether that length frames the
    member: holds its header and trailer and ends inside the stream, its
    ZX payload if it is a sidecar) of the member at `pos`. A sidecar has a
    ZX subfield and a framing ZT length, and must have an empty payload's
    trailer: the decode skips its body, which CPython would not."""
    hdr = parse_header(src, pos)
    start = hdr["data_offset"]
    zt = _indexed_member_length(src, pos)
    framed = zt is not None and start - pos + 8 <= zt and pos + zt <= len(src)
    zx = _zx(hdr["extra"]) if framed else None
    if zx is not None and src[pos + zt - 8:pos + zt] != bytes(8):
        raise ZippyError("Invalid gzip data (a ZX sidecar with a payload)")
    return start, zt, framed, zx


def _sidecar_index(src: bytes, pos: int, zt: int, start: int):
    """(index, offset past its sidecars) of the data member at `pos` with
    ZT length `zt` and body at `start`, the index read from the sidecars
    after it, checked and shifted to the stream's offsets; (None, None)
    where no sidecar follows it."""
    with profiling.span("index"):
        end, chunks = pos + zt, []
        while (end < len(src) and not _is_zero_padding(src, end)
               and _indexed_member_length(src, end) is not None):
            _, n, _, zx = _framing(src, end)
            if zx is None:
                break
            chunks.append(zx)
            end += n
        if not chunks:
            return None, None
        blob = b"".join(chunks)
        profiling.count("index.members")
        profiling.count("index.bytes", len(blob))
        index = deserialize_index(blob)
        _check_index(index, pos + zt - start,
                     struct.unpack_from("<I", src, pos + zt - 4)[0])
        index["segments"][:, 0] += start * 8
        index["stored"][:, 0] += start
        index["end_bit"] += start * 8
        return index, end


def _walk(src: bytes) -> tuple[list, ZippyError | None]:
    """The one walk over a gzip stream's members, up to its end or its
    trailing zero padding: ([_Member] of its data members, None), or those
    before the first member that raised and that error. A member's index
    comes from its sidecars where its ZT length frames it, else from a scan
    in place; a stray sidecar is skipped. ZT lengths are read, not checked
    (`_zt_checked` does that). Spans: headers, trailers and stray sidecars
    are `framing`, the sidecar reads `index`; the scans are their own."""
    members = []
    pos = 0
    try:
        while True:
            with profiling.span("framing"):
                if pos >= len(src) or _is_zero_padding(src, pos):
                    return members, None
                start, zt, framed, zx = _framing(src, pos)
                if zx is not None:
                    pos += zt                   # a stray sidecar
                    continue
            index, after = (_sidecar_index(src, pos, zt, start) if framed
                            else (None, None))
            if index is None:
                index = idev.build_decode_index(src, start * 8)
            with profiling.span("framing"):
                members.append(_member(src, pos, zt, index))
            pos = after or members[-1].end
    except ZippyError as e:
        return members, e


def _zt_checked(members: list, err):
    """The walk's (members, err) cut at the first member that has no ZT
    length or whose ZT length does not end at its trailer, whose error
    then stands in for the walk's."""
    for i, m in enumerate(members):
        if m.zt is None or m.pos + m.zt != m.end:
            return members[:i], ZippyError("Invalid gzip data (%s)" % (
                "missing ZT index" if m.zt is None
                else "ZT index length mismatch"))
    return members, err


def _decode(src: bytes, members: list, err, device):
    """Yield (uint8 tensor of exactly total bytes, total) of each of the
    walk's members in order, decoded on `device` in passes of
    inflate_streams (one fetch of every sum a pass) and checked: crc32
    against the trailer, length against ISIZE mod 2^32. A member's error
    is raised when the decode reaches it; `err`, the walk's, at the end."""
    for run in idev.passes(members, lambda m: int(m.index["total_out"])):
        outs, bad, _ = idev.inflate_streams([(src, m.index) for m in run],
                                            device, crc=True)
        for m, out in zip(run, outs):
            if out.crc != m.crc:
                raise ZippyError("Checksum verification failed")
            if m.isize != out.total & 0xFFFFFFFF:
                raise ZippyError("Size verification failed")
            yield out.buf, out.total
        if bad is not None:
            raise bad
    if err is not None:
        raise err


def _fetched(src: bytes, members: list, err, device) -> bytes:
    """The members' bytes, each fetched once its pass passed its checks."""
    parts = [idev._fetch(buf) for buf, _ in _decode(src, members, err,
                                                      device)]
    with profiling.span("framing"):
        return b"".join(parts)


def uncompress_device(src: bytes, array: bool = False, device=None):
    """Decode an indexed gzip stream (compress_device_indexed output) on
    the card (`device` None) or with the plain versions ("cpu"), with no
    host scan: each member's sidecar index feeds the tiled decode directly.
    A member without a sidecar is scanned. Every member must carry a ZT
    length that ends at its trailer: ZippyError otherwise. The members of a
    pass (up to 1 GiB of output) dispatch back to back, then one fetch
    brings all their checksums: each output's adler32 against its index,
    its crc32 against the trailer, its length against ISIZE. An earlier
    member's error wins over a later one's.

    array=False returns the bytes (each member's buffer fetched after its
    pass passed its checks); array=True returns [(uint8 tensor of exactly
    total bytes, total)] per data member, on the device (zero-length for
    an empty member). With tracing on, the call keeps a record of its
    spans and counters (profiling.recent), or adds to the record of the
    call it is in."""
    with profiling.call("uncompress"):
        if not isinstance(src, bytes):
            src = bytes(src)
        members, err = _zt_checked(*_walk(src))
        if array:
            return list(_decode(src, members, err, device))
        return _fetched(src, members, err, device)
