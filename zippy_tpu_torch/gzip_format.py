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

import numpy as np
import torch

from . import engine, native, profiling
from .common import ZippyError, as_u8_tensor, host_bytes, resolve_device

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


def _walk_members(src: bytes) -> tuple[list, ZippyError | None]:
    """member_indexes' walk: the [(byte offset, decode index)] of the
    members before the first one whose header or scan raised, and that
    error (None when the walk reached the stream's end)."""
    from .ops import inflate_device as idev

    out = []
    pos = 0
    try:
        with profiling.span("framing"):         # the scans are their own
            while pos < len(src):
                if _is_zero_padding(src, pos):
                    break
                hdr = parse_header(src, pos)
                index = idev.build_decode_index(src, hdr["data_offset"] * 8)
                out.append((pos, index))
                pos = (int(index["end_bit"]) + 7) // 8 + 8
    except ZippyError as e:
        return out, e
    if not out:
        return out, ZippyError("Invalid gzip data")
    return out, None


def member_indexes(src: bytes) -> list:
    """[(byte offset, decode index)] of every member of a gzip stream, up to
    its end or to trailing zero padding. Each member is scanned in place, at
    its bit offset in `src`, so no member's tail is copied."""
    out, err = _walk_members(src)
    if err is not None:
        raise err
    return out


def uncompress_gzip_device_all(src: bytes, device=None,
                               indexes=None) -> bytes:
    """Decode every member of a gzip stream on the card and concatenate
    them. `indexes` is the result of member_indexes (walked here when
    omitted). A stream whose ZT lengths chain consistently to its end and
    that carries ZX sidecars (compress_device_indexed output) decodes
    through uncompress_device, with no host scan."""
    from .ops import inflate_device as idev

    if indexes is None:
        with profiling.span("framing"):
            spans = _zt_spans(src)
            sidecars = spans and any(_member_zx(src, pos) is not None
                                     for pos, _ in spans)
        if sidecars:
            return uncompress_device(src, device=device)
        indexes, err = _walk_members(src)
        if err is not None:
            # The reference decodes and verifies a member before it parses
            # the next: the members before the one the walk failed on are
            # decoded first, so that their own error wins.
            for pos, index in indexes:
                idev.uncompress_gzip_device(src, index, device, pos)
            raise err
    parts = [idev.uncompress_gzip_device(src, index, device, pos)
             for pos, index in indexes]
    with profiling.span("framing"):
        return b"".join(parts)


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
    _check_member_size(member_size)
    x = as_u8_tensor(src, device)
    n = int(x.shape[0])
    matcher = engine.matcher_level(src, level)
    return b"".join(_zt_member(x[i:i + member_size], level, matcher=matcher)
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
    """Decode a gzip stream whose members carry ZT lengths: on the card,
    the members decode one after another, each given its own scan, and a
    member whose decode ends anywhere but at its ZT length raises
    ZippyError. Without a usable ZT index (or with a single member) the
    whole stream decodes through uncompress_gzip_device_all."""
    from .ops import inflate_device as idev

    spans = _zt_spans(src)
    if not spans or len(spans) == 1:
        return uncompress_gzip_device_all(src, device)
    parts = []
    for pos, mlen in spans:
        hdr = parse_header(src, pos)
        index = idev.build_decode_index(src, hdr["data_offset"] * 8)
        if (int(index["end_bit"]) + 7) // 8 + 8 != pos + mlen:
            raise ZippyError("Invalid gzip data (ZT index length mismatch)")
        parts.append(idev.uncompress_gzip_device(src, index, device, pos))
    return b"".join(parts)


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
    from .ops import inflate_device as idev

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


def _member_zx(src: bytes, pos: int) -> bytes | None:
    """The 'ZX' subfield payload of the member at `pos`, if any."""
    extra = parse_header(src, pos)["extra"]
    if not extra:
        return None
    p, end = 0, len(extra)
    while p + 4 <= end:
        sid = extra[p : p + 2]
        slen = struct.unpack_from("<H", extra, p + 2)[0]
        p += 4
        if sid == ZX_SUBFIELD_ID and p + slen <= end:
            return extra[p : p + slen]
        p += slen
    return None


def _zt_length(src: bytes, pos: int) -> tuple[int, int]:
    """(ZT length, deflate body offset) of the member at `pos`, checked:
    the length must hold the member's header and 8-byte trailer and end
    inside the stream."""
    mlen = _indexed_member_length(src, pos)
    if mlen is None:
        raise ZippyError("Invalid gzip data (missing ZT index)")
    start = parse_header(src, pos)["data_offset"]
    if mlen < start - pos + 8 or pos + mlen > len(src):
        raise ZippyError("Invalid gzip data (ZT index length out of range)")
    return mlen, start


def _sidecar_length(src: bytes, pos: int) -> int:
    """The checked ZT length of the sidecar at `pos`, whose trailer must
    be that of an empty payload (crc32 0, ISIZE 0): the decode skips its
    body, and CPython's reading of the stream would differ otherwise."""
    mlen, _ = _zt_length(src, pos)
    if src[pos + mlen - 8:pos + mlen] != bytes(8):
        raise ZippyError("Invalid gzip data (a ZX sidecar with a payload)")
    return mlen


def _dispatch_members(src: bytes, device) -> list:
    """Dispatch the decode of every data member of an indexed stream, back
    to back with no host sync. Each member decodes in place in `src`, from
    its sidecar index shifted to absolute offsets (checked first), or from
    a scan where it has no sidecar. Stray sidecars and trailing zero
    padding are skipped. Returns one pending decode per member, for
    _verify_members."""
    from .ops import inflate_device as idev

    pending = []
    pos = 0
    while pos < len(src) and not _is_zero_padding(src, pos):
        if _member_zx(src, pos) is not None:
            pos += _sidecar_length(src, pos)  # a stray sidecar
            continue
        mlen, start = _zt_length(src, pos)
        end = pos + mlen
        chunks = []
        while end < len(src) and not _is_zero_padding(src, end):
            if _indexed_member_length(src, end) is None:
                break
            zx = _member_zx(src, end)
            if zx is None:
                break
            chunks.append(zx)
            end += _sidecar_length(src, end)
        want_crc, want_isize = struct.unpack_from("<II", src, pos + mlen - 8)
        if chunks:
            index = deserialize_index(b"".join(chunks))
            _check_index(index, pos + mlen - start, want_isize)
            index["segments"][:, 0] += start * 8
            index["stored"][:, 0] += start
            index["end_bit"] += start * 8
        else:
            index = idev.build_decode_index(src, start * 8)
            if (int(index["end_bit"]) + 7) // 8 + 8 != pos + mlen:
                raise ZippyError(
                    "Invalid gzip data (ZT index length mismatch)")
        buf, total, adler_t, crc_t, keep = idev.inflate_device_array_acc(
            src, index, device)
        pending.append((buf, total, adler_t, crc_t, keep,
                        int(index["adler"]), want_crc, want_isize))
        pos = end
    return pending


def _verify_members(pending: list) -> list:
    """Fetch every pending member's adler32 and raw CRC in one copy, check
    them against the index's adler32, the trailer's crc32 and ISIZE, and
    return [(uint8 tensor of exactly total bytes, total)]."""
    from .ops import checksums
    from .ops import inflate_device as idev

    if not pending:
        return []
    got = torch.cat([torch.cat([p[2] for p in pending]),
                     torch.cat([p[3] for p in pending])]).tolist()
    out = []
    for (buf, total, _, _, _, want_adler, want_crc, want_isize), adler, raw \
            in zip(pending, got, got[len(pending):]):
        idev.check_sums(total, adler, checksums.crc32_finish(raw, total),
                        want_adler, want_crc, want_isize)
        out.append((buf, total))
    return out


def uncompress_device(src: bytes, array: bool = False, device=None):
    """Decode an indexed gzip stream (compress_device_indexed output) on
    the card (`device` None) or with the plain versions ("cpu"), with no
    host scan: each member's sidecar index feeds the tiled decode directly.
    A member without a sidecar is scanned. Every member is dispatched back
    to back; then all members' checksums come back in one fetch and each
    is checked: the output's adler32 against the index's, its crc32
    against the trailer, its length against ISIZE.

    array=False returns the bytes (each member's buffer fetched after the
    gates passed); array=True returns [(uint8 tensor of exactly total
    bytes, total)] per data member, on the device (zero-length for an empty
    member). Every member must carry a ZT length: ZippyError otherwise."""
    if not isinstance(src, bytes):
        src = bytes(src)
    parts = _verify_members(_dispatch_members(src, resolve_device(device)))
    if array:
        return parts
    return b"".join(buf.cpu().numpy().tobytes() for buf, _ in parts)
