"""Plain reference for zip archives as zippy's createZipArchive writes them
(src/zippy/ziparchives.nim): local headers and a central directory whose
records all carry zip64 extra fields, a zip64 end of central directory and
its locator, every non-empty entry deflated. On CPython's zipfile, zlib and
struct alone: it reads an archive back, judges each entry's record and
stream against the table it should hold, measures each stream against
zlib's at level 1, and writes the control's archive. It imports nothing of
the program under test.
"""

from __future__ import annotations

import io
import struct
import zipfile
import zlib

LOCAL_SIG, CENTRAL_SIG = 0x04034B50, 0x02014B50
ZIP64_EOCD_SIG, ZIP64_LOCATOR_SIG, EOCD_SIG = 0x06064B50, 0x07064B50, \
    0x06054B50
ZIP64_ID = 1
VERSION, UTF8_FLAG, OVER = 45, 1 << 11, 0xFFFFFFFF


def deflate(data: bytes, level: int = 1,
            strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    """A raw DEFLATE stream of `data` (zlib, 32 KiB window)."""
    enc = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return enc.compress(data) + enc.flush()


def inflate_problem(stream: bytes, data: bytes) -> str | None:
    """Why `stream` is not one whole raw DEFLATE stream of `data`, or
    None."""
    dec = zlib.decompressobj(-15)
    try:
        out = dec.decompress(stream)
    except zlib.error as exc:
        return f"its stream does not inflate ({exc})"
    if not dec.eof or dec.unused_data:
        return "its stream does not end where its record says"
    if out != data:
        return (f"its stream inflates to {len(out)} bytes that are not the "
                f"table's {len(data)}")
    return None


def _dos(date_time: tuple) -> tuple[int, int]:
    """(MS-DOS time, date) of zipfile's date_time."""
    y, mo, d, h, mi, sec = date_time
    return h << 11 | mi << 5 | sec // 2, (y - 1980) << 9 | mo << 5 | d


def _local(name_b: bytes, method: int, when: tuple, crc: int, size: int,
           csize: int) -> bytes:
    return struct.pack("<IHHHHHIIIHH", LOCAL_SIG, VERSION, UTF8_FLAG, method,
                       *when, crc, OVER, OVER, len(name_b), 20) + name_b + \
        struct.pack("<HHQQ", ZIP64_ID, 16, size, csize)


def _central(name_b: bytes, method: int, when: tuple, crc: int, size: int,
             csize: int, offset: int) -> bytes:
    return struct.pack("<IHHHHHHIIIHHHHHII", CENTRAL_SIG, VERSION, VERSION,
                       UTF8_FLAG, method, *when, crc, OVER, OVER, len(name_b),
                       28, 0, 0, 0, 0, OVER) + name_b + \
        struct.pack("<HHQQQ", ZIP64_ID, 24, size, csize, offset)


def _end(count: int, cd_start: int, cd_end: int) -> bytes:
    """The zip64 end of central directory, its locator and the end
    record."""
    return (struct.pack("<IQHHIIQQQQ", ZIP64_EOCD_SIG, 44, VERSION, VERSION,
                        0, 0, count, count, cd_end - cd_start, cd_start)
            + struct.pack("<IIQI", ZIP64_LOCATOR_SIG, 0, cd_end, 1)
            + struct.pack("<IHHHHIIH", EOCD_SIG, 0, 0, 0xFFFF, 0xFFFF, OVER,
                          OVER, 0))


def entries(blob: bytes) -> list:
    """(name, method, crc, size, stream) of each entry, in order, as
    zipfile reads the central directory; ValueError unless every byte
    outside the streams is what createZipArchive writes for those values:
    the entries back to back from byte 0, each local header with its zip64
    field of both sizes, then the central directory, whose records carry
    zip64 fields of the sizes and the offset (their 32-bit sizes and offset
    0xFFFFFFFF), version 45 and the UTF-8 flag, then the zip64 end record,
    its locator and the end record. A local header that disagrees with its
    central record is not what was written."""
    try:
        infos = zipfile.ZipFile(io.BytesIO(blob)).infolist()
    except (zipfile.BadZipFile, ValueError) as exc:
        raise ValueError(f"not a zip archive: {exc}") from None
    out, central, pos = [], [], 0
    for info in infos:
        name_b = info.filename.encode("utf-8")
        when = _dos(info.date_time)
        fields = (info.compress_type, when, info.CRC, info.file_size,
                  info.compress_size)
        head = _local(name_b, *fields)
        if info.header_offset != pos or blob[pos:pos + len(head)] != head:
            raise ValueError(f"{info.filename}: its local header at byte "
                             f"{info.header_offset} is not the one written "
                             "for its central record")
        start = pos + len(head)
        out.append((info.filename, info.compress_type, info.CRC,
                    info.file_size, blob[start:start + info.compress_size]))
        central.append(_central(name_b, *fields, pos))
        pos = start + info.compress_size
    cd = b"".join(central)
    if blob[pos:pos + len(cd)] != cd:
        raise ValueError(f"the central directory at byte {pos} is not the "
                         "one written for its records")
    if blob[pos + len(cd):] != _end(len(infos), pos, pos + len(cd)):
        raise ValueError("the zip64 end record, its locator and the end "
                         "record are not the ones written")
    return out


def archive_problems(blob: bytes, tables: dict, crcs: dict,
                     judged: dict) -> tuple[list, dict]:
    """Why `blob` is not an archive of `tables` ({name: bytes}, in order;
    `crcs` their CRC-32s): its entries, by name and in order, each deflated
    (method 8) with its CRC-32 and size, each stream inflating to exactly
    its table; and {name: its stream's bytes}. `judged` ({stream: verdict})
    keeps the verdict on each stream already inflated."""
    try:
        found = entries(blob)
    except ValueError as exc:
        return [str(exc)], {}
    sizes = {e[0]: len(e[4]) for e in found}
    if list(sizes) != list(tables) or len(found) != len(tables):
        return [f"entries {[e[0] for e in found]}, not {list(tables)}"], sizes
    problems = []
    for name, method, crc, size, stream in found:
        data = tables[name]
        if method != 8:
            problems.append(f"{name}: method {method}, not 8 (deflated)")
        elif crc != crcs[name] or size != len(data):
            problems.append(f"{name}: CRC-32 {crc:#010x} of {size} bytes, "
                            f"not {crcs[name]:#010x} of {len(data)}")
        else:
            if stream not in judged:
                judged[stream] = inflate_problem(stream, data)
            if judged[stream]:
                problems.append(f"{name}: {judged[stream]}")
    return problems, sizes


def write_zip(tables: dict, strategy: int = zlib.Z_DEFAULT_STRATEGY) -> bytes:
    """An archive of `tables` in createZipArchive's layout (its timestamp
    0), each entry zlib's raw stream at level 1 with `strategy`."""
    out, central = bytearray(), []
    for name, data in tables.items():
        stream = deflate(data, 1, strategy)
        fields = (name.encode("utf-8"), 8, (0, 0), zlib.crc32(data),
                  len(data), len(stream))
        central.append(_central(*fields, len(out)))
        out += _local(*fields) + stream
    cd = b"".join(central)
    return bytes(out) + cd + _end(len(central), len(out), len(out) + len(cd))
