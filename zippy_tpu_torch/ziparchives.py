"""Zip archive reader and writer (the current API): the port of
zippy_tpu/ziparchives.py, with the codec work on the card.

Parity reference: zippy's src/zippy/ziparchives.nim, through
zippy_tpu.ziparchives: memory-mapped reader with a backwards EOCD scan, the
zip64 EOCD and locator, the central-directory walk with zip64 extra-field
sizes, CP437 -> UTF-8 names, concatenated-zip offset recovery, extractFile
with its crc32 check, extractAll with the path-safety pre-pass and
cleanup-on-error, MS-DOS timestamps, and createZipArchive's always-zip64
writer. The reader's parsing is copied as it is.

What differs is how the entries reach the codec. The reference compresses
and extracts entry by entry on a thread pool (its native codec releases the
GIL). Here one host thread issues all CUDA work:

* create_zip_archive encodes every non-empty entry in one
  deflate_device.deflate_entries call, whose shared groups hold the blocks
  of many entries (a device encode costs about the same per group whatever
  it holds), and computes every entry's crc32 with K2 + K3 from one upload,
  with one fetch (checksums.crc32_many).
* extract_all scans each deflated entry on the host and dispatches its
  decode (inflate_device_array_acc) back to back with no host sync, in
  passes of at most _PASS_BYTES of output on the card; stored entries get
  their crc32 on the card too. One fetch brings every adler32 and raw CRC
  of a pass; each is checked against its scan and its central-directory
  record before any of the pass's files is written.
"""

from __future__ import annotations

import mmap
import os
import shutil
import struct
import time as _time
from dataclasses import dataclass, field
from datetime import datetime
from typing import NamedTuple

import torch

from .common import ZippyError, resolve_device
from .ops import checksums, deflate_device
from .ops import inflate_device as idev

FILE_HEADER_LEN = 30
FILE_HEADER_SIG = 0x04034B50
CENTRAL_DIR_SIG = 0x02014B50
EOCD_SIG = 0x06054B50
ZIP64_EOCD_SIG = 0x06064B50
ZIP64_EOCD_LOCATOR_SIG = 0x07064B50
ZIP64_EXTRA_FIELD_ID = 1

S_IFDIR = 0o040000

# The decoded bytes one dispatch pass of extract_all (and of the v1
# ZipArchive.open) holds on the card before its one fetch.
_PASS_BYTES = 1 << 30


def verify_path_is_safe_to_extract(path: str) -> None:
    """Zip-slip defense (reference internal.nim:294-302)."""
    if os.path.isabs(path) or (len(path) > 1 and path[1] == ":"):
        raise ZippyError(f"Absolute path not allowed {path}")
    if path.startswith("../") or path.startswith("..\\"):
        raise ZippyError(f"Path ../ not allowed {path}")
    if "/../" in path or "\\..\\" in path:
        raise ZippyError(f"Path /../ not allowed {path}")


def parse_ms_dos_datetime(time_v: int, date_v: int) -> float | None:
    """MS-DOS timestamp -> epoch seconds, local time (ziparchives.nim:98-115)."""
    seconds = (time_v & 0b11111) * 2
    minutes = (time_v >> 5) & 0b111111
    hours = (time_v >> 11) & 0b11111
    days = date_v & 0b11111
    months = (date_v >> 5) & 0b1111
    years = (date_v >> 9) & 0b1111111
    if seconds <= 59 and minutes <= 59 and hours <= 23:
        try:
            return datetime(
                years + 1980, months, days, hours, minutes, seconds
            ).timestamp()
        except ValueError:
            return None
    return None


def to_ms_dos(epoch: float) -> tuple[int, int]:
    dt = datetime.fromtimestamp(epoch)
    t = (dt.second // 2) | (dt.minute << 5) | (dt.hour << 11)
    d = dt.day | (dt.month << 5) | (max(0, dt.year - 1980) << 9)
    return t, d


def utf8ify(file_name: bytes) -> str:
    """Decode a zip filename: UTF-8 if valid, else CP437 (OEM/DOS)."""
    try:
        return file_name.decode("utf-8")
    except UnicodeDecodeError:
        return file_name.decode("cp437")


# ---------------------------------------------------------------------------
# Entry decode on the card
# ---------------------------------------------------------------------------


class Entry(NamedTuple):
    """One entry's stored bytes and what its record says of them."""

    name: str
    payload: bytes          # the entry's bytes as stored in the archive
    method: int             # 0 stored, 8 deflated
    crc32: int
    size: int               # uncompressed


def passes(items: list, size) -> list:
    """`items` cut into runs in order, each of at most _PASS_BYTES by
    `size(item)` (an item larger than that makes a run of its own)."""
    out, run, held = [], [], 0
    for item in items:
        n = size(item)
        if run and held + n > _PASS_BYTES:
            out.append(run)
            run, held = [], 0
        run.append(item)
        held += n
    return out + [run] if run else out


def decode_entries(entries: list, device) -> list[bytes]:
    """The uncompressed bytes of each Entry, checked, from one dispatch pass
    on `device` (a torch.device) and one fetch of every checksum.

    A deflated entry is scanned on the host (its output length must be its
    record's size before anything is dispatched) and its decode dispatched
    with its adler32 (K1) and raw CRC (K2 + K3) left on the card, back to
    back with no host sync; the stored entries go up in one upload for
    their raw CRCs. Then every sum comes back in one copy: a decode's
    adler32 must equal its scan's, every entry's crc32 its record's. The
    decoded bytes come back in one more copy once every check has passed.
    Malformed or corrupt entries raise ZippyError."""
    sums = [[None, None] for _ in entries]   # adler32, raw CRC tensors
    want_adler = {}
    decoded = []            # (entry number, uint8 tensor on the card)
    stored = [i for i, e in enumerate(entries) if e.method == 0 and e.payload]
    views, keep = checksums.upload_packed(
        [entries[i].payload for i in stored], device)
    for i, view in zip(stored, views):
        sums[i][1] = checksums.crc32_raw_tensor(view)
    for i, e in enumerate(entries):
        if e.method == 0:
            if len(e.payload) != e.size:
                raise ZippyError(f"Size verification of {e.name} failed")
            continue
        if e.method != 8:
            raise ZippyError("Unsupported archive, compression method")
        index = idev.build_decode_index(e.payload)
        if index["total_out"] != e.size:
            raise ZippyError(f"Size verification of {e.name} failed")
        buf, _, adler_t, crc_t, kept = idev.inflate_device_array_acc(
            e.payload, index, device)
        keep += kept
        sums[i] = [adler_t, crc_t]
        want_adler[i] = int(index["adler"])
        decoded.append((i, buf))
    flat = [t for pair in sums for t in pair if t is not None]
    got = iter(torch.cat(flat).tolist() if flat else [])
    del keep
    for i, (e, (adler_t, crc_t)) in enumerate(zip(entries, sums)):
        if adler_t is not None:
            idev.check_sums(e.size, next(got), None, want_adler[i])
        raw = next(got) if crc_t is not None else 0
        if checksums.crc32_finish(raw, e.size) != e.crc32:
            raise ZippyError(f"Verifying crc32 of {e.name} failed")
    out = [e.payload if e.method == 0 else b"" for e in entries]
    if decoded:
        host = torch.cat([buf for _, buf in decoded]).cpu().numpy()
        off = 0
        for i, _ in decoded:
            out[i] = host[off:off + entries[i].size].tobytes()
            off += entries[i].size
    return out


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


@dataclass
class ZipArchiveRecord:
    kind: str  # "file" | "directory"
    file_header_offset: int
    path: str
    uncompressed_crc32: int
    compressed_size: int
    uncompressed_size: int
    permissions: int  # unix mode bits (0 = unset)


class ZipArchiveReader:
    """Memory-mapped zip reader (reference ZipArchiveReader). Entries decode
    on `device` (None: the CUDA card; "cpu" runs the plain versions)."""

    def __init__(self, zip_path: str | os.PathLike, device=None):
        self.device = resolve_device(device)
        self._mem = None
        self._file = open(zip_path, "rb")
        try:
            self._mem = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:
            self._file.close()
            raise ZippyError("Invalid zip archive (empty file)") from None
        self.records: dict[str, ZipArchiveRecord] = {}
        try:
            self._parse_central_directory()
        except Exception:
            self.close()
            raise

    # -- context manager -----------------------------------------------------
    def __enter__(self) -> "ZipArchiveReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._mem is not None:
            self._mem.close()
            self._mem = None
        if self._file is not None:
            self._file.close()
            self._file = None

    # -- parsing -------------------------------------------------------------
    def _find_eocd(self) -> int:
        """Backwards scan for the EOCD signature (ziparchives.nim:157-167)."""
        src = self._mem
        pos = len(src) - 22
        sig = struct.pack("<I", EOCD_SIG)
        while pos >= 0:
            hit = src.rfind(sig, 0, pos + 4)
            if hit < 0:
                break
            return hit
        raise ZippyError("Attempted to read past end of file")

    def _find_socd(self, start: int, num_records: int) -> int:
        """Backwards scan counting CD headers (ziparchives.nim:169-184)."""
        src = self._mem
        sig = struct.pack("<I", CENTRAL_DIR_SIG)
        pos = start
        found = 0
        while pos >= 0:
            hit = src.rfind(sig, 0, pos + 4)
            if hit < 0:
                raise ZippyError("Attempted to read past end of file")
            found += 1
            if found == num_records:
                return hit
            pos = hit - 1
        raise ZippyError("Attempted to read past end of file")

    def _parse_central_directory(self) -> None:
        src = self._mem
        size = len(src)
        eocd = self._find_eocd()
        if eocd + 22 > size:
            raise ZippyError("Attempted to read past end of file")

        zip64 = (
            eocd - 20 >= 0
            and struct.unpack_from("<I", src, eocd - 20)[0]
            == ZIP64_EOCD_LOCATOR_SIG
        )

        if zip64:
            z64_disk, z64_start, num_disks = struct.unpack_from(
                "<IQI", src, eocd - 20 + 4
            )
            if z64_disk != 0:
                raise ZippyError("Unsupported archive, disk number")
            if num_disks != 1:
                raise ZippyError("Unsupported archive, num disks")
            pos = z64_start
            if pos + 64 > size:
                raise ZippyError("Attempted to read past end of file")
            if struct.unpack_from("<I", src, pos)[0] != ZIP64_EOCD_SIG:
                raise ZippyError("Invalid central directory file header")
            disk_number, start_disk = struct.unpack_from("<II", src, pos + 16)
            n_disk, n_total, cd_size, cd_start = struct.unpack_from(
                "<QQQQ", src, pos + 24
            )
        else:
            disk_number, start_disk, n_disk, n_total, cd_size, cd_start = (
                struct.unpack_from("<HHHHII", src, eocd + 4)
            )

        if disk_number != 0:
            raise ZippyError("Unsupported archive, disk number")
        if start_disk != 0:
            raise ZippyError("Unsupported archive, start disk")
        if n_disk != n_total:
            raise ZippyError("Unsupported archive, record number")

        # Concatenated-zip support: locate the CD relative to the file end
        # (ziparchives.nim:258-267).
        try:
            socd = self._find_socd(eocd, n_total) if n_total else cd_start
        except ZippyError:
            socd = cd_start
        socd_offset = socd - cd_start

        pos = socd_offset + cd_start
        for _ in range(n_total):
            if pos + 46 > size:
                raise ZippyError("Attempted to read past end of file")
            (sig, _vmb, _mve, gp_flag, method, mtime, mdate, crc,
             compressed_size, uncompressed_size, name_len, extra_len,
             comment_len, file_disk, _iattr, eattr, header_off) = (
                struct.unpack_from("<IHHHHHHIIIHHHHHII", src, pos)
            )
            if sig != CENTRAL_DIR_SIG:
                raise ZippyError("Invalid central directory file header")
            if method not in (0, 8):
                raise ZippyError("Unsupported archive, compression method")
            if file_disk != 0:
                raise ZippyError("Invalid file disk number")

            pos += 46
            if pos + name_len > size:
                raise ZippyError("Attempted to read past end of file")
            raw_name = src[pos : pos + name_len]
            pos += name_len

            # zip64 extra fields (ziparchives.nim:320-356)
            ef_pos, ef_end = pos, pos + extra_len
            while ef_pos + 4 <= ef_end:
                field_id, field_len = struct.unpack_from("<HH", src, ef_pos)
                ef_pos += 4
                if field_id != ZIP64_EXTRA_FIELD_ID:
                    ef_pos += field_len
                    continue
                z = ef_pos
                if uncompressed_size == 0xFFFFFFFF:
                    if z + 8 > ef_pos + field_len:
                        raise ZippyError("Attempted to read past end of file")
                    uncompressed_size = struct.unpack_from("<Q", src, z)[0]
                    z += 8
                if compressed_size == 0xFFFFFFFF:
                    if z + 8 > ef_pos + field_len:
                        raise ZippyError("Attempted to read past end of file")
                    compressed_size = struct.unpack_from("<Q", src, z)[0]
                    z += 8
                if header_off == 0xFFFFFFFF:
                    if z + 8 > ef_pos + field_len:
                        raise ZippyError("Attempted to read past end of file")
                    header_off = struct.unpack_from("<Q", src, z)[0]
                    z += 8
                break
            pos = ef_end + comment_len

            if pos > socd_offset + cd_start + cd_size:
                raise ZippyError("Invalid central directory size")

            if gp_flag & (1 << 11):  # EFS: name is UTF-8
                name = raw_name.decode("utf-8", errors="replace")
            else:
                name = utf8ify(raw_name)

            if name in self.records:
                raise ZippyError("Unsupported archive, duplicate entry")

            dos_dir = (eattr & 0x10) != 0
            unix_dir = (eattr & (S_IFDIR << 16)) != 0
            kind = (
                "directory"
                if dos_dir or unix_dir or name.endswith("/")
                else "file"
            )
            self.records[name] = ZipArchiveRecord(
                kind=kind,
                file_header_offset=header_off + socd_offset,
                path=name,
                uncompressed_crc32=crc,
                compressed_size=compressed_size,
                uncompressed_size=uncompressed_size,
                permissions=(eattr >> 16) & 0o7777,
            )

    # -- access --------------------------------------------------------------
    def walk_files(self):
        """Yields file (not directory) paths in archive order."""
        for record in self.records.values():
            if record.kind == "file":
                yield record.path

    def _entry(self, record: ZipArchiveRecord) -> Entry:
        """A file record's stored bytes and method, from its local header."""
        src = self._mem
        pos = record.file_header_offset
        if pos + FILE_HEADER_LEN > len(src):
            raise ZippyError("Attempted to read past end of file")
        sig, _mve, _gp, method = struct.unpack_from("<IHHH", src, pos)
        if sig != FILE_HEADER_SIG:
            raise ZippyError("Invalid file header")
        name_len, extra_len = struct.unpack_from("<HH", src, pos + 26)
        pos += FILE_HEADER_LEN + name_len + extra_len
        if pos + record.compressed_size > len(src):
            raise ZippyError("Attempted to read past end of file")
        if record.kind != "file":
            raise ZippyError(f"No file record found for {record.path}")
        if method not in (0, 8):
            raise ZippyError("Unsupported archive, compression method")
        return Entry(record.path, src[pos : pos + record.compressed_size],
                     method, record.uncompressed_crc32,
                     record.uncompressed_size)

    def extract_file(self, path: str) -> bytes:
        """Decompress one entry on the card and verify its crc32 there
        (ziparchives.nim:39-93): one decode, one fetch of its sums."""
        record = self.records.get(path)
        if record is None:
            raise ZippyError(f"No file record found for {path}")
        return decode_entries([self._entry(record)], self.device)[0]

    def _record_mtime(self, record: ZipArchiveRecord) -> float | None:
        t, d = struct.unpack_from("<HH", self._mem,
                                  record.file_header_offset + 10)
        return parse_ms_dos_datetime(t, d)


def open_zip_archive(zip_path: str | os.PathLike,
                     device=None) -> ZipArchiveReader:
    return ZipArchiveReader(zip_path, device)


def extract_all(zip_path: str | os.PathLike, dest: str | os.PathLike,
                device=None) -> None:
    """Extract to `dest` (must not exist; parent must). ziparchives.nim:398.

    Every path is checked before anything is written. The files decode on
    `device` (None: the CUDA card; "cpu" runs the plain versions) in passes
    of decode_entries, and a pass's files are written once all its checks
    have passed. On any error `dest` is removed."""
    device = resolve_device(device)
    dest = os.fspath(dest)
    if dest == "" or os.path.isdir(dest):
        raise ZippyError(f"Destination {dest} already exists")
    head = os.path.dirname(dest.rstrip("/"))
    if head and not os.path.isdir(head):
        raise ZippyError(f"Path to {dest} does not exist")

    with open_zip_archive(zip_path, device) as reader:
        for record in reader.records.values():
            verify_path_is_safe_to_extract(record.path)
        try:
            files = []
            for record in reader.records.values():
                target = os.path.join(dest, record.path)
                if record.kind == "directory":
                    os.makedirs(target, exist_ok=True)
                else:
                    os.makedirs(os.path.dirname(target) or dest, exist_ok=True)
                    files.append((record, target))
            for run in passes(files, lambda f: f[0].uncompressed_size):
                datas = decode_entries([reader._entry(r) for r, _ in run],
                                       device)
                for (record, target), data in zip(run, datas):
                    with open(target, "wb") as f:
                        f.write(data)
                    if record.permissions:
                        os.chmod(target, record.permissions)
            # Second pass for mtimes (ziparchives.nim:432-439).
            for record in reader.records.values():
                mtime = reader._record_mtime(record)
                if mtime is not None:
                    target = os.path.join(dest, record.path)
                    os.utime(target, (mtime, mtime))
        except Exception:
            shutil.rmtree(dest, ignore_errors=True)
            raise


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


@dataclass
class _WrittenEntry:
    file_header_offset: int
    uncompressed_len: int
    compressed_len: int
    compression_method: int
    uncompressed_crc32: int
    name: bytes = field(default=b"")


def create_zip_archive(entries: dict[str, bytes | str],
                       device=None) -> bytes:
    """In-memory zip from {path: contents}; always zip64, entries compressed
    at BestSpeed (reference ziparchives.nim:455-634), on `device` (None: the
    CUDA card; "cpu" runs the plain versions): every non-empty entry in one
    deflate_entries call, every crc32 from one upload and one fetch. Empty
    entries are stored, with no device work."""
    device = resolve_device(device)
    lm_time, lm_date = to_ms_dos(_time.time())

    items: list[tuple[str, bytes]] = []
    for file_name, contents in entries.items():
        if file_name == "":
            raise ZippyError("Invalid empty file name")
        if file_name[0] == "/":
            raise ZippyError("File paths must be relative")
        if len(file_name.encode()) > 0xFFFF:
            raise ZippyError("File name len > uint16.high")
        if isinstance(contents, str):
            contents = contents.encode("utf-8")
        items.append((file_name, contents))

    crcs = checksums.crc32_many([c for _, c in items], device)
    streams = iter(deflate_device.deflate_entries(
        [c for _, c in items if c], 1, device=device))
    compressed = [(next(streams), 8, crc) if contents else (b"", 0, crc)
                  for (_, contents), crc in zip(items, crcs)]

    out = bytearray()
    records: list[_WrittenEntry] = []
    for (file_name, contents), (comp, method, crc) in zip(items, compressed):
        name_b = file_name.encode("utf-8")
        records.append(_WrittenEntry(
            file_header_offset=len(out),
            uncompressed_len=len(contents),
            compressed_len=len(comp),
            compression_method=method,
            uncompressed_crc32=crc,
            name=name_b,
        ))
        out += struct.pack(
            "<IHHHHHIIIHH", FILE_HEADER_SIG, 45, 1 << 11, method,
            lm_time, lm_date, crc, 0xFFFFFFFF, 0xFFFFFFFF, len(name_b), 20,
        )
        out += name_b
        out += struct.pack("<HHQQ", ZIP64_EXTRA_FIELD_ID, 16,
                           len(contents), len(comp))
        out += comp

    cd_start = len(out)
    for r in records:
        out += struct.pack(
            "<IHHHHHHIIIHHHHHII", CENTRAL_DIR_SIG, 45, 45, 1 << 11,
            r.compression_method, lm_time, lm_date, r.uncompressed_crc32,
            0xFFFFFFFF, 0xFFFFFFFF, len(r.name), 28, 0, 0, 0, 0, 0xFFFFFFFF,
        )
        out += r.name
        out += struct.pack("<HHQQQ", ZIP64_EXTRA_FIELD_ID, 24,
                           r.uncompressed_len, r.compressed_len,
                           r.file_header_offset)
    cd_end = len(out)

    out += struct.pack("<IQHHIIQQQQ", ZIP64_EOCD_SIG, 44, 45, 45, 0, 0,
                       len(records), len(records), cd_end - cd_start, cd_start)
    out += struct.pack("<IIQI", ZIP64_EOCD_LOCATOR_SIG, 0, cd_end, 1)
    out += struct.pack("<IHHHHIIH", EOCD_SIG, 0, 0, 0xFFFF, 0xFFFF,
                       0xFFFFFFFF, 0xFFFFFFFF, 0)
    return bytes(out)
