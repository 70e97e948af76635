"""In-memory ZipArchive API (legacy v1 compatibility): the port of
zippy_tpu/ziparchives_v1.py, with the codec work on the card.

Parity reference: zippy's src/zippy/ziparchives_v1.nim, through
zippy_tpu.ziparchives_v1: a forward-scan parser over local file headers
that rejects the data-descriptor bit and deflate64, eager decompress into
`ZipArchive.contents`, the non-zip64 writer, addDir/addFile, extractAll and
createZipArchive(source, dest).

As in ziparchives.py, the entries reach the codec together: `open` walks
the headers first and then decodes every entry in passes of
ziparchives.decode_entries (one dispatch pass and one fetch of the sums
each); `write_zip_archive` encodes every deflated entry in one
deflate_entries call and takes every crc32 from one fetch.
"""

from __future__ import annotations

import os
import shutil
import struct
import time as _time

from .common import ZippyError, resolve_device
from .ops import checksums, deflate_device
from .ziparchives import (
    Entry,
    decode_entries,
    parse_ms_dos_datetime,
    passes,
    to_ms_dos,
    verify_path_is_safe_to_extract,
)

_DEFAULT_PERMISSIONS = 0o664  # windows/absent-permission fallback (:86-96)


class ArchiveEntry:
    __slots__ = ("kind", "contents", "last_modified", "permissions")

    def __init__(self, kind: str = "file", contents: bytes = b"",
                 last_modified: float = 0.0, permissions: int = 0):
        self.kind = kind  # "file" | "directory"
        self.contents = contents
        self.last_modified = last_modified
        self.permissions = permissions


def _extract_permissions(external_file_attr: int) -> int:
    permissions = (external_file_attr >> 16) & 0xFFFF
    if permissions == 0:
        return _DEFAULT_PERMISSIONS
    return permissions & 0o7777


def _to_unix(path: str) -> str:
    return path.replace(os.sep, "/") if os.sep != "/" else path


class ZipArchive:
    """Eagerly-loaded zip contents table (reference ZipArchive ref object)."""

    def __init__(self):
        self.contents: dict[str, ArchiveEntry] = {}

    def clear(self) -> None:
        self.contents.clear()

    # -- ingestion -----------------------------------------------------------
    def _add_dir(self, base: str, relative: str) -> None:
        if relative and _to_unix(relative) + "/" not in self.contents:
            self.contents[_to_unix(relative) + "/"] = ArchiveEntry(
                kind="directory"
            )
        full = os.path.join(base, relative) if relative else base
        for name in sorted(os.listdir(full)):
            rel = os.path.join(relative, name) if relative else name
            p = os.path.join(base, rel)
            if os.path.islink(p):
                continue
            if os.path.isfile(p):
                st = os.stat(p)
                with open(p, "rb") as f:
                    self.contents[_to_unix(rel)] = ArchiveEntry(
                        kind="file", contents=f.read(),
                        last_modified=st.st_mtime,
                        permissions=st.st_mode & 0o7777,
                    )
            elif os.path.isdir(p):
                self._add_dir(base, rel)

    def add_dir(self, directory: str) -> None:
        """Recursively add all files/dirs inside `directory`."""
        head, tail = os.path.split(directory.rstrip("/"))
        self._add_dir(head or ".", tail)

    def add_file(self, path: str) -> None:
        st = os.stat(path)
        with open(path, "rb") as f:
            self.contents[_to_unix(os.path.basename(path))] = ArchiveEntry(
                kind="file", contents=f.read(), last_modified=st.st_mtime,
                permissions=st.st_mode & 0o7777,
            )

    # -- parsing -------------------------------------------------------------
    def open(self, src, device=None) -> None:
        """Forward-scan parse from a path, bytes, or binary file object; the
        entries decode on `device` (None: the CUDA card; "cpu" runs the
        plain versions) once the walk has reached the end record."""
        device = resolve_device(device)
        self.clear()
        if isinstance(src, (str, os.PathLike)):
            with open(src, "rb") as f:
                data = f.read()
        elif isinstance(src, (bytes, bytearray)):
            data = bytes(src)
        else:
            data = src.read()

        def fail_eof():
            raise ZippyError(
                "Attempted to read past end of file, corrupted zip archive?"
            )

        entries: list[tuple[str, Entry]] = []
        pos = 0
        while True:
            if pos + 4 > len(data):
                fail_eof()
            signature = struct.unpack_from("<I", data, pos)[0]
            if signature == 0x04034B50:  # local file header
                if pos + 30 > len(data):
                    fail_eof()
                (_sig, _mve, gp_flag, method, lm_time, lm_date, crc,
                 compressed_size, uncompressed_size, name_len, extra_len) = (
                    struct.unpack_from("<IHHHHHIIIHH", data, pos)
                )
                pos += 30
                if gp_flag & 0b100:
                    raise ZippyError(
                        "Unsupported zip archive, data descriptor bit set"
                    )
                if gp_flag & 0b1000:
                    raise ZippyError("Unsupported zip archive, uses deflate64")
                if pos + name_len + extra_len + compressed_size > len(data):
                    fail_eof()
                file_name = data[pos : pos + name_len].decode(
                    "utf-8", errors="surrogateescape"
                )
                pos += name_len + extra_len
                if method not in (0, 8):
                    raise ZippyError(
                        "Unsupported zip archive, compression method"
                    )
                path = _to_unix(file_name)
                entries.append((path, Entry(
                    file_name, data[pos : pos + compressed_size], method,
                    crc, uncompressed_size)))
                mtime = parse_ms_dos_datetime(lm_time, lm_date) or 0.0
                self.contents[path] = ArchiveEntry(
                    kind="file", last_modified=mtime,
                )
                pos += compressed_size
            elif signature == 0x02014B50:  # central directory header
                if pos + 46 > len(data):
                    fail_eof()
                name_len, extra_len, comment_len = struct.unpack_from(
                    "<HHH", data, pos + 28
                )
                eattr = struct.unpack_from("<I", data, pos + 38)[0]
                pos += 46
                if pos + name_len + extra_len + comment_len > len(data):
                    fail_eof()
                file_name = data[pos : pos + name_len].decode(
                    "utf-8", errors="surrogateescape"
                )
                pos += name_len + extra_len + comment_len
                entry = self.contents.get(_to_unix(file_name))
                if entry is None:
                    raise ZippyError("Unexpected error opening zip archive")
                if eattr & 0x10:
                    entry.kind = "directory"
                entry.permissions = _extract_permissions(eattr)
            elif signature == 0x06054B50:  # end of central directory
                if pos + 22 > len(data):
                    fail_eof()
                comment_len = struct.unpack_from("<H", data, pos + 20)[0]
                pos += 22
                if pos + comment_len > len(data):
                    fail_eof()
                break
            else:
                raise ZippyError("Unexpected error opening zip archive")

        for run in passes(entries, lambda e: e[1].size):
            for (path, _), contents in zip(
                    run, decode_entries([e for _, e in run], device)):
                self.contents[path].contents = contents

    # -- writing -------------------------------------------------------------
    def write_zip_archive(self, path: str, device=None) -> None:
        """Non-zip64 writer (reference ziparchives_v1.nim:371-486), the
        codec on `device` (None: the CUDA card; "cpu" runs the plain
        versions): every deflated entry in one deflate_entries call, every
        crc32 from one fetch."""
        device = resolve_device(device)
        if not self.contents:
            raise ZippyError("Zip archive has no contents")

        # Directories (no basename) and empty files are stored (reference
        # ziparchives_v1.nim:399-404).
        items = list(self.contents.items())
        deflated = [bool(os.path.basename(p)) and len(e.contents) > 0
                    for p, e in items]
        crcs = checksums.crc32_many([e.contents for _, e in items], device)
        streams = iter(deflate_device.deflate_entries(
            [e.contents for (_, e), d in zip(items, deflated) if d], 1,
            device=device))

        data = bytearray()
        values: dict[str, tuple[int, int, int, int, int]] = {}
        for (entry_path, entry), crc, d in zip(items, crcs, deflated):
            offset = len(data)
            name_b = entry_path.encode("utf-8", errors="surrogateescape")
            if d:
                method, compressed = 8, next(streams)
            else:
                method, compressed = 0, entry.contents
            data += struct.pack(
                "<IHHHHHIIIHH", 0x04034B50, 20, 1 << 11, method, 0, 0, crc,
                len(compressed), len(entry.contents), len(name_b), 0,
            )
            data += name_b
            data += compressed
            values[entry_path] = (offset, crc, len(compressed),
                                  len(entry.contents), method)

        cd_offset = len(data)
        cd_size = 0
        for entry_path, entry in self.contents.items():
            offset, crc, clen, ulen, method = values[entry_path]
            name_b = entry_path.encode("utf-8", errors="surrogateescape")
            lm_time, lm_date = to_ms_dos(entry.last_modified or _time.time())
            eattr = 0x10 if entry.kind == "directory" else 0x20
            data += struct.pack(
                "<IHHHHHHIIIHHHHHII", 0x02014B50, 63, 20, 1 << 11, method,
                lm_time, lm_date, crc, clen, ulen, len(name_b), 0, 0, 0, 0,
                eattr, offset,
            )
            data += name_b
            cd_size += 46 + len(name_b)

        data += struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, len(self.contents),
                            len(self.contents), cd_size, cd_offset, 0)
        with open(path, "wb") as f:
            f.write(data)

    # -- extraction ----------------------------------------------------------
    def extract_all(self, dest: str) -> None:
        if os.path.isdir(dest):
            raise ZippyError(f"Destination {dest} already exists")
        head, tail = os.path.split(dest.rstrip("/"))
        if tail and head and not os.path.isdir(head):
            raise ZippyError(f"Path to destination {dest} does not exist")
        try:
            for path, entry in self.contents.items():
                verify_path_is_safe_to_extract(path)
                target = os.path.join(dest, path)
                if entry.kind == "directory":
                    os.makedirs(target, exist_ok=True)
                else:
                    os.makedirs(os.path.dirname(target) or dest, exist_ok=True)
                    with open(target, "wb") as f:
                        f.write(entry.contents)
                    if entry.last_modified > 0:
                        os.utime(target, (entry.last_modified,
                                          entry.last_modified))
                    if entry.permissions:
                        os.chmod(target, entry.permissions)
        except Exception:
            shutil.rmtree(dest, ignore_errors=True)
            raise


def create_zip_archive(source: str, dest: str, device=None) -> None:
    """Archive everything inside `source` and write the zip to `dest`, the
    codec on `device` (None: the CUDA card)."""
    archive = ZipArchive()
    archive.add_dir(source)
    archive.write_zip_archive(dest, device)
