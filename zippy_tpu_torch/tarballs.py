"""Tarball (.tar / .tar.gz) extraction (the current API): the port of
zippy_tpu/tarballs.py, with a .tar.gz decoded on the card.

Parity reference: zippy's src/zippy/tarballs.nim, through
zippy_tpu.tarballs: memory-mapped read, gzip sniff (:48-54), whole-archive
inflate (:50), 512-byte ustar header walk (:66-123) with lenient octal
parse (:5-23), typeflags: file '0'/NUL, dir '5', symlink '2', GNU longname
'L', pax/global 'g'/'x'/'A'-'Z' skipped, zip-slip defense, mtime second pass
(:125-129), delete-dest-on-error (:131-141).
"""

from __future__ import annotations

import mmap
import os
import shutil

from . import gzip_format
from .common import ZippyError, resolve_device
from .ziparchives import verify_path_is_safe_to_extract


def parse_tar_oct_int(s: bytes) -> int:
    """Lenient octal parse (reference tarballs.nim:5-23): skip leading
    non-digits, read the digit run, empty -> 0."""
    start = 0
    while start < len(s) and not (0x30 <= s[start] <= 0x39):
        start += 1
    end = start
    while end < len(s) and 0x30 <= s[end] <= 0x37:
        end += 1
    if end == start:
        # Any decimal digit terminates the scan in the reference; 8/9 in an
        # octal field is malformed.
        if start < len(s) and s[start] in (0x38, 0x39):
            raise ZippyError("Invalid octal value in tar header")
        return 0
    return int(s[start:end], 8)


def _cstr(b: bytes) -> bytes:
    nul = b.find(b"\x00")
    return b if nul < 0 else b[:nul]


def _read_archive(tar_path: str | os.PathLike, device):
    """Memory-map the archive (reference tarballs.nim:42, std/memfiles).

    A plain .tar is walked straight off the map. A .tar.gz is read into
    bytes and decoded on `device` by gzip_format.uncompress_parallel (the
    decode's host scan takes bytes through ctypes, and would copy the map
    once a member), so only the compressed and decoded copies are made."""
    with open(tar_path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size < 2:
            raise ZippyError("Invalid compressed data")
        m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    if m[0] == 31 and m[1] == 139:
        try:
            # Member by member when the stream carries a ZT index; the
            # whole stream otherwise.
            return gzip_format.uncompress_parallel(m[:], device)
        finally:
            m.close()
    return m


def iter_entries(tar_path: str | os.PathLike, device=None):
    """Yields (path, typeflag, contents, mode, mtime, linkname) per entry;
    a .tar.gz decodes on `device` (None: the CUDA card; "cpu" runs the
    plain versions).

    Shared parse loop for extract_all and the in-memory v1 API.
    """
    data = _read_archive(tar_path, resolve_device(device))
    try:
        yield from _iter_entries_buf(data)
    finally:
        if isinstance(data, mmap.mmap):
            data.close()


def _iter_entries_buf(data):
    long_file_name: str | None = None
    pos = 0
    while pos < len(data):
        if pos + 512 > len(data):
            raise ZippyError("Attempted to read past end of file")
        header = data[pos : pos + 512]
        if header == b"\x00" * 512:
            # End-of-archive marker blocks.
            pos += 512
            continue
        name = _cstr(header[0:100]).decode("utf-8", errors="surrogateescape")
        mode = parse_tar_oct_int(header[100:107])
        size = parse_tar_oct_int(header[124:135])
        mtime = parse_tar_oct_int(header[136:147])
        typeflag = chr(header[156])
        linkname = _cstr(header[157:257]).decode("utf-8",
                                                 errors="surrogateescape")
        magic = _cstr(header[257:263])
        prefix = ""
        if magic.rstrip(b" ") == b"ustar":
            prefix = _cstr(header[345:500]).decode("utf-8",
                                                   errors="surrogateescape")
        pos += 512
        if pos + size > len(data):
            raise ZippyError("Attempted to read past end of file")

        if name or long_file_name:
            if long_file_name is not None:
                path = long_file_name
                long_file_name = None
            else:
                path = os.path.join(prefix, name) if prefix else name

            if typeflag == "L":  # GNU long name: applies to the next entry
                long_file_name = data[pos : pos + size].rstrip(b"\x00").decode(
                    "utf-8", errors="surrogateescape"
                )
            elif typeflag in ("0", "\x00", "5", "2"):
                yield (path, typeflag, data[pos : pos + size], mode, mtime,
                       linkname)
            elif typeflag in ("g", "x") or ("A" <= typeflag <= "Z"):
                pass  # pax/global/vendor extensions: skipped
            else:
                raise ZippyError(f"Unsupported header type {typeflag}")

        pos += (size + 511) & ~511


def extract_all(tar_path: str | os.PathLike, dest: str | os.PathLike,
                device=None) -> None:
    """Extract to `dest` (must not exist; parent must). tarballs.nim:25.
    A .tar.gz decodes on `device` (None: the CUDA card; "cpu" runs the
    plain versions)."""
    device = resolve_device(device)
    dest = os.fspath(dest)
    if dest == "" or os.path.isdir(dest):
        raise ZippyError(f"Destination {dest} already exists")
    head = os.path.dirname(dest.rstrip("/"))
    if head and not os.path.isdir(head):
        raise ZippyError(f"Path to {dest} does not exist")

    try:
        mtimes: list[tuple[str, int]] = []
        for path, typeflag, contents, mode, mtime, linkname in iter_entries(
            tar_path, device
        ):
            verify_path_is_safe_to_extract(path)
            target = os.path.join(dest, path)
            if typeflag in ("0", "\x00"):
                os.makedirs(os.path.dirname(target) or dest, exist_ok=True)
                with open(target, "wb") as f:
                    f.write(contents)
                if mode:
                    os.chmod(target, mode & 0o7777)
                mtimes.append((path, mtime))
            elif typeflag == "5":
                os.makedirs(target, exist_ok=True)
                mtimes.append((path, mtime))
            elif typeflag == "2":
                os.makedirs(os.path.dirname(target) or dest, exist_ok=True)
                os.symlink(linkname, target)
        # Second pass for mtimes (tarballs.nim:125-129).
        for path, mtime in mtimes:
            if mtime > 0:
                os.utime(os.path.join(dest, path), (mtime, mtime))
    except Exception:
        shutil.rmtree(dest, ignore_errors=True)
        raise
