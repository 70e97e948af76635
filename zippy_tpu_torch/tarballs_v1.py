"""In-memory Tarball API (legacy v1 compatibility): the port of
zippy_tpu/tarballs_v1.py, with a .tar.gz written and read on the card
(api.compress at DefaultCompression, level 6's matcher; api.uncompress).

Parity reference: zippy's src/zippy/tarballs_v1.nim, through
zippy_tpu.tarballs_v1 — Tarball with
ordered `contents`, open() with tfDetect/gzip sniff (:79-96), parse loop
files+dirs only (:98-157), writeTarball ustar writer with checksum
(:203-271; prefix>=155 / name>=100 rejected :218-227, mode hardcoded 000777
:232), addDir FS walk (:21-56), extractAll (:273-331), createTarball
(:333-342). Extension selects format: .tar plain, .gz/.taz/.tgz gzip.
"""

from __future__ import annotations

import enum
import os
import shutil

from . import api
from .common import DefaultCompression, ZippyError, dfGzip, resolve_device
from .tarballs import parse_tar_oct_int
from .ziparchives import verify_path_is_safe_to_extract


class TarballFormat(enum.Enum):
    DETECT = "detect"
    UNCOMPRESSED = "uncompressed"
    GZIP = "gzip"


tfDetect = TarballFormat.DETECT
tfUncompressed = TarballFormat.UNCOMPRESSED
tfGzip = TarballFormat.GZIP


class TarballEntry:
    __slots__ = ("kind", "contents", "last_modified", "permissions")

    def __init__(self, kind: str = "0", contents: bytes = b"",
                 last_modified: float = 0.0, permissions: int = 0):
        self.kind = kind  # "0" file | "5" directory
        self.contents = contents
        self.last_modified = last_modified
        self.permissions = permissions


def _to_unix(path: str) -> str:
    return path.replace(os.sep, "/") if os.sep != "/" else path


class Tarball:
    """Eagerly-loaded tar contents table (reference Tarball ref object)."""

    def __init__(self):
        self.contents: dict[str, TarballEntry] = {}

    def clear(self) -> None:
        self.contents.clear()

    # -- ingestion -----------------------------------------------------------
    def _add_dir(self, base: str, relative: str) -> None:
        full = os.path.join(base, relative) if relative else base
        if not (os.path.isfile(full) or os.path.isdir(full)):
            raise ZippyError(f"Path {full} does not exist")
        if relative and _to_unix(relative) not in self.contents:
            self.contents[_to_unix(relative)] = TarballEntry(kind="5")
        for name in sorted(os.listdir(full)):
            rel = os.path.join(relative, name) if relative else name
            p = os.path.join(base, rel)
            if os.path.islink(p):
                continue
            if os.path.isfile(p):
                st = os.stat(p)
                with open(p, "rb") as f:
                    self.contents[_to_unix(rel)] = TarballEntry(
                        kind="0", contents=f.read(),
                        last_modified=st.st_mtime,
                        permissions=st.st_mode & 0o7777,
                    )
            elif os.path.isdir(p):
                self._add_dir(base, rel)

    def add_dir(self, directory: str) -> None:
        """Recursively add all files/dirs inside `directory`."""
        if os.path.splitext(directory)[1]:
            raise ZippyError(
                f"Error adding dir {directory} to tarball, appears to be a file?"
            )
        head, tail = os.path.split(directory.rstrip("/"))
        self._add_dir(head or ".", tail)

    # -- parsing -------------------------------------------------------------
    def open(self, src, tar_format: TarballFormat = tfDetect,
             device=None) -> None:
        """Read a tarball from a path, bytes, or binary file object; a
        gzip tarball decodes on `device` (None: the CUDA card; "cpu" runs
        the plain versions)."""
        device = resolve_device(device)
        self.clear()
        if isinstance(src, (str, os.PathLike)):
            with open(src, "rb") as f:
                data = f.read()
        elif isinstance(src, (bytes, bytearray)):
            data = bytes(src)
        else:
            data = src.read()

        if tar_format == tfDetect:
            if data[:1] == b"\x1f":
                if data[1:2] == b"\x8b":
                    tar_format = tfGzip
                else:
                    raise ZippyError("Unsupported tarball format")
            else:
                tar_format = tfUncompressed
        if tar_format == tfGzip:
            data = api.uncompress(data, dfGzip, device=device)

        pos = 0
        while pos < len(data):
            if pos + 512 > len(data):
                raise ZippyError(
                    "Attempted to read past end of file, corrupted tarball?"
                )
            header = data[pos : pos + 512]
            pos += 512
            nul = header.find(b"\x00", 0, 100)
            file_name = (header[:100] if nul < 0 else header[:nul]).decode(
                "utf-8", errors="surrogateescape"
            )
            if not file_name:
                continue
            file_size = parse_tar_oct_int(header[124:135])
            last_modified = parse_tar_oct_int(header[136:147])
            typeflag = chr(header[156])
            file_mode = parse_tar_oct_int(header[100:106])
            prefix = ""
            if header[257:263] == b"ustar\x00":
                pnul = header.find(b"\x00", 345, 500)
                prefix = header[345 : pnul if 345 <= pnul < 500 else 500].decode(
                    "utf-8", errors="surrogateescape"
                )
            if pos + file_size > len(data):
                raise ZippyError(
                    "Attempted to read past end of file, corrupted tarball?"
                )
            path = _to_unix(os.path.join(prefix, file_name) if prefix
                            else file_name)
            if typeflag in ("0", "\x00"):
                self.contents[path] = TarballEntry(
                    kind="0", contents=data[pos : pos + file_size],
                    last_modified=float(last_modified),
                    permissions=file_mode & 0o7777,
                )
            elif typeflag == "5":
                self.contents[path] = TarballEntry(kind="5")
            pos += (file_size + 511) & ~511

    # -- writing -------------------------------------------------------------
    def write_tarball(self, path: str, device=None) -> None:
        """Write contents as .tar / .tar.gz / .taz / .tgz by extension
        (reference tarballs_v1.nim:203-271); a gzip tarball is compressed
        on `device` (None: the CUDA card; "cpu" runs the plain versions)."""
        device = resolve_device(device)
        if not self.contents:
            raise ZippyError("Tarball has no contents")

        def oct_field(v: int, width: int) -> bytes:
            return f"{v:0{width}o}".encode()

        data = bytearray()
        for entry_path, entry in self.contents.items():
            head, tail = os.path.split(entry_path.rstrip("/"))
            if entry.kind == "5" and entry_path.endswith("/"):
                tail += "/"
            if len(head) >= 155:
                raise ZippyError(
                    f"File path {head} too long, must be < 155 characters"
                )
            if len(tail) >= 100:
                raise ZippyError(
                    f"File name {tail} too long, must be < 100 characters"
                )
            header = bytearray(512)
            name_b = tail.encode("utf-8", errors="surrogateescape")
            header[0 : len(name_b)] = name_b
            header[100:108] = b"000777 \x00"  # mode (hardcoded like reference)
            header[108:116] = oct_field(0, 6) + b" \x00"  # uid
            header[116:124] = oct_field(0, 6) + b" \x00"  # gid
            header[124:136] = oct_field(len(entry.contents), 11) + b" "
            header[136:148] = oct_field(int(entry.last_modified), 11) + b" "
            header[148:156] = b"        "  # checksum placeholder
            header[156] = ord(entry.kind)
            header[257:263] = b"ustar\x00"
            header[263:265] = oct_field(0, 2)
            header[329:337] = oct_field(0, 6) + b"\x00 "  # dev major
            header[337:345] = oct_field(0, 6) + b"\x00 "  # dev minor
            prefix_b = head.encode("utf-8", errors="surrogateescape")
            header[345 : 345 + len(prefix_b)] = prefix_b
            checksum = sum(header)
            header[148:155] = oct_field(checksum, 6) + b"\x00"
            data += header
            data += entry.contents
            pad = (-len(data)) % 512
            data += b"\x00" * pad
        data += b"\x00" * 1024  # two zero-filled end records

        ext = os.path.splitext(path)[1]
        if ext == ".tar":
            payload = bytes(data)
        elif ext in (".gz", ".taz", ".tgz"):
            payload = api.compress(bytes(data), DefaultCompression, dfGzip,
                                   device=device)
        else:
            raise ZippyError(f"Unsupported tarball extension {ext}")
        with open(path, "wb") as f:
            f.write(payload)

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
                if entry.kind == "0":
                    os.makedirs(os.path.dirname(target) or dest, exist_ok=True)
                    with open(target, "wb") as f:
                        f.write(entry.contents)
                    if entry.last_modified > 0:
                        os.utime(target, (entry.last_modified,
                                          entry.last_modified))
                    if entry.permissions:
                        os.chmod(target, entry.permissions)
                else:
                    os.makedirs(target, exist_ok=True)
        except Exception:
            shutil.rmtree(dest, ignore_errors=True)
            raise


def create_tarball(source: str, dest: str, device=None) -> None:
    """Archive everything inside `source` to `dest` (format by extension),
    a gzip tarball compressed on `device` (None: the CUDA card)."""
    tarball = Tarball()
    tarball.add_dir(source)
    tarball.write_tarball(dest, device)
