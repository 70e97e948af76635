"""zippy_tpu_torch's archive layer on the CPU: the batched entry encode
(deflate_entries) against the per-payload encode byte for byte, and zip and
tar archives read and written by the port, by zippy_tpu and by CPython's
zipfile and tarfile in each direction.

The archive-level encodes run in 4 KiB blocks and small groups (the
`small_blocks` fixture), so that a few KiB payloads stay cheap on the CPU;
the byte-identity test calls deflate_entries with its block size itself.
The non-corpus cases of tests/test_archives.py are mirrored one for one
(same names, prefixed `test_port_`).
"""

import functools
import io
import os
import pathlib
import struct
import subprocess
import tarfile
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zippy_tpu  # noqa: E402
from zippy_tpu import tarballs as ref_tarballs  # noqa: E402
from zippy_tpu import tarballs_v1 as ref_tarballs_v1  # noqa: E402
from zippy_tpu import ziparchives as ref_ziparchives  # noqa: E402
from zippy_tpu import ziparchives_v1 as ref_ziparchives_v1  # noqa: E402
import zippy_tpu_torch as zt  # noqa: E402
from zippy_tpu_torch import tarballs, tarballs_v1  # noqa: E402
from zippy_tpu_torch import ziparchives, ziparchives_v1  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import checksums  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402
from zippy_tpu_torch.ops import inflate_device as idev  # noqa: E402
from _torch_parity import mixed_payload, one_thread, random_bytes  # noqa: E402,F401

CPU = "cpu"
ENTRY_LENGTHS = [0, 1, 255, 4095, 4096, 4097, 3 * 4096 + 5]


@pytest.fixture
def small_blocks(monkeypatch):
    """Archive encodes in 4 KiB blocks, a few rows a group."""
    monkeypatch.setattr(td, "deflate_entries", functools.partial(
        td.deflate_entries, block_size=4096))
    monkeypatch.setattr(td, "GROUP_BYTES", 64 << 20)


pytestmark = pytest.mark.usefixtures("one_thread", "small_blocks")


def _tree_files(root: pathlib.Path) -> dict[str, bytes]:
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        if p.is_file():
            out[rel] = p.read_bytes()
    return out


def _entries() -> dict[str, bytes]:
    """A few KiB of each kind: text, random bytes (stored blocks), empty,
    nested and non-ASCII names, one entry of several blocks."""
    return {
        "readme.txt": b"hello zip",
        "dir/data.bin": bytes(range(256)) * 100,
        "empty.txt": b"",
        "unicode-é中.txt": "text contents".encode(),
        "dir/sub/noise.bin": random_bytes(3000, 5),
        "long.txt": mixed_payload(3 * 4096 + 5, seed=7),
    }


def _zip_file(tmp_path, blob: bytes, name: str = "a.zip") -> pathlib.Path:
    p = tmp_path / name
    p.write_bytes(blob)
    return p


def _tree(root: pathlib.Path) -> dict[str, bytes]:
    """Write _entries() under root; return them."""
    entries = _entries()
    for name, data in entries.items():
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        (root / name).write_bytes(data)
    return entries


# ---------------------------------------------------------------------------
# deflate_entries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [1, 6, -2, 0])
def test_deflate_entries_equal_per_payload_deflate(level, monkeypatch):
    """Each stream equals deflate() of its payload alone, with the rows of
    every payload spread over several shared groups of each kind (no
    history for single-block payloads, HIST for longer ones)."""
    payloads = [mixed_payload(n, seed=n) for n in ENTRY_LENGTHS]
    payloads += [random_bytes(4097, 11), "text " * 900]
    want = [td.deflate(p, level, 4096, device=CPU) for p in payloads]
    k = td._level_params(1 if level == -2 else level)[0]
    words = k * (td.NRANK if k >= 4 else td.NWIN) + 3 * td.NWIN + td.EXTW
    monkeypatch.setattr(td, "GROUP_BYTES", 3 * 4096 * words * 12)
    assert td._group_size(k, 4096) == 3
    groups = []
    issue = td._issue_entry_group
    monkeypatch.setattr(td, "_issue_entry_group",
                        lambda p, rows, *a: groups.append(len(rows))
                        or issue(p, rows, *a))
    got = td.deflate_entries(payloads, level, block_size=4096, device=CPU)
    assert got == want
    if level != 0:
        rows = sum(-(-len(p) // 4096) for p in payloads)
        assert sum(groups) == rows and len(groups) > 2
        assert max(groups) == 3


def test_deflate_entries_rejects_bad_input():
    with pytest.raises(ZippyError):
        td.deflate_entries([b"x"], 11, device=CPU)
    with pytest.raises(ZippyError):
        td.deflate_entries([b"x"], 1, block_size=100, device=CPU)
    assert td.deflate_entries([], 1, device=CPU) == []
    assert td.deflate_entries([b""], 6, device=CPU) == [b"\x03\x00"]


def test_crc32_many_equals_zlib():
    import zlib

    payloads = [b"", b"a", random_bytes(513, 3), b"", bytes(4096 * 3 + 7)]
    assert checksums.crc32_many(payloads, CPU) == [zlib.crc32(p)
                                                   for p in payloads]
    assert checksums.crc32_many([], CPU) == []


# ---------------------------------------------------------------------------
# Zip writer (current API)
# ---------------------------------------------------------------------------


def test_port_create_zip_archive_read_by_zipfile():
    entries = _entries()
    blob = zt.create_zip_archive(entries, device=CPU)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        assert set(zf.namelist()) == set(entries)
        for name, contents in entries.items():
            assert zf.read(name) == contents
        methods = {i.filename: i.compress_type for i in zf.infolist()}
    assert methods["empty.txt"] == zipfile.ZIP_STORED
    assert methods["readme.txt"] == zipfile.ZIP_DEFLATED


def test_port_create_zip_archive_roundtrip_own_reader(tmp_path):
    entries = {f"f{i}.bin": os.urandom(1000 + i) for i in range(20)}
    p = _zip_file(tmp_path, zt.create_zip_archive(entries, device=CPU))
    with ziparchives.open_zip_archive(p, device=CPU) as reader:
        assert sorted(reader.walk_files()) == sorted(entries)
        for name, contents in entries.items():
            assert reader.extract_file(name) == contents


def test_create_zip_archive_read_by_reference_readers(tmp_path):
    entries = _entries()
    p = _zip_file(tmp_path, zt.create_zip_archive(entries, device=CPU))
    with ref_ziparchives.open_zip_archive(p) as reader:
        for name, contents in entries.items():
            assert reader.extract_file(name) == contents
    dest = tmp_path / "ref_out"
    ref_ziparchives.extract_all(p, dest)
    assert _tree_files(dest) == {k: v for k, v in entries.items()}


def test_create_zip_archive_one_batched_encode(monkeypatch):
    """Every non-empty entry goes through one deflate_entries call at level
    1, every crc32 through one crc32_many call."""
    calls = []
    encode, crcs = td.deflate_entries, checksums.crc32_many
    monkeypatch.setattr(td, "deflate_entries", lambda p, level, **kw: (
        calls.append(("deflate", len(p), level)) or encode(p, level, **kw)))
    monkeypatch.setattr(checksums, "crc32_many", lambda p, dev: (
        calls.append(("crc", len(p))) or crcs(p, dev)))
    entries = _entries()
    zt.create_zip_archive(entries, device=CPU)
    assert calls == [("crc", len(entries)), ("deflate", len(entries) - 1, 1)]


def test_port_create_zip_archive_rejects_bad_names():
    with pytest.raises(ZippyError):
        zt.create_zip_archive({"": b"x"}, device=CPU)
    with pytest.raises(ZippyError):
        zt.create_zip_archive({"/abs/path": b"x"}, device=CPU)


# ---------------------------------------------------------------------------
# Zip reader (current API)
# ---------------------------------------------------------------------------


def _cpython_zip(entries: dict, methods=(zipfile.ZIP_DEFLATED,)) -> bytes:
    """A zip written by CPython's zipfile, with a directory record, the
    entries' methods cycling through `methods`, and a file mode."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr(zipfile.ZipInfo("dir/"), b"")
        for i, (name, data) in enumerate(entries.items()):
            info = zipfile.ZipInfo(name, (2020, 5, 17, 12, 30, 10))
            info.compress_type = methods[i % len(methods)]
            info.external_attr = 0o640 << 16
            zf.writestr(info, data)
    return buf.getvalue()


@pytest.mark.parametrize("maker", ["zipfile", "zippy_tpu"])
def test_extract_all_reads_other_writers(tmp_path, maker):
    """CPython's zip (deflated and stored entries, a directory record) and
    zippy_tpu's (its native codec) extract to the same tree."""
    entries = _entries()
    blob = (_cpython_zip(entries, (zipfile.ZIP_DEFLATED, zipfile.ZIP_STORED))
            if maker == "zipfile" else zippy_tpu.create_zip_archive(entries))
    p = _zip_file(tmp_path, blob)
    dest = tmp_path / "out"
    zt.extract_all_zip(p, dest, device=CPU)
    assert _tree_files(dest) == entries
    with zt.open_zip_archive(p, device=CPU) as reader:
        assert reader.extract_file("long.txt") == entries["long.txt"]
    if maker == "zipfile":
        assert (dest / "dir").is_dir()
        st = os.stat(dest / "readme.txt")
        assert st.st_mode & 0o777 == 0o640
        with zipfile.ZipFile(p) as zf:
            want = zf.getinfo("readme.txt").date_time
        from datetime import datetime
        assert datetime.fromtimestamp(st.st_mtime).timetuple()[:6] == want


def test_extract_all_in_several_passes(tmp_path, monkeypatch):
    """With passes of at most 5,000 decoded bytes the tree is the same."""
    monkeypatch.setattr(idev, "_PASS_BYTES", 5000)
    runs = []
    decode = ziparchives.decode_entries
    monkeypatch.setattr(ziparchives, "decode_entries", lambda e, d: (
        runs.append(len(e)) or decode(e, d)))
    entries = _entries()
    p = _zip_file(tmp_path, zt.create_zip_archive(entries, device=CPU))
    dest = tmp_path / "out"
    ziparchives.extract_all(p, dest, device=CPU)
    assert _tree_files(dest) == entries
    assert sum(runs) == len(entries) and len(runs) > 2


def test_concatenated_zip_walk(tmp_path):
    """A zip with bytes prepended (a jpg with a zip appended, reference
    test_ziparchives_read.nim:40-48) reads through the offset recovery: a
    zip without zip64 records (the zip64 locator's absolute offset is not
    recovered, by the reference's reader either), from CPython and from
    the port's v1 writer."""
    entries = _entries()
    v1 = zt.ZipArchive()
    for name, data in entries.items():
        v1.contents[name] = zt.ArchiveEntry(contents=data)
    v1.write_zip_archive(str(tmp_path / "v1.zip"), device=CPU)
    for blob in (_cpython_zip(entries), (tmp_path / "v1.zip").read_bytes()):
        p = _zip_file(tmp_path, random_bytes(777, 9) + blob, "cat.zip")
        with zt.open_zip_archive(p, device=CPU) as reader:
            files = list(reader.walk_files())
            assert set(files) == set(entries)
            for f in files:
                assert reader.extract_file(f) == entries[f]


def test_port_zip_missing_record_raises(tmp_path):
    p = _zip_file(tmp_path, zt.create_zip_archive(_entries(), device=CPU))
    with zt.open_zip_archive(p, device=CPU) as reader:
        with pytest.raises(ZippyError):
            reader.extract_file("no/such/file.txt")


def test_port_zip_extract_all_dest_exists(tmp_path):
    p = _zip_file(tmp_path, zt.create_zip_archive(_entries(), device=CPU))
    with pytest.raises(ZippyError):
        ziparchives.extract_all(p, tmp_path, device=CPU)
    with pytest.raises(ZippyError):
        ziparchives.extract_all(p, tmp_path / "no" / "such", device=CPU)


def test_port_zip_slip_defense(tmp_path):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("ok.txt", b"fine")
        zf.writestr("../evil.txt", b"pwned")
    p = _zip_file(tmp_path, buf.getvalue(), "evil.zip")
    dest = tmp_path / "out"
    with pytest.raises(ZippyError):
        ziparchives.extract_all(p, dest, device=CPU)
    assert not dest.exists()


def _corrupt(blob: bytes, where: str) -> bytes:
    """The port's zip with one byte flipped: the central-directory crc32 of
    long.txt, or a byte inside that entry's deflated body."""
    bad = bytearray(blob)
    name = b"long.txt"
    if where == "cd_crc32":
        cd = blob.index(name, blob.index(b"PK\x01\x02")) - 46
        bad[cd + 16] ^= 0x01
    else:
        local = blob.index(b"PK\x03\x04")
        while blob[local + 30:local + 30 + len(name)] != name:
            local = blob.index(b"PK\x03\x04", local + 4)
        body = local + 30 + len(name) + 20
        bad[body + 600] ^= 0x10
    return bytes(bad)


@pytest.mark.parametrize("where", ["cd_crc32", "body"])
def test_corrupt_entry_raises_and_removes_dest(tmp_path, where):
    blob = zt.create_zip_archive(_entries(), device=CPU)
    p = _zip_file(tmp_path, _corrupt(blob, where))
    dest = tmp_path / "out"
    with pytest.raises(ZippyError):
        ziparchives.extract_all(p, dest, device=CPU)
    assert not dest.exists()
    with zt.open_zip_archive(p, device=CPU) as reader:
        with pytest.raises(ZippyError):
            reader.extract_file("long.txt")
        assert reader.extract_file("readme.txt") == b"hello zip"


def test_entry_size_mismatch_raises():
    """A deflated entry whose scan disagrees with its record's size raises
    before its decode is dispatched; so does a stored one."""
    body = td.deflate(b"abc" * 100, 1, device=CPU)
    import zlib
    crc = zlib.crc32(b"abc" * 100)
    with pytest.raises(ZippyError):
        ziparchives.decode_entries(
            [ziparchives.Entry("x", body, 8, crc, 299)], torch.device(CPU))
    with pytest.raises(ZippyError):
        ziparchives.decode_entries(
            [ziparchives.Entry("y", b"abc", 0, zlib.crc32(b"abc"), 4)],
            torch.device(CPU))
    assert ziparchives.decode_entries(
        [ziparchives.Entry("x", body, 8, crc, 300),
         ziparchives.Entry("e", b"", 0, 0, 0)], torch.device(CPU)) == [
        b"abc" * 100, b""]


# ---------------------------------------------------------------------------
# Zip v1 (legacy in-memory API)
# ---------------------------------------------------------------------------


def test_port_zip_v1_open_zipfile_written(tmp_path):
    p = tmp_path / "t.zip"
    with zipfile.ZipFile(p, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("a.txt", b"alpha")
        zf.writestr("sub/b.txt", b"beta" * 1000)
    archive = zt.ZipArchive()
    archive.open(p, device=CPU)
    assert archive.contents["a.txt"].contents == b"alpha"
    assert archive.contents["sub/b.txt"].contents == b"beta" * 1000


def test_port_zip_v1_write_read_by_unzip(tmp_path):
    src = tmp_path / "src"
    (src / "nested").mkdir(parents=True)
    (src / "one.txt").write_bytes(b"one contents")
    (src / "nested" / "two.bin").write_bytes(os.urandom(5000))
    out = tmp_path / "out.zip"
    ziparchives_v1.create_zip_archive(str(src), str(out), device=CPU)
    dest = tmp_path / "unzipped"
    dest.mkdir()
    subprocess.run(["unzip", "-qq", str(out), "-d", str(dest)], check=True)
    assert (dest / "src" / "one.txt").read_bytes() == b"one contents"
    assert (dest / "src" / "nested" / "two.bin").read_bytes() == (
        (src / "nested" / "two.bin").read_bytes()
    )


def test_zip_v1_write_read_by_zipfile_reference_and_port(tmp_path):
    src = tmp_path / "proj"
    entries = _tree(src)
    out = tmp_path / "v1.zip"
    archive = zt.ZipArchive()
    archive.add_dir(str(src))
    archive.write_zip_archive(str(out), device=CPU)
    want = {f"proj/{k}": v for k, v in entries.items()}
    with zipfile.ZipFile(out) as zf:
        assert {n: zf.read(n) for n in zf.namelist()
                if not n.endswith("/")} == want
    for opener in (ref_ziparchives_v1.ZipArchive, zt.ZipArchive):
        back = opener()
        back.open(out, **({"device": CPU} if opener is zt.ZipArchive
                          else {}))
        assert {k: e.contents for k, e in back.contents.items()
                if e.kind == "file"} == want
        assert back.contents["proj/dir/"].kind == "directory"
    with ref_ziparchives.open_zip_archive(out) as reader:
        assert reader.extract_file("proj/long.txt") == entries["long.txt"]


def test_zip_v1_open_reference_written(tmp_path):
    out = tmp_path / "ref_v1.zip"
    src = tmp_path / "proj"
    entries = _tree(src)
    ref_ziparchives_v1.create_zip_archive(str(src), str(out))
    archive = zt.ZipArchive()
    archive.open(out.read_bytes(), device=CPU)
    assert {k: e.contents for k, e in archive.contents.items()
            if e.kind == "file"} == {f"proj/{k}": v
                                     for k, v in entries.items()}


def test_port_zip_v1_extract_all(tmp_path):
    archive = zt.ZipArchive()
    archive.contents["x/y.txt"] = zt.ArchiveEntry(
        kind="file", contents=b"zed", permissions=0o644
    )
    dest = tmp_path / "v1out"
    archive.extract_all(str(dest))
    assert (dest / "x" / "y.txt").read_bytes() == b"zed"


def test_port_zip_v1_rejects_data_descriptor():
    blob = bytearray()
    blob += struct.pack("<IHHHHHIIIHH", 0x04034B50, 20, 0b100, 0, 0, 0, 0, 0,
                        0, 1, 0)
    blob += b"a"
    archive = zt.ZipArchive()
    with pytest.raises(ZippyError):
        archive.open(bytes(blob), device=CPU)


def test_zip_v1_open_corrupt_and_empty_write(tmp_path):
    p = tmp_path / "t.zip"
    with zipfile.ZipFile(p, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("sub/b.txt", b"beta" * 1000)
    blob = bytearray(p.read_bytes())
    blob[blob.index(b"PK\x03\x04") + 14] ^= 0x01      # the local crc32
    with pytest.raises(ZippyError):
        zt.ZipArchive().open(bytes(blob), device=CPU)
    with pytest.raises(ZippyError):
        zt.ZipArchive().write_zip_archive(str(tmp_path / "e.zip"), device=CPU)


# ---------------------------------------------------------------------------
# Tarballs
# ---------------------------------------------------------------------------


def _cpython_tar(path: pathlib.Path, entries: dict, mode: str) -> None:
    """A tarball from CPython's tarfile, in GNU format: its UTF-8 names are
    in the header (pax format would put them in an extended header, which
    the readers skip, as zippy's do)."""
    with tarfile.open(path, mode, format=tarfile.GNU_FORMAT,
                      encoding="utf-8") as tf:
        info = tarfile.TarInfo("top/dir")
        info.type = tarfile.DIRTYPE
        info.mode = 0o755
        tf.addfile(info)
        for name, data in entries.items():
            info = tarfile.TarInfo("top/" + name)
            info.size = len(data)
            info.mode = 0o640
            info.mtime = 1600000000
            tf.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("mode", ["w", "w:gz"], ids=["tar", "tar.gz"])
def test_tar_extract_all_reads_tarfile_written(tmp_path, mode):
    entries = _entries()
    p = tmp_path / ("t.tar" if mode == "w" else "t.tar.gz")
    _cpython_tar(p, entries, mode)
    dest = tmp_path / "out"
    zt.extract_all_tarball(p, dest, device=CPU)
    assert _tree_files(dest / "top") == entries
    st = os.stat(dest / "top" / "readme.txt")
    assert st.st_mode & 0o777 == 0o640 and int(st.st_mtime) == 1600000000


def test_port_tar_extract_dest_exists(tmp_path):
    p = tmp_path / "t.tar"
    _cpython_tar(p, {"a": b"x"}, "w")
    with pytest.raises(ZippyError):
        tarballs.extract_all(p, tmp_path, device=CPU)


def test_port_tar_slip_defense(tmp_path):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        info = tarfile.TarInfo("../evil.txt")
        info.size = 5
        tf.addfile(info, io.BytesIO(b"pwned"))
    p = tmp_path / "evil.tar"
    p.write_bytes(buf.getvalue())
    dest = tmp_path / "tarout"
    with pytest.raises(ZippyError):
        tarballs.extract_all(p, dest, device=CPU)
    assert not dest.exists()


def test_port_tarball_v1_write_read_by_tarfile(tmp_path):
    src = tmp_path / "proj"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"file a")
    (src / "sub" / "b.txt").write_bytes(b"file b" * 500)
    for ext in (".tar", ".tar.gz", ".tgz"):
        out = tmp_path / f"out{ext}"
        zt.create_tarball(str(src), str(out), device=CPU)
        with tarfile.open(out) as tf:
            names = tf.getnames()
            assert any(n.endswith("a.txt") for n in names)
            member = [n for n in names if n.endswith("b.txt")][0]
            assert tf.extractfile(member).read() == b"file b" * 500


def test_port_tarball_v1_write_read_by_system_tar(tmp_path):
    src = tmp_path / "proj2"
    src.mkdir()
    (src / "hello.txt").write_bytes(b"hello tar")
    out = tmp_path / "t.tar.gz"
    tarballs_v1.create_tarball(str(src), str(out), device=CPU)
    dest = tmp_path / "x"
    dest.mkdir()
    subprocess.run(["tar", "-xf", str(out), "-C", str(dest)], check=True)
    assert (dest / "proj2" / "hello.txt").read_bytes() == b"hello tar"


def test_port_tarball_v1_open_roundtrip(tmp_path):
    t = zt.Tarball()
    t.contents["data.bin"] = zt.TarballEntry(
        kind="0", contents=os.urandom(2000), last_modified=1600000000.0
    )
    t.contents["d/"] = zt.TarballEntry(kind="5")
    out = tmp_path / "rt.tar"
    t.write_tarball(str(out), device=CPU)
    t2 = zt.Tarball()
    t2.open(out, device=CPU)
    assert t2.contents["data.bin"].contents == t.contents["data.bin"].contents

    # gzip detect path
    out_gz = tmp_path / "rt.tar.gz"
    t.write_tarball(str(out_gz), device=CPU)
    t3 = zt.Tarball()
    t3.open(out_gz, device=CPU)
    assert t3.contents["data.bin"].contents == t.contents["data.bin"].contents


@pytest.mark.parametrize("ext", [".tar", ".tgz"])
def test_tarball_interop_with_reference(tmp_path, ext):
    """The port's tarball read by zippy_tpu's readers, and zippy_tpu's
    tarball read by the port's, at the same tree."""
    src = tmp_path / "proj"
    entries = _tree(src)
    want = {f"proj/{k}": v for k, v in entries.items()}
    ours, theirs = tmp_path / f"ours{ext}", tmp_path / f"theirs{ext}"
    zt.create_tarball(str(src), str(ours), device=CPU)
    ref_tarballs_v1.create_tarball(str(src), str(theirs))
    for reader, kw, path in ((ref_tarballs_v1.Tarball, {}, ours),
                             (zt.Tarball, {"device": CPU}, theirs)):
        t = reader()
        t.open(path, **kw)
        assert {k: e.contents for k, e in t.contents.items()
                if e.kind == "0"} == want
    ref_tarballs.extract_all(ours, tmp_path / "ref_out")
    tarballs.extract_all(theirs, tmp_path / "port_out", device=CPU)
    for out in ("ref_out", "port_out"):
        assert _tree_files(tmp_path / out / "proj") == entries


def test_tgz_runs_level_6_matcher(tmp_path):
    """write_tarball's gzip body is the level-6 stream of the tar bytes
    (DefaultCompression on host bytes)."""
    t = zt.Tarball()
    t.contents["a.txt"] = zt.TarballEntry(kind="0",
                                          contents=mixed_payload(9000, 3))
    t.write_tarball(str(tmp_path / "a.tar"), device=CPU)
    t.write_tarball(str(tmp_path / "a.tgz"), device=CPU)
    tar = (tmp_path / "a.tar").read_bytes()
    blob = (tmp_path / "a.tgz").read_bytes()
    body = blob[zt.gzip_format.parse_header(blob)["data_offset"]:-8]
    assert body == td.deflate(tar, 6, device=CPU)


def test_port_tarball_v1_name_limits(tmp_path):
    t = zt.Tarball()
    t.contents["x" * 100] = zt.TarballEntry(kind="0", contents=b"a")
    with pytest.raises(ZippyError):
        t.write_tarball(str(tmp_path / "b.tar"), device=CPU)
    t = zt.Tarball()
    t.contents["d" * 155 + "/a"] = zt.TarballEntry(kind="0", contents=b"a")
    with pytest.raises(ZippyError):
        t.write_tarball(str(tmp_path / "c.tar"), device=CPU)


def test_port_tarball_v1_empty_write(tmp_path):
    t = zt.Tarball()
    with pytest.raises(ZippyError):
        t.write_tarball(str(tmp_path / "e.tar"), device=CPU)


# ---------------------------------------------------------------------------
# The device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    "create_zip_archive", "open_zip_archive", "extract_all_zip",
    "zip_v1_open", "zip_v1_write", "create_tarball", "extract_all_tarball",
    "tarball_v1_open"])
def test_archive_entry_points_default_to_cuda(tmp_path, call):
    """Without device= each entry point runs on the CUDA card: on a host
    with none it raises ZippyError (no silent CPU path)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    zpath = _zip_file(tmp_path, zt.create_zip_archive({"a": b"x"},
                                                      device=CPU))
    tpath = tmp_path / "t.tar"
    _cpython_tar(tpath, {"a": b"x"}, "w")
    src = tmp_path / "src"
    src.mkdir()
    (src / "a").write_bytes(b"x")
    full = zt.ZipArchive()
    full.contents["a"] = zt.ArchiveEntry(contents=b"x")
    calls = {
        "create_zip_archive": lambda: zt.create_zip_archive({"a": b"x"}),
        "open_zip_archive": lambda: zt.open_zip_archive(zpath),
        "extract_all_zip": lambda: zt.extract_all_zip(zpath, tmp_path / "o"),
        "zip_v1_open": lambda: zt.ZipArchive().open(zpath),
        "zip_v1_write": lambda: full.write_zip_archive(str(tmp_path / "w")),
        "create_tarball": lambda: zt.create_tarball(str(src),
                                                    str(tmp_path / "t.tgz")),
        "extract_all_tarball": lambda: zt.extract_all_tarball(
            tpath, tmp_path / "o"),
        "tarball_v1_open": lambda: zt.Tarball().open(tpath),
    }
    with pytest.raises(ZippyError, match="CUDA"):
        calls[call]()
