"""The zip writer from card memory: create_zip_archive, deflate_entries and
crc32_many given 1-D uint8 tensors, against the same contents as host bytes,
CPython's zipfile and zlib, on the CPU in 4 KiB blocks and small groups; the
writer's call record, spans and counters; and, marked `card`, the tensor
path against the bytes path on the card (a 16 MB TPC-H table, stored rows,
an unaligned view, a host entry beside the tensors), run there with
    ZIPPY_TPU_TEST_REAL=1 python -m pytest tests/test_torch_zip_tensor.py
"""

import functools
import importlib.util
import io
import pathlib
import zipfile
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import zippy_tpu_torch as zt  # noqa: E402
from zippy_tpu_torch import profiling, ziparchives  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import checksums  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402

CPU = torch.device("cpu")
BS = 4096


def random_bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


def mixed_payload(n: int, seed: int) -> bytes:
    """Rows of text with runs and a few random bytes: every block mode."""
    rng = np.random.default_rng(seed)
    parts, size = [], 0
    while size < n:
        parts.append(b"%d|regular deposits haggle|%s|\n" % (
            rng.integers(0, 10**6), random_bytes(int(rng.integers(0, 6)),
                                                 int(rng.integers(1 << 30)))))
        size += len(parts[-1])
    return b"".join(parts)[:n]
# Payloads of each kind the issue of a group meets: empty, one block, many
# blocks over several groups, and random bytes that K5 stores.
PAYLOADS = {
    "empty": b"",
    "one_block": mixed_payload(3000, seed=21),
    "many_blocks": mixed_payload(9 * BS + 77, seed=22),
    "incompressible": random_bytes(2 * BS, 23),
}


@pytest.fixture
def one_thread():
    """Torch ops on one thread, as the suite's other CPU tests run them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch, one_thread):
    """Archive encodes in 4 KiB blocks, three rows a group."""
    monkeypatch.setattr(td, "deflate_entries", functools.partial(
        td.deflate_entries, block_size=BS))
    words = 2 * td.NWIN + 3 * td.NWIN + td.EXTW
    monkeypatch.setattr(td, "GROUP_BYTES", 3 * BS * words * 12)


@pytest.fixture(autouse=True)
def tracing_restored():
    was = profiling.enabled()
    yield
    (profiling.enable if was else profiling.disable)()


@pytest.fixture
def fixed_time(monkeypatch):
    """The writer's timestamp, fixed."""
    monkeypatch.setattr(ziparchives._time, "time", lambda: 1_600_000_000.0)


def tensor(data: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8) if data \
        else torch.empty(0, dtype=torch.uint8)


@pytest.mark.parametrize("level", [1, 6])
@pytest.mark.parametrize("case", list(PAYLOADS))
def test_deflate_entries_on_tensors_equals_on_bytes(case, level):
    data = PAYLOADS[case]
    payloads = [data, PAYLOADS["one_block"], data]
    want = td.deflate_entries(payloads, level, device=CPU)
    got = td.deflate_entries([tensor(p) for p in payloads], level,
                             device=CPU)
    assert got == want
    for stream, p in zip(got, payloads):
        assert zlib.decompress(stream, -15) == p


def test_a_stored_row_is_fetched_from_the_card_copy():
    """Random bytes are stored blocks, joined from the group's rows on the
    card (K10's plain version here) and fetched with the stream's other
    pieces: only the rows' lengths go up."""
    data = PAYLOADS["incompressible"]
    profiling.enable()
    with profiling.call("compress"):
        (stream,) = td.deflate_entries([tensor(data), tensor(data[1:])], 1,
                                       device=CPU)[:1]
    (rec,) = profiling.recent(1)
    assert zlib.decompress(stream, -15) == data
    # Every block stored: 5 bytes of framing a block (3 block bits, the pad
    # to a byte, LEN and NLEN) before its bytes.
    nblocks = -(-len(data) // BS)
    assert len(stream) == len(data) + 5 * nblocks
    assert rec.counters["join.rows"] == 2 * nblocks
    assert rec.counters["upload.bytes"] == 16 * 2 * nblocks
    assert rec.counters["fetch.bytes"] >= rec.counters["fetch.used_bytes"] \
        >= 2 * len(data)


def test_crc32_many_on_tensors_equals_zlib():
    base = tensor(random_bytes(5 * 512 + 37, 31))
    payloads = [base, base[1:], base[3:700], tensor(b""), b"bytes beside",
                "text", tensor(bytes(4096))]
    want = [zlib.crc32(bytes(p.numpy()) if isinstance(p, torch.Tensor)
                       else p.encode() if isinstance(p, str) else p)
            for p in payloads]
    assert base[1:].data_ptr() % 16      # a view K2 cannot read in place
    assert checksums.crc32_many(payloads, CPU) == want


def _archive(entries: dict) -> bytes:
    return zt.create_zip_archive(entries, device="cpu")


def test_create_zip_archive_from_tensors_bytes_and_a_mix(fixed_time):
    contents = {"a/text.tbl": PAYLOADS["many_blocks"],
                "b/one.tbl": PAYLOADS["one_block"],
                "c/empty.tbl": b"",
                "d/noise.bin": PAYLOADS["incompressible"]}
    from_bytes = _archive(contents)
    from_tensors = _archive({k: tensor(v) for k, v in contents.items()})
    mixed = _archive({k: tensor(v) if i % 2 else v
                      for i, (k, v) in enumerate(contents.items())})
    assert from_tensors == from_bytes
    assert mixed == from_bytes
    with zipfile.ZipFile(io.BytesIO(from_tensors)) as zf:
        assert zf.namelist() == list(contents)
        for info in zf.infolist():
            assert zf.read(info) == contents[info.filename]
            assert info.compress_type == (zipfile.ZIP_DEFLATED
                                          if contents[info.filename]
                                          else zipfile.ZIP_STORED)


@pytest.mark.parametrize("bad", ["int32", "two_dims", "scalar"])
def test_a_tensor_that_is_not_1d_uint8_raises(bad):
    t = {"int32": torch.zeros(8, dtype=torch.int32),
         "two_dims": torch.zeros(2, 8, dtype=torch.uint8),
         "scalar": torch.tensor(7, dtype=torch.uint8)}[bad]
    with pytest.raises(ZippyError):
        _archive({"ok.txt": b"fine", "bad.bin": t})
    with pytest.raises(ZippyError):
        td.deflate_entries([t], 1, device=CPU)
    with pytest.raises(ZippyError):
        checksums.crc32_many([t], CPU)


@pytest.mark.parametrize("form", ["tensors", "bytes"])
def test_the_writer_keeps_one_record_with_its_spans_and_counters(form):
    contents = {"t.tbl": PAYLOADS["many_blocks"],
                "r.bin": PAYLOADS["incompressible"], "e": b""}
    entries = {k: tensor(v) if form == "tensors" else v
               for k, v in contents.items()}
    profiling.enable()
    _archive(entries)
    (rec,) = profiling.recent(1)
    assert rec.name == "compress" and not rec.failed
    for name in ("framing", "checksums", "checksum.wait", "encode.issue",
                 "join", "fetch"):
        assert rec.spans[name][0] >= 1, name
    assert "splice" not in rec.spans
    total = sum(map(len, contents.values()))
    assert rec.counters["zip.entries"] == 3
    assert rec.counters["zip.bytes"] == total
    # On the tensor path only the rows' lengths are uploaded, 16 bytes a
    # row; host bytes go up once, each payload at a 16-byte offset.
    rows = sum(-(-len(v) // BS) for v in contents.values())
    assert rec.counters["join.rows"] == rows
    lengths = 16 * rows
    padded = sum(-(-len(v) // 16) * 16 for v in contents.values())
    assert rec.counters["upload.bytes"] == (
        lengths if form == "tensors" else lengths + padded)


def _lineitem(target: int) -> bytes:
    """About `target` bytes of TPC-H lineitem rows, from the benchmark's
    generator."""
    path = (pathlib.Path(__file__).resolve().parents[1] / "benchmark"
            / "data" / "tpch_lineitem.py")
    spec = importlib.util.spec_from_file_location("_tpch_lineitem", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    cfg = {"scale_factor": target / 75.5e6, "chunks": 10, "chunk": 1,
           "comment_chars": [10, 43], "text_pool_bytes": 1 << 23}
    return module.make(cfg, 2**31 + 27)


@pytest.mark.card
def test_the_tensor_path_equals_the_bytes_path_on_the_card(monkeypatch):
    """On the card: a 16 MB table, a short one, an empty one, random bytes
    (every block stored, joined by K10 from the group's rows), an
    unaligned view of the table's tensor (K2 reads a copy made on the
    card) and one entry as host bytes beside the tensors. The archive is
    the one the same contents give as host bytes, and only the rows'
    lengths and the host entry go up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.undo()              # the card's own block and group sizes
    monkeypatch.setattr(ziparchives._time, "time", lambda: 1_600_000_000.0)
    data = _lineitem(16_000_000)
    noise = random_bytes(4 * td.BLOCK + 999, 41)
    contents = {"lineitem.tbl": data, "head.tbl": data[:5000], "none": b"",
                "noise.bin": noise, "view.tbl": data[1:1_000_001],
                "host.tbl": data[7:300_007]}
    table = torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda()
    on_card = {"lineitem.tbl": table, "head.tbl": table[:5000].clone(),
               "none": torch.empty(0, dtype=torch.uint8, device="cuda"),
               "noise.bin": torch.frombuffer(bytearray(noise),
                                             dtype=torch.uint8).cuda(),
               "view.tbl": table[1:1_000_001],
               "host.tbl": contents["host.tbl"]}
    assert on_card["view.tbl"].data_ptr() % 16
    profiling.enable()
    from_tensors = zt.create_zip_archive(on_card)
    (rec,) = profiling.recent(1)
    assert zt.create_zip_archive(contents) == from_tensors
    rows = sum(-(-len(v) // td.BLOCK) for v in contents.values())
    assert rec.counters["join.rows"] == rows
    assert rec.counters["upload.bytes"] == 16 * rows + 300_000
    assert "splice" not in rec.spans
    with zipfile.ZipFile(io.BytesIO(from_tensors)) as zf:
        assert [zf.read(n) for n in contents] == list(contents.values())
        # Random bytes: every block stored, 5 bytes of framing a chunk of
        # at most 65,535 bytes (two a 64 KiB block).
        chunks = sum(-(-min(td.BLOCK, len(noise) - at) // 0xFFFF)
                     for at in range(0, len(noise), td.BLOCK))
        assert zf.getinfo("noise.bin").compress_size == len(noise) \
            + 5 * chunks
