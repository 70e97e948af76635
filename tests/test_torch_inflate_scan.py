"""The port's decode index (its host scan, in csrc/zippy_native.cpp) and
tile planner held against zippy_tpu's, field for field, on the CPU."""

import gzip
import os
import pathlib
import random
import subprocess
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from zippy_tpu import native  # noqa: E402
from zippy_tpu.ops import inflate_device as ref  # noqa: E402
import zippy_tpu_torch as zt  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import inflate_device as port  # noqa: E402
from zippy_tpu_torch.ops import inflate_scan  # noqa: E402
from _torch_parity import (  # noqa: E402,F401
    DEEP_CHAINS, mixed_payload, one_thread, random_bytes, raw_deflate)

pytestmark = pytest.mark.usefixtures("one_thread")

REPO = pathlib.Path(__file__).resolve().parent.parent

STREAMS = {
    "zlib0": lambda: raw_deflate(mixed_payload(150_000, 11), 0),
    "zlib1": lambda: raw_deflate(mixed_payload(150_000, 11), 1),
    "zlib6": lambda: raw_deflate(mixed_payload(150_000, 11), 6),
    "zlib9": lambda: raw_deflate(mixed_payload(150_000, 11), 9),
    "fixed": lambda: raw_deflate(mixed_payload(40_000, 12), 6,
                                 strategy=zlib.Z_FIXED),
    "port1": lambda: zt.compress(mixed_payload(20_000, 13), 1, zt.dfDeflate,
                                 device="cpu"),
    "port6": lambda: zt.compress(mixed_payload(20_000, 13), 6, zt.dfDeflate,
                                 device="cpu"),
    "empty": lambda: raw_deflate(b"", 6),
    "multiblock": lambda: raw_deflate(mixed_payload(60_000, 14), 6,
                                      mem_level=1),
    "deep_chains": lambda: raw_deflate(DEEP_CHAINS, 6),
}


def assert_same_index(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype, key
            assert np.array_equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_scan_equals_reference(name):
    blob = STREAMS[name]()
    got = port.build_decode_index(blob)
    assert_same_index(got, ref.build_decode_index(blob))
    if name == "multiblock":
        assert got["block_lens"].shape[0] >= 8
    if name == "zlib0":
        assert got["stored"].shape[0] >= 2


def test_scan_at_a_bit_offset():
    """A gzip member scanned in place from its deflate stream's bit offset:
    the offsets are absolute in the buffer, as the reference's."""
    data = mixed_payload(30_000, 15)
    blob = gzip.compress(data) * 2
    start = 10 * 8
    got = port.build_decode_index(blob, start)
    assert_same_index(got, ref.build_decode_index(blob, start))
    assert got["segments"][0, 0] > start    # past the block header
    # The second member, in the same buffer.
    second = (got["end_bit"] + 7) // 8 + 8
    assert_same_index(port.build_decode_index(blob, (second + 10) * 8),
                      ref.build_decode_index(blob, (second + 10) * 8))


def test_scan_retries_when_its_capacities_are_short():
    """One-bit codes in 128-symbol blocks: more segments and blocks than the
    first try's capacities hold."""
    data = bytes(np.random.default_rng(16).choice([97, 98], 50_000)
                 .astype(np.uint8))
    blob = raw_deflate(data, 6, mem_level=1, strategy=zlib.Z_HUFFMAN_ONLY)
    got = inflate_scan.inflate_scan(blob, 0, 32)
    assert got["segments"].shape[0] > max(1024, 2 * len(blob) // 32)
    assert got["block_lens"].shape[0] > 256
    assert_same_index(got, native.inflate_scan(blob, 0, 32))


def test_scan_rejects_what_the_reference_rejects():
    for bad in (b"", b"\xff" * 64, raw_deflate(b"abc" * 100, 6)[:5]):
        with pytest.raises(ZippyError):
            port.build_decode_index(bad)
        with pytest.raises(Exception):
            ref.build_decode_index(bad)
    with pytest.raises(ZippyError):
        inflate_scan.inflate_scan(raw_deflate(b"abc"), 0, every=0)


def test_scan_fuzz_agrees_with_reference():
    """Bit flips and truncations: the port's scan raises ZippyError exactly
    where the reference's does, and otherwise gives the same index."""
    rng = random.Random(11)
    blob = bytearray(raw_deflate(mixed_payload(20_000, 17), 6))
    for i in range(300):
        b = bytearray(blob)
        if i % 2 == 0:
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        else:
            b = b[:rng.randrange(len(b))]
        b = bytes(b)
        try:
            want = native.inflate_scan(b, 0, 32)
        except Exception:
            want = None
        if want is None:
            with pytest.raises(ZippyError):
                inflate_scan.inflate_scan(b, 0, 32)
        else:
            assert_same_index(inflate_scan.inflate_scan(b, 0, 32), want)


PLANS = {
    "three_tiles": lambda: raw_deflate(
        mixed_payload(3 * port.CFG_S.tile_out + 12345, 21), 6),
    "stored": lambda: raw_deflate(random_bytes(300_000, 22), 0),
    "literals": lambda: raw_deflate(random_bytes(1 << 20, 23), 6,
                                    strategy=zlib.Z_HUFFMAN_ONLY),
    "deep_chains": lambda: raw_deflate(DEEP_CHAINS * 3, 9),
    "cfg_l": lambda: raw_deflate(
        mixed_payload(8 * port.CFG_S.tile_out + 4321, 24), 6),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_and_pack_equal_reference(name):
    blob = PLANS[name]()
    index = port.build_decode_index(blob)
    cfg = port._pick_cfg(index["total_out"])
    assert cfg == ref._pick_cfg(index["total_out"])
    tiles = port._plan_tiles(index, cfg)
    assert tiles == ref._plan_tiles(index, cfg)
    if name in ("three_tiles", "literals"):
        assert len(tiles) >= 3
    if name == "cfg_l":
        assert cfg == port.CFG_L
    assert port._buf_size(cfg) == ref._buf_size(cfg)
    for tile in tiles:
        nrounds = port._nrounds_for_depth(tile.depth, cfg)
        assert nrounds == ref._nrounds_for_depth(tile.depth, cfg)
        assert np.array_equal(port._tile_pack(blob, index, tile, cfg, nrounds),
                              ref._tile_pack(blob, index, tile, cfg, nrounds))


def test_import_with_scan_pulls_in_neither_jax_nor_reference():
    """In a fresh interpreter, importing the port and running its host scan
    leaves jax and zippy_tpu out of sys.modules."""
    code = (
        "import sys, zlib\n"
        "import zippy_tpu_torch\n"
        "from zippy_tpu_torch.ops import inflate_device, inflate_kernels\n"
        "c = zlib.compressobj(6, zlib.DEFLATED, -15)\n"
        "blob = c.compress(b'abc' * 1000) + c.flush()\n"
        "assert inflate_device.build_decode_index(blob)['total_out'] == 3000\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'zippy_tpu' or m.startswith('zippy_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_member_indexes_of_64_members_equal_each_member_alone():
    """Each member of a 64-member stream is scanned in place with buffers
    sized from the bytes after its start, not from the whole stream; its
    index equals that of the member scanned alone, shifted to its offset.
    The last member (9 MiB of zeros, over a thousand segments in 9 KB)
    outgrows its first buffers and takes the retry with exact sizes."""
    from zippy_tpu_torch import gzip_format

    members = [gzip.compress(mixed_payload(3000 + 97 * i, i), 6)
               for i in range(63)] + [gzip.compress(bytes(9 << 20), 9)]
    got = gzip_format.member_indexes(b"".join(members))
    assert [p for p, _ in got] == list(np.cumsum([0] + [len(m) for m in
                                                        members])[:-1])
    assert got[-1][1]["segments"].shape[0] > 1024
    for (pos, index), member in zip(got, members):
        alone = port.build_decode_index(
            member, gzip_format.parse_header(member)["data_offset"] * 8)
        alone["segments"][:, 0] += pos * 8
        alone["stored"][:, 0] += pos
        alone["end_bit"] += pos * 8
        assert index.keys() == alone.keys()
        for key, value in alone.items():
            assert np.array_equal(index[key], value), (pos, key)
