"""zippy_tpu_torch.parallel and the multi-device decode on lists of CPU
devices (the plain versions), against the port's single-device paths,
CPython's zlib and zippy_tpu.parallel on the 8 virtual devices of
tests/conftest.py.

Byte identity with zippy_tpu.parallel is a chain of three equalities: the
port's sharded stream equals its single-device `deflate` at every device
count (here); that equals zippy_tpu's `deflate` given the same ideal depths
(test_torch_streams.py); and zippy_tpu's sharded stream equals its
single-device one (test_device.py). The reference's sharded encoder cannot
run under the shared-depth fixture (its depth callback does not trace inside
shard_map), so here the two sharded streams are held to the North star's
encoder criterion: the port's decodes and is at most 1% longer.
"""

import functools
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import Mesh  # noqa: E402

from _torch_parity import mixed_payload, one_thread  # noqa: E402,F401
from zippy_tpu import parallel as jpar  # noqa: E402
from zippy_tpu.ops import inflate_device as jidev  # noqa: E402
from zippy_tpu_torch import parallel  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import deflate_device as td  # noqa: E402
from zippy_tpu_torch.ops import inflate_device as idev  # noqa: E402

BS = 2048
DATA = mixed_payload(20 * BS - 17, seed=5)   # 20 blocks: every device busy


def cpus(n: int) -> list:
    return ["cpu"] * n


@functools.cache
def _single(level: int) -> bytes:
    return td.deflate(DATA, level, BS, device="cpu")


# ---------------------------------------------------------------------------
# deflate_sharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndev", [1, 2, 3, 8])
@pytest.mark.parametrize("level", [1, 6, -1, -2])
def test_sharded_equals_single_device(one_thread, level, ndev):
    got = parallel.deflate_sharded(DATA, level, cpus(ndev), block_size=BS)
    assert got == _single(level)
    assert zlib.decompress(got, wbits=-15) == DATA


# 24 blocks of 1 KiB: random (stored) blocks at STORED, text elsewhere, its
# seeds chosen so that every run over 2, 3 or 8 devices but the first
# starts at an odd bit of the stream; a run holds a stored block first
# (blocks 3, 6, 9, 12, 16, 21) or after its first row (blocks 9, 16 and 19
# for the runs from 8, 15 and 18).
RUN_BS, STORED = 1024, (3, 6, 9, 12, 16, 19, 21)
TEXT_SEEDS = {2: 302, 7: 257, 14: 314, 20: 170}
RUNS = b"".join(
    np.random.default_rng(1000 + i).integers(0, 256, RUN_BS, dtype=np.uint8)
    .tobytes() if i in STORED
    else mixed_payload(RUN_BS, TEXT_SEEDS.get(i, 100 + i)) for i in range(24))


@functools.cache
def _single_runs() -> bytes:
    return td.deflate(RUNS, 6, RUN_BS, device="cpu")


@pytest.mark.parametrize("ndev", [2, 3, 8])
def test_runs_at_odd_phases_with_stored_blocks(one_thread, monkeypatch,
                                               ndev):
    """Each run is joined as if it started at bit 0 and appended by the host
    (deflate_device._append_run); each after the first lands at an odd
    bit and is realigned past its first stored block's 3 block bits: the
    one-device stream."""
    seen, append = [], td._append_run

    def append_run(out, data, bits, cut):
        seen.append((out.bitpos % 8, cut))
        return append(out, data, bits, cut)

    monkeypatch.setattr(td, "_append_run", append_run)
    got = parallel.deflate_sharded(RUNS, 6, cpus(ndev), block_size=RUN_BS)
    assert got == _single_runs()
    assert zlib.decompress(got, wbits=-15) == RUNS
    assert len(seen) == ndev and seen[0][0] == 0       # the first run
    later = seen[1:]
    assert all(phase % 2 and cut >= 3 for phase, cut in later), seen
    # A stored block first (its LEN just past the run's first 3 bits), or
    # after the first row.
    assert {cut == 3 for _, cut in later} == ({True} if ndev == 2
                                              else {True, False}), seen


def test_more_devices_than_blocks(one_thread):
    data = DATA[:3 * BS + 5]
    got = parallel.deflate_sharded(data, 1, cpus(7), block_size=BS)
    assert got == td.deflate(data, 1, BS, device="cpu")


@pytest.mark.parametrize("level", [1, 6])
def test_against_reference_sharded(one_thread, level):
    ref = jpar.deflate_sharded(DATA, level, jpar.default_mesh(),
                               block_size=BS)
    got = parallel.deflate_sharded(DATA, level, cpus(8), block_size=BS)
    assert zlib.decompress(got, wbits=-15) == DATA
    assert len(got) <= len(ref) * 1.01, (len(got), len(ref))


@pytest.mark.parametrize("level", [-2, -1, 0, 1, 6, 9])
def test_empty_input_equals_reference(level):
    assert parallel.deflate_sharded(b"", level, cpus(3)) == \
        jpar.deflate_sharded(b"", level, jpar.default_mesh())


def test_stored_level_equals_reference():
    data = mixed_payload(150_000, seed=13)
    assert parallel.deflate_sharded(data, 0, cpus(4)) == \
        jpar.deflate_sharded(data, 0, jpar.default_mesh())


@pytest.mark.parametrize("level", [10, -3])
def test_bad_level_raises(level):
    with pytest.raises(ZippyError):
        parallel.deflate_sharded(DATA, level, cpus(2))


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------


def test_gzip_sharded_decodes_and_has_the_reference_header(one_thread):
    import gzip

    blob = parallel.compress_gzip_sharded(DATA, 1, cpus(3))
    assert gzip.decompress(blob) == DATA
    ref = jpar.compress_gzip_sharded(DATA, 1, jpar.default_mesh())
    assert blob[:10] == ref[:10]
    assert blob[-8:] == ref[-8:]


def test_zlib_sharded_decodes_and_has_the_reference_header(one_thread):
    blob = parallel.compress_zlib_sharded(DATA, 9, cpus(3))
    assert zlib.decompress(blob) == DATA
    ref = jpar.compress_zlib_sharded(DATA, 9, jpar.default_mesh())
    assert blob[:2] == ref[:2]
    assert blob[-4:] == ref[-4:]


def test_stored_containers_equal_reference():
    """At level 0 the bodies are the same stored blocks, so the whole
    containers equal the reference's."""
    mesh = jpar.default_mesh()
    assert parallel.compress_gzip_sharded(DATA, 0, cpus(2)) == \
        jpar.compress_gzip_sharded(DATA, 0, mesh)
    assert parallel.compress_zlib_sharded(DATA, 0, cpus(2)) == \
        jpar.compress_zlib_sharded(DATA, 0, mesh)


# ---------------------------------------------------------------------------
# Checksums
# ---------------------------------------------------------------------------

CK_BLOCK = 4096


@pytest.mark.parametrize("ndev", [1, 3, 8])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 3 * 4096 + 5, 40_000])
def test_sharded_checksums(ndev, n):
    """Sizes below 8 rows leave devices empty; every value equals zlib's
    and zippy_tpu.parallel's (b"" gives 0 and 1)."""
    data = DATA[:n]
    crc = parallel.crc32_sharded(data, cpus(ndev), CK_BLOCK)
    adler = parallel.adler32_sharded(data, cpus(ndev), CK_BLOCK)
    assert crc == zlib.crc32(data)
    assert adler == zlib.adler32(data)
    if ndev == 8:
        mesh = jpar.default_mesh()
        assert crc == jpar.crc32_sharded(data, mesh, CK_BLOCK)
        assert adler == jpar.adler32_sharded(data, mesh, CK_BLOCK)


def test_checksum_shares_are_whole_rows():
    arr = np.frombuffer(DATA[:3 * CK_BLOCK + 5], np.uint8)
    shares = parallel.blocks._shares(arr, [torch.device("cpu")] * 8,
                                     CK_BLOCK)
    assert [n for n, _ in shares] == [CK_BLOCK] * 3 + [5]
    assert b"".join(x.numpy().tobytes() for _, x in shares) == arr.tobytes()


# ---------------------------------------------------------------------------
# The multi-device decode
# ---------------------------------------------------------------------------


@functools.cache
def _raw_stream():
    """A raw zlib stream of about 200 KB of output (two CFG_S tiles)."""
    raw = mixed_payload(200_000, seed=9)
    blob = zlib.compress(raw, 6)[2:-4]
    return raw, blob, idev.build_decode_index(blob)


def test_multi_device_decode_equals_one_device_and_reference(one_thread):
    raw, blob, index = _raw_stream()
    one = idev.inflate_device(blob, index, device="cpu")
    many = idev.inflate_device(blob, index, devices=cpus(4))
    assert many == one == raw
    mesh = Mesh(np.array(jax.devices()), ("seg",))
    assert many == jidev.inflate_device(blob, jidev.build_decode_index(blob),
                                        mesh=mesh)


@pytest.mark.parametrize("ndev", [2, 3, 7])
def test_multi_device_array_equals_one_device(one_thread, ndev):
    raw, blob, index = _raw_stream()
    buf, total = idev.inflate_device_array(blob, index, devices=cpus(ndev))
    assert total == len(raw) and buf.numpy().tobytes() == raw


@pytest.mark.parametrize("used", [[5, 0, 3], [1], [0, 7, 0, 9], [130, 2]])
@pytest.mark.parametrize("ndev", [1, 2, 3, 8])
def test_lane_shares_cover_the_batch_in_order(used, ndev):
    """Each share's lanes, read back through its shifted segment rows,
    are the batch's lanes in order, and the shares differ by at most one
    lane."""
    ntiles, nseg, nblk, nw = len(used), max(used) + 1, 2, 4
    seg = torch.arange(ntiles * 3 * nseg, dtype=torch.int32).view(
        ntiles, 3, nseg)
    words = torch.zeros(ntiles, nw, dtype=torch.int32)
    tables = torch.zeros(ntiles * nblk, 382, dtype=torch.int32)
    want = [seg[t, :, lane] for t, u in enumerate(used) for lane in range(u)]
    got, sizes = [], []
    for dev, w, s, u, tb in idev.lane_shares(words, seg, used, tables,
                                             cpus(ndev)):
        assert w.shape[0] == s.shape[0] == len(u) == tb.shape[0] // nblk
        got += [s[t, :, lane] for t, n in enumerate(u) for lane in range(n)]
        sizes.append(sum(u))
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert max(sizes) - min(sizes) <= 1 and len(sizes) == min(ndev,
                                                              sum(used))


def test_device_and_devices_must_agree():
    _, blob, index = _raw_stream()
    with pytest.raises(ZippyError):
        idev.inflate_device(blob, index, device="cuda", devices=cpus(2))
    with pytest.raises(ZippyError):
        idev.inflate_device(blob, index, devices=[])


def test_default_devices_need_cuda():
    """With no card, default_devices() and every sharded function given
    devices=None raise ZippyError; with one, they are the cards."""
    if torch.cuda.is_available():
        assert parallel.default_devices() == [
            torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return
    for fn in (parallel.default_devices,
               lambda: parallel.deflate_sharded(b"abc"),
               lambda: parallel.crc32_sharded(b"abc"),
               lambda: parallel.adler32_sharded(b"abc"),
               lambda: parallel.compress_gzip_sharded(b"abc"),
               lambda: parallel.compress_zlib_sharded(b"abc")):
        with pytest.raises(ZippyError):
            fn()
