"""zippy_tpu_torch's checksums against zlib, zippy_tpu.ops.checksums and the
Pallas kernels (interpreter mode), on the CPU.

On a CPU tensor the kernel wrappers run their plain PyTorch versions; the
CUDA kernels themselves are held against those plain versions on the card
by chip_smoke.py.
"""

import pathlib
import re
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax.experimental.pallas")
import jax.numpy as jnp  # noqa: E402

from zippy_tpu.ops import checksums as jc  # noqa: E402
from zippy_tpu.ops import pallas_checksums as pc  # noqa: E402
from zippy_tpu_torch.common import ZippyError  # noqa: E402
from zippy_tpu_torch.ops import checksum_kernels as ck  # noqa: E402
from zippy_tpu_torch.ops import checksums as tc  # noqa: E402

SIZES = [0, 1, 100, 511, 512, 513, 4096, 32769, 100000, 1 << 20]


def _data(n: int) -> bytes:
    return np.random.default_rng(n).integers(0, 256, n).astype(np.uint8).tobytes()


@pytest.mark.parametrize("n", SIZES)
def test_checksums_match_zlib_and_reference(n):
    data = _data(n)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    adler = tc.adler32_device(data, device="cpu")
    crc = tc.crc32_device(data, device="cpu")
    assert adler == zlib.adler32(data) == jc.adler32_device(data)
    assert crc == zlib.crc32(data) == jc.crc32_device(data)
    assert tc.adler32_device(x) == adler
    assert tc.crc32_device(x) == crc


@pytest.mark.parametrize("nchunks", [128, 1024])
def test_adler_chunks_match_pallas_kernel(nchunks):
    chunks = np.frombuffer(_data(nchunks * ck.CHUNK), np.uint8).reshape(
        nchunks, ck.CHUNK)
    s_ref, w_ref = pc._adler_chunks_pallas(jnp.asarray(chunks))
    s, w = ck.adler_chunks(torch.from_numpy(chunks.copy()))
    assert np.array_equal(np.asarray(s_ref).astype(np.int64), s.numpy())
    assert np.array_equal(np.asarray(w_ref).astype(np.int64), w.numpy())
    assert s.dtype == w.dtype == torch.int32

    n, total = nchunks * ck.CHUNK - 77, nchunks * ck.CHUNK
    ref = pc._combine_chunks(s_ref, w_ref, jnp.uint32(n), jnp.uint32(total))
    got = ck.combine_chunks(s, w, n, total)
    assert got.shape == (1,) and got.dtype == torch.int64
    assert int(got) == int(ref)


@pytest.mark.parametrize("nrows", [128, 2048])
def test_crc_rows_match_pallas_kernel(nrows):
    rows = np.frombuffer(_data(nrows * ck.CRC_ROW_BYTES), np.uint8).reshape(
        nrows, ck.CRC_ROW_BYTES)
    words = rows.view("<u4").astype(np.int64).astype(np.int32)
    ref = pc._crc_rows_pallas(jnp.asarray(words))
    got = ck.crc_rows(torch.from_numpy(rows.copy()))
    assert got.dtype == torch.int32
    assert np.array_equal(np.asarray(ref).astype(np.uint32),
                          got.numpy().view(np.uint32))

    init = jc.crc_shift_register(0xFFFFFFFF, rows.size)
    crc = int(ck.crc_combine(got)) & 0xFFFFFFFF ^ init ^ 0xFFFFFFFF
    assert crc == int(pc._crc_combine_rows(ref, jnp.uint32(init)))
    assert crc == zlib.crc32(rows.tobytes())


@pytest.mark.parametrize("tail", [1, 17, 511])
def test_crc_rows_tail_is_a_front_padded_row(tail):
    """K2's tail value is the Pallas kernel's raw CRC of the tail padded
    with zeros in front to a full row."""
    data = np.frombuffer(_data(127 * ck.CRC_ROW_BYTES + tail), np.uint8)
    padded = np.concatenate([np.zeros(ck.CRC_ROW_BYTES - tail, np.uint8),
                             data[127 * ck.CRC_ROW_BYTES:]])
    rows = np.concatenate([data[:127 * ck.CRC_ROW_BYTES], padded])
    ref = pc._crc_rows_pallas(jnp.asarray(
        rows.view("<u4").astype(np.int64).astype(np.int32).reshape(128, -1)))
    x = torch.from_numpy(data.copy())
    got = ck.crc_rows(x[:127 * ck.CRC_ROW_BYTES].view(127, -1),
                      x[127 * ck.CRC_ROW_BYTES:])
    assert np.array_equal(np.asarray(ref).astype(np.uint32),
                          got.numpy().view(np.uint32))


@pytest.mark.parametrize("nrows", [1, 2, 128, 2048, 1 << 18])
def test_crc_combine_plain_matches_reference(nrows):
    """K3's plain version against zippy_tpu's log tree (which needs a power
    of two), on random raw row CRCs: 2^18 rows give each of K3's 2^15
    lanes 8 rows."""
    c = np.random.default_rng(nrows).integers(0, 1 << 32, nrows,
                                              dtype=np.uint64)
    init = jc.crc_shift_register(0xFFFFFFFF, nrows * ck.CRC_ROW_BYTES)
    ref = int(pc._crc_combine_rows(jnp.asarray(c.astype(np.uint32)),
                                   jnp.uint32(init)))
    got = ck.crc_combine_plain(torch.from_numpy(c.astype(np.int64)).to(
        torch.int32))
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got) & 0xFFFFFFFF ^ init ^ 0xFFFFFFFF == ref


@pytest.mark.parametrize("nrows", [1, 3, 5, 129])
def test_crc_combine_rows_any_row_count(nrows):
    """The port folds any row count, with a last row of any length; the
    reference needs a power of two."""
    data = _data(nrows * ck.CRC_ROW_BYTES - 3)
    assert tc.crc32_device(data, device="cpu") == zlib.crc32(data)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    full = (nrows - 1) * ck.CRC_ROW_BYTES
    rows = ck.crc_rows(x[:full].view(nrows - 1, ck.CRC_ROW_BYTES), x[full:])
    init = jc.crc_shift_register(0xFFFFFFFF, len(data))
    raw = int(ck.crc_combine_plain(rows, ck.CRC_ROW_BYTES - 3))
    assert raw & 0xFFFFFFFF ^ init ^ 0xFFFFFFFF == zlib.crc32(data)


# K3's edges (full rows, + 1 for the last row): one row; one block's 64
# lanes +- 1; one block's 4 rows a lane +- 1 (2 blocks from 258 rows on);
# one group of 32 blocks at 4 rows a lane +- 1 (two meetings from 8194
# rows on); the largest grid's lattice stride of 32768 lanes +- 1; the
# 64 MiB trailer's 131072 rows +- 1 (the largest grid at 4 rows a lane).
# Each with a full last row, and the shorter last rows at a few of them.
_ROW_EDGES = [1, 64, 65, 66, 256, 257, 258, 8192, 8193, 8194, 32768, 32769,
              32770, 131071, 131072, 131073]
_COMBINE_EDGES = ([(n, 512) for n in _ROW_EDGES]
                  + [(n, last) for n in (1, 65, 258, 8194, 32769, 131073)
                     for last in (1, 3, 511)])


@pytest.mark.parametrize("nrows,last_bytes", _COMBINE_EDGES)
def test_crc_combine_plain_at_kernel_edges(nrows, last_bytes):
    """K3's plain version at the edges of its lattice, blocks and meetings:
    against zippy_tpu's log tree on random row CRCs where the row count is
    a power of two and the last row full, else against zlib.crc32 of random
    data whose row CRCs come from zlib too."""
    if nrows & (nrows - 1) == 0 and last_bytes == ck.CRC_ROW_BYTES:
        c = np.random.default_rng(nrows).integers(0, 1 << 32, nrows,
                                                  dtype=np.uint64)
        init = jc.crc_shift_register(0xFFFFFFFF, nrows * ck.CRC_ROW_BYTES)
        want = int(pc._crc_combine_rows(jnp.asarray(c.astype(np.uint32)),
                                        jnp.uint32(init)))
    else:
        nbytes = (nrows - 1) * ck.CRC_ROW_BYTES + last_bytes
        data = np.random.default_rng(nrows + last_bytes).integers(
            0, 256, nbytes, dtype=np.uint8).tobytes()
        view = memoryview(data)
        # raw CRC = zlib's ^ the init register shifted over the bytes ^ ~0
        row_raw = jc.crc_shift_register(0xFFFFFFFF, ck.CRC_ROW_BYTES) ^ 0xFFFFFFFF
        c = np.array([zlib.crc32(view[i:i + ck.CRC_ROW_BYTES]) ^ row_raw
                      for i in range(0, nbytes - last_bytes,
                                     ck.CRC_ROW_BYTES)]
                     + [zlib.crc32(view[nbytes - last_bytes:])
                        ^ jc.crc_shift_register(0xFFFFFFFF, last_bytes)
                        ^ 0xFFFFFFFF], dtype=np.uint64)
        init = jc.crc_shift_register(0xFFFFFFFF, nbytes)
        want = zlib.crc32(data)
    rows = torch.from_numpy(c.astype(np.int64)).to(torch.int32)
    got = ck.crc_combine_plain(rows, last_bytes)
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got) & 0xFFFFFFFF ^ init ^ 0xFFFFFFFF == want
    assert torch.equal(ck.crc_combine(rows, last_bytes), got)


def _cuda_constants() -> dict:
    """The `constexpr int` constants of csrc/checksums.cu, evaluated."""
    src = (pathlib.Path(ck.__file__).resolve().parent.parent / "csrc"
           / "checksums.cu").read_text()
    names: dict = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        names[name] = eval(expr.replace("/", "//"), {}, dict(names))
    return names


def test_table_constants_match_cuda_source():
    """The table buffer's layout and K3's shape are the same numbers in
    checksum_kernels.py and csrc/checksums.cu."""
    cu = _cuda_constants()
    assert cu["kSliceWords"] == ck.SLICE_WORDS
    assert cu["kLaneWords"] == ck.LANE_WORDS
    assert cu["kShiftOffset"] == ck.SHIFT_OFFSET
    assert cu["kMap"] == ck.MAP_WORDS
    assert cu["kShiftLevels"] == ck.SHIFT_LEVELS
    assert cu["kDistanceMaps"] == ck.DISTANCE_MAPS
    assert cu["kRowBytes"] == ck.CRC_ROW_BYTES
    assert cu["kChunk"] == ck.CHUNK
    assert cu["kCombineThreads"] == ck.COMBINE_THREADS
    assert cu["kCombineMaxLg"] == ck.COMBINE_MAX_LG
    assert cu["kGroupLg"] == ck.GROUP_LG
    assert cu["kCombineSlots"] == ck.COMBINE_SLOTS
    assert cu["kRowLevel"] == ck.ROW_LEVEL
    assert cu["kTreeLevels"] == ck.TREE_LEVELS
    assert cu["kBlockLevel"] == ck.BLOCK_LEVEL
    # A block's tree has one level per halving of its lanes.
    assert 1 << ck.TREE_LEVELS == ck.COMBINE_THREADS
    assert ck.BLOCK_LEVEL == ck.ROW_LEVEL + ck.TREE_LEVELS
    # The largest grid's Horner level is the last level; one distance map
    # per block of the largest grid.
    assert ck.SHIFT_LEVELS == ck.BLOCK_LEVEL + ck.COMBINE_MAX_LG + 1
    assert ck.DISTANCE_MAPS == 1 << ck.COMBINE_MAX_LG
    assert ck.DISTANCE_OFFSET == ck.SHIFT_OFFSET + ck.SHIFT_LEVELS * ck.MAP_WORDS
    assert ck._crc_tables().size == (ck.DISTANCE_OFFSET
                                     + ck.DISTANCE_MAPS * ck.MAP_WORDS)
    # The edges above are the grid's.
    lanes, steps = ck.COMBINE_THREADS, ck.COMBINE_MIN_STEPS
    assert _ROW_EDGES[2] == lanes + 1
    assert _ROW_EDGES[5] == lanes * steps + 1
    assert _ROW_EDGES[8] == (lanes << ck.GROUP_LG) * steps + 1
    assert _ROW_EDGES[11] == (lanes << ck.COMBINE_MAX_LG) + 1
    assert _ROW_EDGES[14] == (lanes << ck.COMBINE_MAX_LG) * steps
    assert [ck._combine_lg(n - 1) for n in _ROW_EDGES[4:10]] == [0, 0, 1, 5, 5, 6]


def test_nibble_tables_apply_like_the_maps():
    """K3's nibble tables in the buffer: shift level b gives the shift over
    2^b bytes and distance map d the shift over d blocks, as zippy_tpu's
    register shift gives them."""
    _, _, levels, dist = ck._tables_i64(torch.device("cpu"))
    v = np.random.default_rng(7).integers(0, 1 << 32, 16, dtype=np.uint64)
    vt = torch.from_numpy(v.astype(np.int64))
    block = ck.CRC_ROW_BYTES * ck.COMBINE_THREADS
    for tabs, nbytes in ((levels[0], 1), (levels[9], 512),
                         (levels[-1], 1 << (ck.SHIFT_LEVELS - 1)),
                         (dist[0], 0), (dist[5], 5 * block),
                         (dist[-1], (ck.DISTANCE_MAPS - 1) * block)):
        got = ck._apply_nibbles(tabs, vt).numpy()
        assert [int(g) for g in got] == [jc.crc_shift_register(int(x), nbytes)
                                         for x in v]
    per_word = dist[torch.arange(16) * 31]
    assert torch.equal(ck._apply_nibbles(per_word, vt), torch.stack(
        [ck._apply_nibbles(dist[31 * i], vt[i:i + 1])[0] for i in range(16)]))


def test_stream_slots_differ_by_stream():
    """K3's meeting words: one set per (device, stream), sets taken in
    turn, so two streams never share one until COMBINE_SLOTS have come."""
    a, b = ck._stream_slot(0, 0x1111), ck._stream_slot(0, 0x2222)
    assert a != b and ck._stream_slot(0, 0x1111) == a
    assert ck._stream_slot(1, 0x1111) not in (a, b)
    assert 0 <= min(a, b) and max(a, b) < ck.COMBINE_SLOTS


def test_stream_slots_run_out_rather_than_wrap(monkeypatch):
    """With every slot taken, a new stream raises ZippyError; it never
    takes a slot another stream holds (which mixed two streams' sums)."""
    monkeypatch.setattr(ck, "_stream_slots", {})
    slots = [ck._stream_slot(0, 0x10000 + s) for s in range(ck.COMBINE_SLOTS)]
    assert sorted(slots) == list(range(ck.COMBINE_SLOTS))
    with pytest.raises(ZippyError, match="slots"):
        ck._stream_slot(0, 0x10000 + ck.COMBINE_SLOTS)
    assert ck._stream_slot(0, 0x10000) == slots[0]  # known streams keep theirs


@pytest.mark.parametrize("n", [0, 1, 513, 100000])
def test_checksum_tensors_stay_on_the_device(n):
    """adler32_tensor and crc32_tensor: (1,) int64 on the payload's device,
    equal to zlib; crc32_raw_tensor: the raw CRC that crc32_finish turns
    into the crc32."""
    data = _data(n)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    a, c = tc.adler32_tensor(x), tc.crc32_tensor(x)
    for t in (a, c):
        assert t.shape == (1,) and t.dtype == torch.int64
        assert t.device == x.device
    assert (int(a), int(c)) == (zlib.adler32(data), zlib.crc32(data))
    assert int(tc.crc32_tensor(data, device="cpu")) == zlib.crc32(data)
    # The raw CRC is K3's int32 bit pattern, finished on the host.
    raw = tc.crc32_raw_tensor(x)
    assert raw.shape == (1,) and raw.dtype == torch.int32
    assert tc.crc32_finish(int(raw), n) == zlib.crc32(data)


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 4096 + 7, (1 << 20) + 3])
def test_crc32_device_in_place_and_unaligned(n):
    """An aligned payload is read in place (full rows and a tail row); the
    unaligned view x[1:] is read from an aligned copy."""
    data = _data(n + 1)
    buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    assert buf.data_ptr() % 16 == 0
    assert n == 0 or buf[1:].data_ptr() % 16 != 0
    assert tc.crc32_device(buf[:n]) == zlib.crc32(data[:n])
    assert tc.crc32_device(buf[1:]) == zlib.crc32(data[1:])
    assert tc.crc32_device(data[:n], device="cpu") == zlib.crc32(data[:n])


def test_plain_matrices_equal_reference():
    """The crc kernels' host tables against zippy_tpu's GF(2) matrices."""
    def tables(cols):
        return np.array([[jc.gf2_matvec(cols, b << (8 * j))
                          for b in range(256)] for j in range(4)],
                        dtype=np.uint32)

    slices = tc.crc_slice_tables()
    assert np.array_equal(slices[:4], jc._crc_word_tables())
    word_cols = pc._crc_matrices()[0].astype(np.uint32)
    for bit in range(32):  # the Pallas kernel's word columns
        assert word_cols[bit] == slices[3 - bit // 8][1 << (bit % 8)]
    tree = jc._tree_matrices()            # shift over 4 * 2^k bytes
    shifts = tc.crc_shift_tables(ck.SHIFT_LEVELS)  # shift over 2^b bytes
    for b in range(2, shifts.shape[0]):
        assert np.array_equal(shifts[b], tables(tree[b - 2]))
    lanes = tc.crc_lane_tables()          # shift over 16 (31 - lane) bytes
    for k in range(5):
        assert np.array_equal(lanes[31 - (1 << k)], tables(tree[k + 2]))
    rng = np.random.default_rng(3)
    for lane in range(32):
        v = int(rng.integers(0, 1 << 32))
        got = 0
        for j in range(4):
            got ^= int(lanes[lane, j, (v >> (8 * j)) & 255])
        assert got == jc.crc_shift_register(v, 16 * (31 - lane))


def test_host_combines_equal_reference():
    rng = np.random.default_rng(5)
    for _ in range(20):
        a, b = _data(int(rng.integers(0, 3000))), _data(int(rng.integers(0, 3000)))
        ca, cb = zlib.crc32(a), zlib.crc32(b)
        aa, ab = zlib.adler32(a), zlib.adler32(b)
        assert tc.crc32_combine(ca, cb, len(b)) == zlib.crc32(a + b)
        assert tc.crc32_combine(ca, cb, len(b)) == jc.crc32_combine(ca, cb, len(b))
        assert tc.adler32_combine(aa, ab, len(b)) == zlib.adler32(a + b)
        reg = int(rng.integers(0, 1 << 32))
        nb = int(rng.integers(0, 1 << 20))
        assert tc.crc_shift_register(reg, nb) == jc.crc_shift_register(reg, nb)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(ZippyError):
        tc.crc32_device(b"abc")
    with pytest.raises(ZippyError):
        tc.adler32_device(b"abc")


def test_wrappers_check_their_input():
    with pytest.raises(ZippyError):
        ck.adler_chunks(torch.zeros(2, 512, dtype=torch.uint8))
    with pytest.raises(ZippyError):
        ck.crc_rows(torch.zeros(2, 512, dtype=torch.int32))
    with pytest.raises(ZippyError):
        tc.crc32_device(torch.zeros(4, 4, dtype=torch.uint8))
    rows = torch.zeros(2, 512, dtype=torch.uint8)
    with pytest.raises(ZippyError):
        ck.crc_rows(rows, torch.zeros(512, dtype=torch.uint8))
    with pytest.raises(ZippyError):
        ck.crc_combine(torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ZippyError):
        ck.crc_combine(torch.zeros(3, dtype=torch.int32), 513)


def test_cuda_libraries_are_keyed_by_their_headers(tmp_path, monkeypatch):
    """A .cu library's name changes with the shared header it includes, so
    an edit to csrc/device_scope.cuh rebuilds both CUDA libraries; the
    host scan's name does not depend on it. Builds nothing."""
    from zippy_tpu_torch.ops import kernel_build as kb

    for name in kb.CUDA_SOURCES + kb.HOST_SOURCES + kb.CUDA_HEADERS:
        text = (kb.CSRC / name).read_text()
        if name.endswith(".cu"):
            assert '#include "device_scope.cuh"' in text
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(kb, "CSRC", tmp_path)
    before = {name: kb.library_path(name)
              for name in kb.CUDA_SOURCES + kb.HOST_SOURCES}
    (tmp_path / "device_scope.cuh").write_text("// edited\n")
    after = {name: kb.library_path(name) for name in before}
    for name in kb.CUDA_SOURCES:
        assert after[name] != before[name]
    for name in kb.HOST_SOURCES:
        assert after[name] == before[name]
